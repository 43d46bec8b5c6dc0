"""Polyphase sinc resampler with torchaudio-default semantics (numpy).

A copy of ``nomad_tpu.io.resample`` without the JAX path: the port keeps
its own host code because importing any ``nomad_tpu`` module imports JAX.
The math is torchaudio's ``Resample`` default (``lowpass_filter_width=6,
rolloff=0.99``, hann-windowed sinc): a bank of ``new_freq`` polyphase
kernels applied with stride ``orig_freq`` after (width, width + orig_freq)
zero padding, then truncated to ceil(new * len / orig) samples. The tests
hold it to the original bit for bit.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=64)
def sinc_resample_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
    dtype=np.float64,
) -> tuple[np.ndarray, int, int, int]:
    """Build the polyphase kernel bank.

    Returns (kernels [new_g, kernel_len], width, orig_g, new_g) where
    orig_g/new_g are the gcd-reduced rates.
    """
    if orig_freq <= 0 or new_freq <= 0:
        raise ValueError("sample rates must be positive")
    g = math.gcd(int(orig_freq), int(new_freq))
    orig_g = int(orig_freq) // g
    new_g = int(new_freq) // g

    base_freq = min(orig_g, new_g) * rolloff
    width = math.ceil(lowpass_filter_width * orig_g / base_freq)

    idx = np.arange(-width, width + orig_g, dtype=dtype)[None, :] / orig_g
    t = np.arange(0, -new_g, -1, dtype=dtype)[:, None] / new_g + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2
    t = t * math.pi
    scale = base_freq / orig_g
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels = kernels * window * scale
    return kernels.astype(np.float32), width, orig_g, new_g


def resample(
    wave: np.ndarray,
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> np.ndarray:
    """Resample [..., samples] float32 along the last axis (numpy)."""
    if int(orig_freq) == int(new_freq):
        return np.asarray(wave, dtype=np.float32)
    kernels, width, orig_g, new_g = sinc_resample_kernel(
        int(orig_freq), int(new_freq), lowpass_filter_width, rolloff
    )
    wave = np.asarray(wave, dtype=np.float32)
    shape = wave.shape
    length = shape[-1]
    flat = wave.reshape(-1, length)
    padded = np.pad(flat, ((0, 0), (width, width + orig_g)))

    klen = kernels.shape[1]
    n_steps = (padded.shape[1] - klen) // orig_g + 1
    # Strided frame view [n_wav, n_steps, klen]; einsum against the kernel
    # bank gives all phases at once.
    s0, s1 = padded.strides
    frames = np.lib.stride_tricks.as_strided(
        padded,
        shape=(flat.shape[0], n_steps, klen),
        strides=(s0, s1 * orig_g, s1),
        writeable=False,
    )
    out = np.einsum("wsk,pk->wsp", frames, kernels, optimize=True)
    out = out.reshape(flat.shape[0], -1)
    target_length = int(math.ceil(new_g * length / orig_g))
    out = out[:, :target_length]
    return np.ascontiguousarray(out.reshape(shape[:-1] + (target_length,)), dtype=np.float32)

