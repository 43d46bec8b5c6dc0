"""Synthetic speech-like waveforms (a copy of ``nomad_tpu.utils.synth``).

An enveloped harmonic stack over a low noise floor: the payload class
every "speech-like" measurement of the repository uses, so that payloads
compare across the two packages.
"""

from __future__ import annotations

import numpy as np


def speech_like(
    n: int, seconds: float, sr: int = 16000, seed: int = 5,
    dtype=np.int16,
) -> list:
    """n enveloped-harmonic-stack waveforms (`[n]` list of 1-D arrays).

    dtype=np.int16 returns PCM16-grid integers (the engine's halved-
    transfer fast path, like real decoded files); np.float32 returns
    [-1, 1] floats for paths that write wavs or feed models directly.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    out = []
    for _ in range(n):
        f0 = 90.0 + 60.0 * rng.random()
        env = np.clip(np.sin(2 * np.pi * (0.6 + 0.8 * rng.random()) * t), 0, 1)
        x = env * (
            0.12 * np.sin(2 * np.pi * f0 * t)
            + 0.05 * np.sin(2 * np.pi * 2.0 * f0 * t + 1.3)
            + 0.02 * np.sin(2 * np.pi * 3.1 * f0 * t + 0.4)
        ) + 0.004 * rng.standard_normal(t.shape)
        x = np.clip(x, -0.99, 0.99)
        if dtype == np.int16:
            out.append(np.round(x * 32768.0).astype(np.int16))
        else:
            out.append(x.astype(dtype))
    return out
