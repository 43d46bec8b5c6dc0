"""Seeded speech-like signals and PCM16 WAV files.

``speech_like`` is a copy of ``chip_smoke.py``'s: a voiced tone under a
syllable-rate envelope plus white noise."""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SR = 16000
THREADS = 8


def speech_like(rng: np.random.Generator, n: int, noise) -> np.ndarray:
    """A voiced tone under a syllable-rate envelope plus white noise of
    amplitude ``noise`` (a float, or a (low, high) range to draw it from)."""
    t = np.arange(n, dtype=np.float32) / SR
    f0 = rng.uniform(90, 250)
    env = np.clip(np.sin(np.float32(2 * np.pi * rng.uniform(0.5, 2)) * t), 0, 1)
    x = np.float32(0.2) * np.sin(np.float32(2 * np.pi * f0) * t) * env
    amp = noise if isinstance(noise, float) else rng.uniform(*noise)
    x += np.float32(amp) * rng.standard_normal(n, dtype=np.float32)
    return x


def pcm16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x * 32768.0), -32768, 32767).astype("<i2")


def write_pcm16(path: str, samples: np.ndarray) -> None:
    """A mono 16 kHz PCM16 WAV of int16 samples."""
    data = samples.astype("<i2").tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE" + b"fmt "
           + struct.pack("<IHHIIHH", 16, 1, 1, SR, 2 * SR, 2, 16)
           + b"data" + struct.pack("<I", len(data)))
    with open(path, "wb") as f:
        f.write(hdr + data)


def sizes(sizes_seed: int, count: int, seconds) -> np.ndarray:
    """``count`` lengths in samples, uniform in ``seconds``, from the mix's
    own seed."""
    return (np.random.default_rng(sizes_seed).uniform(*seconds, size=count) * SR).astype(int)


def write_many(jobs: list) -> None:
    """jobs: (path, samples, seed, noise) -> speech-like files, in threads."""

    def one(job):
        path, n, seed, noise = job
        write_pcm16(path, pcm16(speech_like(np.random.default_rng(seed), n, noise)))

    with ThreadPoolExecutor(THREADS) as ex:
        list(ex.map(one, jobs))
