"""A PCM WAV reader: RIFF chunks, 16-bit integer samples, mono or the
mean of the first two channels, as float32 in [-1, 1) (sample / 32768)."""

import struct

import numpy as np


def read_pcm16(path: str) -> tuple[np.ndarray, int]:
    """(float32 [samples], sample rate) of a 16-bit PCM WAV file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos, fmt, pcm = 12, None, None
    while pos + 8 <= len(data):
        cid, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            pcm = body
        pos += 8 + size + (size & 1)
    if fmt is None or pcm is None:
        raise ValueError(f"{path}: no fmt or data chunk")
    tag, channels, rate, _, _, bits = fmt
    if tag != 1 or bits != 16:
        raise ValueError(f"{path}: format {tag}, {bits} bits; only 16-bit PCM is read")
    x = np.frombuffer(pcm[: len(pcm) // (2 * channels) * 2 * channels], "<i2")
    x = x.reshape(-1, channels).astype(np.float32) / 32768.0
    return (x[:, 0] if channels == 1 else 0.5 * (x[:, 0] + x[:, 1])), rate
