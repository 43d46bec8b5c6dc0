"""RIFF/WAVE decode + encode in pure numpy.

A copy of ``nomad_tpu.io.wav`` (the port imports nothing of the JAX
package). Decoding follows torchaudio.load's contract: float32 in [-1, 1]
with shape [channels, samples] (int16 / 2**15, int24 / 2**23,
int32 / 2**31, uint8 -> (x-128)/128, float passthrough). Supports PCM
8/16/24/32-bit, IEEE float32/64, and WAVE_FORMAT_EXTENSIBLE wrappers of
both. The tests hold it to the original bit for bit.
"""

from __future__ import annotations

import struct

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavFormatError(ValueError):
    pass


def _iter_chunks(buf: bytes):
    """Yield (chunk_id, offset, size) for every top-level RIFF chunk."""
    if len(buf) < 12 or buf[0:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise WavFormatError("not a RIFF/WAVE file")
    pos = 12
    n = len(buf)
    while pos + 8 <= n:
        cid = buf[pos : pos + 4]
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        data_off = pos + 8
        yield cid, data_off, min(size, n - data_off)
        pos = data_off + size + (size & 1)  # chunks are word-aligned


def read_wav_bytes(buf: bytes) -> tuple[np.ndarray, int]:
    """Decode a WAV byte buffer -> (float32 [channels, samples], sample_rate)."""
    fmt = None
    data_off = data_size = None
    for cid, off, size in _iter_chunks(buf):
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", buf, off)
            if fmt[0] == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                # SubFormat GUID's first two bytes carry the real format tag.
                (sub_tag,) = struct.unpack_from("<H", buf, off + 24)
                fmt = (sub_tag,) + fmt[1:]
        elif cid == b"data":
            data_off, data_size = off, size
    if fmt is None:
        raise WavFormatError("missing fmt chunk")
    if data_off is None:
        raise WavFormatError("missing data chunk")

    format_tag, num_channels, sample_rate, _brate, block_align, bits = fmt
    if num_channels < 1:
        raise WavFormatError("zero channels")

    raw = buf[data_off : data_off + data_size]
    if format_tag == WAVE_FORMAT_PCM:
        if bits == 8:
            x = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
            x = (x - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw[: len(raw) - len(raw) % 3], dtype=np.uint8)
            b = b.reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32)
            x = x / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(1 << 31)
        else:
            raise WavFormatError(f"unsupported PCM bit depth {bits}")
    elif format_tag == WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise WavFormatError(f"unsupported float bit depth {bits}")
    else:
        raise WavFormatError(f"unsupported format tag 0x{format_tag:04x}")

    n_frames = x.shape[0] // num_channels
    x = x[: n_frames * num_channels].reshape(n_frames, num_channels)
    return np.ascontiguousarray(x.T), int(sample_rate)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Load a WAV file -> (float32 [channels, samples], sample_rate)."""
    with open(path, "rb") as f:
        return read_wav_bytes(f.read())


def read_wav_int16_mono(path: str):
    """Fast path: mono 16-bit PCM -> raw int16 samples (no float convert;
    int16/32768 dequantizes to exactly the read_wav float). Returns
    (int16 [samples], sample_rate) or None when the file is not mono PCM16
    (caller falls back to read_wav)."""
    with open(path, "rb") as f:
        buf = f.read()
    fmt = None
    data_off = data_size = None
    for cid, off, size in _iter_chunks(buf):
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", buf, off)
            if fmt[0] == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                (sub_tag,) = struct.unpack_from("<H", buf, off + 24)
                fmt = (sub_tag,) + fmt[1:]
        elif cid == b"data":
            data_off, data_size = off, size
    if fmt is None or data_off is None:
        raise WavFormatError("missing fmt/data chunk")
    format_tag, num_channels, sample_rate, _br, _ba, bits = fmt
    if format_tag != WAVE_FORMAT_PCM or bits != 16 or num_channels != 1:
        return None
    x = np.frombuffer(buf[data_off : data_off + data_size], dtype="<i2")
    return np.ascontiguousarray(x), int(sample_rate)


def write_wav(path: str, wave: np.ndarray, sample_rate: int, bits: int = 16) -> None:
    """Write float32 [channels, samples] (or [samples]) as PCM WAV."""
    wave = np.asarray(wave)
    if wave.ndim == 1:
        wave = wave[None, :]
    ch, n = wave.shape
    interleaved = np.ascontiguousarray(wave.T)
    if bits == 16:
        pcm = np.clip(np.round(interleaved * 32768.0), -32768, 32767).astype("<i2")
    elif bits == 32:
        pcm = np.clip(
            np.round(interleaved.astype(np.float64) * float(1 << 31)),
            -(1 << 31),
            (1 << 31) - 1,
        ).astype("<i4")
    else:
        raise WavFormatError(f"unsupported write bit depth {bits}")
    data = pcm.tobytes()
    block_align = ch * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, WAVE_FORMAT_PCM, ch, sample_rate, sample_rate * block_align, block_align, bits
    )
    hdr += b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as f:
        f.write(hdr + data)
