"""Audio ingest: decode, mono-fold, resample, trim (host side, numpy).

The counterpart of ``nomad_tpu.io``: ``load_processing`` averages channels
0 and 1 of a multichannel file (quirk Q4: channels beyond the second are
dropped), resamples to 16 kHz with the torchaudio-default sinc filter and
optionally trims to 10 s. WAV and FLAC (by magic); any other file raises
``UnsupportedAudioError``. ``io.native`` binds the C++ twin of this path
(``native/``), which the scoring engine takes when it builds.
"""

from __future__ import annotations

import numpy as np

from .flac import FlacFormatError, read_flac
from .resample import resample, sinc_resample_kernel
from .wav import WavFormatError, read_wav, read_wav_int16_mono, write_wav

TARGET_SR = 16000


class UnsupportedAudioError(ValueError):
    pass


def read_audio(filepath: str) -> tuple[np.ndarray, int]:
    """Decode a WAV or FLAC file (by magic) -> (float32 [channels, samples], sr)."""
    with open(filepath, "rb") as f:
        head = f.read(4)
    if head == b"fLaC":
        return read_flac(filepath)
    try:
        return read_wav(filepath)
    except WavFormatError as e:
        raise UnsupportedAudioError(f"{filepath}: {e}") from e


def load_processing(
    filepath: str,
    target_sr: int = TARGET_SR,
    trim: bool = False,
) -> np.ndarray:
    """Load a WAV or FLAC file -> float32 [1, samples] at ``target_sr``."""
    wave, sr = read_audio(filepath)
    if wave.shape[0] > 1:
        wave = ((wave[0, :] + wave[1, :]) / 2.0)[None, :]
    if sr != target_sr:
        wave = resample(wave, sr, target_sr)
        sr = target_sr
    if trim and wave.shape[1] > sr * 10:
        wave = wave[:, : sr * 10]
    return np.ascontiguousarray(wave, dtype=np.float32)


def load_for_scoring(filepath: str, target_sr: int = TARGET_SR, trim: bool = False):
    """Like :func:`load_processing` but returns raw int16 [samples] for mono
    PCM16 files already at target_sr (exact; halves the host-to-device
    bytes); float32 [samples] otherwise."""
    try:
        fast = read_wav_int16_mono(filepath)
    except (OSError, WavFormatError):
        fast = None
    if fast is not None and fast[1] == target_sr:
        x = fast[0]
        if trim and x.shape[0] > target_sr * 10:
            x = x[: target_sr * 10]
        return x
    return load_processing(filepath, target_sr=target_sr, trim=trim)[0]


__all__ = [
    "FlacFormatError",
    "TARGET_SR",
    "UnsupportedAudioError",
    "load_for_scoring",
    "load_processing",
    "read_audio",
    "read_flac",
    "read_wav",
    "read_wav_int16_mono",
    "resample",
    "sinc_resample_kernel",
    "write_wav",
]
