"""Offline audio degradations for dataset generation (counterpart of
``nomad_tpu.utils.degradations``, the same functions and arithmetic;
the reference code's ``src/utils/degradations.py``). Host-side, not on the
card's path.

  * ``noise``/``clip_signal``: numpy, as the reference (:30-83):
    SNR-scaled additive noise with tiling; percentile clipping.
  * ``mp3``/``opus``/``vorbis``: ffmpeg codec round trips (:8-28, :86-95),
    run only where ``have_ffmpeg()`` finds ffmpeg; they raise otherwise.
  * ``reverb``: the reference runs sox through torchaudio (:97-100); this
    is a freeverb (the algorithm of sox's reverb effect) in numpy/scipy,
    parameterized by the same reverberance percentage.
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess

import numpy as np

from ..io import read_wav, write_wav


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def _ffmpeg(args: list[str]):
    if not have_ffmpeg():
        raise RuntimeError(
            "ffmpeg binary not available; codec degradations are disabled "
            "in this environment"
        )
    subprocess.call(["ffmpeg", "-y", *args], stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL)


def mp3(in_filepath, out_filepath, bitrate="320k", sr=16000):
    tmp = os.path.splitext(out_filepath)[0] + ".mp3"
    _ffmpeg(["-i", in_filepath, "-ar", str(sr), "-b:a", bitrate, tmp])
    _ffmpeg(["-i", tmp, "-ar", str(sr), out_filepath])
    os.remove(tmp)


def opus(in_filepath, out_filepath, bitrate="320k", sr=16000):
    tmp = os.path.splitext(out_filepath)[0] + ".opus"
    _ffmpeg(["-i", in_filepath, "-c:a", "libopus", "-b:a", bitrate, "-vbr", "on", tmp])
    _ffmpeg(["-i", tmp, "-ar", str(sr), out_filepath])
    os.remove(tmp)


def vorbis(in_filepath, out_filepath, quality="3", sr=16000):
    tmp = os.path.splitext(out_filepath)[0] + ".ogg"
    _ffmpeg(["-i", in_filepath, "-c:a", "libvorbis", "-qscale:a", str(quality), tmp])
    _ffmpeg(["-i", tmp, "-ar", str(sr), out_filepath])
    os.remove(tmp)


def noise(clean_path, noise_path, out_filepath, snr_db=0, sr=16000):
    """Additive noise at a target SNR (reference `degradations.py:30-68`):
    tile noise to length, match powers, scale, add."""
    x, sr_x = read_wav(clean_path)
    s, _ = read_wav(noise_path)
    x = x[0]
    s = s[0]

    x_len = x.shape[0]
    if x_len > s.shape[0]:
        s = np.tile(s, math.ceil(x_len / s.shape[0]))
    s = s[:x_len]
    assert x_len == s.shape[0]

    snr = 10 ** (snr_db / 10)
    sp = np.sqrt(np.mean(s**2))
    xp = np.sqrt(np.mean(x**2))
    alpha = (xp / snr) / sp
    y = x + alpha * s
    write_wav(out_filepath, y[None], sr_x if sr is None else sr)
    return y


def clip_signal(in_filepath, out_filepath, clip_factor=10, sr=16000):
    """Percentile clipping (reference `degradations.py:70-83`)."""
    x, sr_x = read_wav(in_filepath)
    x = x[0].copy()
    lower = clip_factor / 2
    higher = 100 - lower
    lo, hi = np.percentile(x, [lower, higher])
    x[x > hi] = hi
    x[x < lo] = lo
    write_wav(out_filepath, x[None], sr_x)
    return x


# ---------------------------------------------------------------------------
# freeverb-style reverb (native replacement for the sox 'reverb' effect the
# reference applies through torchaudio.sox_effects at degradations.py:97-100)
# ---------------------------------------------------------------------------

_COMB_TUNINGS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
_ALLPASS_TUNINGS = (556, 441, 341, 225)
_STEREO_SPREAD = 23


def _comb_filter(x, delay, feedback, damp):
    """Freeverb lowpass-feedback comb, vectorized in blocks of D samples.

    Sample recursion (write w, damped store s, tap y):
        y[i] = w[i-D]
        s[i] = (1-damp)*y[i] + damp*s[i-1]
        w[i] = x[i] + feedback*s[i]
    Within a block of D samples every delayed tap w[i-D] is already known,
    so the only true recursion left is the one-pole store smoother — run as
    an order-1 lfilter with carried state. O(N) instead of the O(N*D) a
    dense IIR of order D would cost.
    """
    from scipy.signal import lfilter

    n = len(x)
    D = int(delay)
    xf = x.astype(np.float64)
    w = np.zeros(n + D)  # w[i] at array index D+i; first D entries = buffer
    zi = np.zeros(1)
    for start in range(0, n, D):
        end = min(start + D, n)
        y_blk = w[start:end]  # w[i-D]
        s_blk, zi = lfilter([1.0 - damp], [1.0, -damp], y_blk, zi=zi)
        w[D + start : D + end] = xf[start:end] + feedback * s_blk
    return w[:n].astype(x.dtype)


def _allpass_filter(x, delay):
    """Freeverb allpass (g=0.5):
        w[i] = x[i] + 0.5*w[i-D];  y[i] = -x[i] + w[i-D]
    Block form: within D samples all delayed taps are known, so each block
    is a single vector op."""
    n = len(x)
    D = int(delay)
    xf = x.astype(np.float64)
    w = np.zeros(n + D)
    for start in range(0, n, D):
        end = min(start + D, n)
        w[D + start : D + end] = xf[start:end] + 0.5 * w[start:end]
    return (w[:n] - xf).astype(x.dtype)


def _freeverb_mono(x, reverberance, hf_damping, room_scale, wet_gain, sr, offset=0):
    scale = sr / 44100.0
    # freeverb roomsize: reverberance% maps to feedback in [0.7, 0.98]
    feedback = 0.7 + 0.28 * (reverberance / 100.0)
    damp = hf_damping / 100.0 * 0.4
    room = room_scale / 100.0
    wet = np.zeros_like(x)
    for t in _COMB_TUNINGS:
        d = max(1, int(round((t * room + offset) * scale)))
        wet += _comb_filter(x, d, feedback, damp)
    wet /= len(_COMB_TUNINGS)
    for t in _ALLPASS_TUNINGS:
        d = max(1, int(round((t + offset) * scale)))
        wet = _allpass_filter(wet, d)
    return wet * (10 ** (wet_gain / 20.0))


def reverb(in_filepath, out_filepath, p=50, sr=16000):
    """Apply freeverb with reverberance p%% and fold the stereo wet pair to
    mono, mirroring the reference's `(L+R)/2` after sox reverb
    (`degradations.py:97-100`)."""
    x, sr_x = read_wav(in_filepath)
    x = x[0].astype(np.float32)
    wet_l = _freeverb_mono(x, p, 50.0, 100.0, 0.0, sr_x, offset=0)
    wet_r = _freeverb_mono(x, p, 50.0, 100.0, 0.0, sr_x, offset=_STEREO_SPREAD)
    y_l = x + wet_l
    y_r = x + wet_r
    d = (y_l + y_r) / 2.0
    peak = np.max(np.abs(d))
    if peak > 1.0:
        d = d / peak
    write_wav(out_filepath, d[None], sr_x)
    return d
