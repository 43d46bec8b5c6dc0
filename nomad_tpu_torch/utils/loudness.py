"""EBU R128 / ITU-R BS.1770-4 loudness measurement and two-pass
normalization, pure numpy/scipy (counterpart of ``nomad_tpu.utils.loudness``,
the same functions and arithmetic).

The reference pipeline shells out to ``ffmpeg-normalize`` after every
degraded file it writes (``audio_degrader_training.py:70``,
``audio_degrader_test.py:83`` of the reference code) — an EBU R128
two-pass (measure, then apply) normalize to I=-23 LUFS, TP=-2 dBTP, LRA=7.
This module provides the same measure+apply recipe natively, so dataset
generation works where ffmpeg is absent.

Implementation follows BS.1770-4:
  * K-weighting: stage-1 high-shelf (+~4 dB above ~1.5 kHz) + stage-2
    high-pass (~38 Hz), biquads designed parametrically for any sample rate
    (the spec tabulates 48 kHz coefficients; the parametric form reproduces
    them to ~1e-6).
  * Integrated loudness: mean-square over 400 ms blocks, 75% overlap,
    -0.691 dB offset, absolute gate at -70 LUFS then relative gate at
    -10 LU below the absolutely-gated mean.
  * True peak: 4x polyphase oversampling (2x for >= 96 kHz), dBTP.
"""

from __future__ import annotations

import math

import numpy as np

# BS.1770 stage-1 shelf / stage-2 high-pass design constants (the exact
# center frequencies / Q / gain that regenerate the spec's 48 kHz tables).
_SHELF_G_DB = 3.999843853973347
_SHELF_Q = 0.7071752369554196
_SHELF_FC = 1681.974450955533
_HP_Q = 0.5003270373238773
_HP_FC = 38.13547087602444

ABS_GATE_LUFS = -70.0
REL_GATE_LU = -10.0
BLOCK_SEC = 0.400
OVERLAP = 0.75


def _k_weighting_coeffs(fs: float):
    """(b1, a1, b2, a2): stage-1 shelf and stage-2 high-pass biquads."""
    # high shelf
    K = math.tan(math.pi * _SHELF_FC / fs)
    Vh = 10.0 ** (_SHELF_G_DB / 20.0)
    Vb = Vh**0.4996667741545416
    a0 = 1.0 + K / _SHELF_Q + K * K
    b1 = np.array(
        [
            (Vh + Vb * K / _SHELF_Q + K * K) / a0,
            2.0 * (K * K - Vh) / a0,
            (Vh - Vb * K / _SHELF_Q + K * K) / a0,
        ]
    )
    a1 = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / _SHELF_Q + K * K) / a0])
    # high pass
    K = math.tan(math.pi * _HP_FC / fs)
    a0 = 1.0 + K / _HP_Q + K * K
    b2 = np.array([1.0, -2.0, 1.0])
    a2 = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / _HP_Q + K * K) / a0])
    return b1, a1, b2, a2


def k_weight(x: np.ndarray, fs: float) -> np.ndarray:
    """Apply the two-stage K-weighting filter to a [C, T] or [T] signal."""
    from scipy.signal import lfilter

    b1, a1, b2, a2 = _k_weighting_coeffs(fs)
    y = lfilter(b1, a1, x.astype(np.float64), axis=-1)
    return lfilter(b2, a2, y, axis=-1)


def integrated_loudness(x: np.ndarray, fs: float) -> float:
    """Gated integrated loudness (LUFS) of a [T] mono or [C, T] signal.

    Returns -inf for silence / all-gated input.
    """
    x = np.atleast_2d(np.asarray(x, np.float64))  # [C, T]
    y = k_weight(x, fs)
    block = int(round(BLOCK_SEC * fs))
    hop = int(round(block * (1.0 - OVERLAP)))
    if y.shape[-1] < block:
        # short signal: single (partial) block, as loudnorm effectively does
        ms = np.mean(y**2, axis=-1)
    else:
        n_blocks = 1 + (y.shape[-1] - block) // hop
        idx = np.arange(block)[None, :] + hop * np.arange(n_blocks)[:, None]
        # [C, n_blocks] per-channel block mean squares
        ms = np.stack([np.mean(y[c][idx] ** 2, axis=-1) for c in range(y.shape[0])])
    # channel weights: 1.0 for L/R/C (surround weights omitted — degradation
    # pipeline audio is mono/stereo)
    z = np.sum(ms, axis=0)  # [n_blocks] (or scalar)
    z = np.atleast_1d(z)
    with np.errstate(divide="ignore"):
        lk = -0.691 + 10.0 * np.log10(z)
    keep = lk > ABS_GATE_LUFS
    if not np.any(keep):
        return float("-inf")
    rel_thresh = -0.691 + 10.0 * np.log10(np.mean(z[keep])) + REL_GATE_LU
    keep &= lk > rel_thresh
    if not np.any(keep):
        return float("-inf")
    return float(-0.691 + 10.0 * np.log10(np.mean(z[keep])))


def true_peak_db(x: np.ndarray, fs: float) -> float:
    """True peak (dBTP) via 4x polyphase oversampling (2x at >= 96 kHz)."""
    from scipy.signal import resample_poly

    x = np.atleast_2d(np.asarray(x, np.float64))
    up = 2 if fs >= 96000 else 4
    peak = 0.0
    for c in range(x.shape[0]):
        peak = max(peak, float(np.max(np.abs(resample_poly(x[c], up, 1)))))
    if peak <= 0.0:
        return float("-inf")
    return 20.0 * math.log10(peak)


def normalize_loudness(
    x: np.ndarray,
    fs: float,
    target_i: float = -23.0,
    target_tp: float = -2.0,
    dynamic: str = "auto",
):
    """Two-pass EBU normalization: measure I and TP, then apply gain.

    Mirrors ffmpeg-normalize: linear mode applies ONE gain
    (target_i - measured_i); when that gain would push the true peak past
    ``target_tp``, ffmpeg-normalize falls back to ffmpeg's DYNAMIC
    loudnorm filter (`audio_degrader_training.py:70-71` inherits this).
    ``dynamic``:
      * 'auto'  (default, ffmpeg-normalize behavior) — linear unless the
        true-peak ceiling binds, then time-varying gain via
        :func:`normalize_loudness_dynamic`;
      * 'never' — linear only, gain capped at the TP ceiling;
      * 'always' — force the dynamic path.

    Returns (normalized, info dict).
    """
    x = np.asarray(x)
    i_in = integrated_loudness(x, fs)
    tp_in = true_peak_db(x, fs)
    if not math.isfinite(i_in):
        return x, {"input_i": i_in, "input_tp": tp_in, "gain_db": 0.0,
                   "mode": "linear"}
    gain = target_i - i_in
    needs_dynamic = math.isfinite(tp_in) and tp_in + gain > target_tp
    if dynamic == "always" or (dynamic == "auto" and needs_dynamic):
        y, info = normalize_loudness_dynamic(x, fs, target_i, target_tp)
        info.update({"input_i": i_in, "input_tp": tp_in, "mode": "dynamic"})
        return y, info
    capped = False
    if needs_dynamic:  # dynamic == 'never': cap instead
        gain = target_tp - tp_in
        capped = True
    y = (x.astype(np.float64) * 10.0 ** (gain / 20.0)).astype(np.float32)
    return y, {
        "input_i": i_in,
        "input_tp": tp_in,
        "gain_db": gain,
        "tp_capped": capped,
        "mode": "linear",
    }


def normalize_loudness_dynamic(
    x: np.ndarray,
    fs: float,
    target_i: float = -23.0,
    target_tp: float = -2.0,
    block_sec: float = BLOCK_SEC,
    hop_sec: float = 0.100,
    smooth_blocks: int = 15,
    max_gain_db: float = 30.0,
):
    """Time-varying loudness normalization — the native stand-in for
    ffmpeg's dynamic ``loudnorm`` filter (what ffmpeg-normalize falls back
    to when a single linear gain would clip).

    Like the ffmpeg filter it works on momentary loudness: per 400 ms
    block (100 ms hop) the gain steering toward ``target_i`` is computed,
    smoothed over ~1.5 s so speech envelopes are not pumped, interpolated
    to per-sample gains, applied, and finally run through a true-peak
    limiter that scales any residual overshoot of ``target_tp`` locally.
    Not bit-compatible with ffmpeg's implementation (documented in
    PARITY.md) but matches its contract: integrated loudness lands near
    the target while the true peak stays under the ceiling, on material
    where the linear mode cannot do both."""
    x1 = np.asarray(x, np.float64)
    mono = x1 if x1.ndim == 1 else np.mean(x1, axis=0)
    block = max(1, int(round(block_sec * fs)))
    hop = max(1, int(round(hop_sec * fs)))
    if len(mono) < block:
        lin, info = normalize_loudness(x, fs, target_i, target_tp,
                                       dynamic="never")
        return lin, dict(info, short_input=True)

    yk = k_weight(mono, fs)
    n_blocks = 1 + (len(yk) - block) // hop
    idx = np.arange(block)[None, :] + hop * np.arange(n_blocks)[:, None]
    with np.errstate(divide="ignore"):
        lk = -0.691 + 10.0 * np.log10(np.mean(yk[idx] ** 2, axis=-1))
    # per-block steering gain; silent blocks (below the absolute gate)
    # reuse the neighboring gain rather than being boosted toward -23
    gains = np.where(lk > ABS_GATE_LUFS, target_i - lk, np.nan)
    if np.all(np.isnan(gains)):
        return x.astype(np.float32), {"gain_db": 0.0, "limited": False}
    # forward/backward fill the silent gaps
    valid = np.flatnonzero(~np.isnan(gains))
    gains = np.interp(np.arange(n_blocks), valid, gains[valid])
    gains = np.clip(gains, -max_gain_db, max_gain_db)
    # smooth (moving average over ~smooth_blocks * hop seconds)
    k = max(1, int(smooth_blocks) | 1)
    pad = k // 2
    sm = np.convolve(np.pad(gains, pad, mode="edge"),
                     np.ones(k) / k, mode="valid")
    # per-sample gain track (block centers -> samples)
    centers = hop * np.arange(n_blocks) + block // 2
    g_db = np.interp(np.arange(len(mono)), centers, sm)
    g = 10.0 ** (g_db / 20.0)
    y = x1 * g if x1.ndim == 1 else x1 * g[None, :]

    # measure -> residual-trim -> limit, iterated: the limiter removes
    # energy the steering counted (e.g. transients crushed to the
    # ceiling), so a single correction undershoots on peaky material;
    # 2-3 rounds converge wherever the ceiling leaves headroom for the
    # program body (the same converge-under-ceiling contract ffmpeg's
    # dynamic loudnorm provides)
    ceil_lin = 10.0 ** (target_tp / 20.0)
    limited_any = False
    out_i = integrated_loudness(y, fs)
    for _ in range(3):
        if math.isfinite(out_i) and abs(out_i - target_i) > 0.25:
            y = y * 10.0 ** ((target_i - out_i) / 20.0)
        y, limited = _true_peak_limit(y, fs, ceil_lin)
        limited_any |= limited
        out_i = integrated_loudness(y, fs)
        if not limited or abs(out_i - target_i) <= 0.25:
            break
    return y.astype(np.float32), {
        "gain_db": float(np.mean(sm)),
        "output_i": out_i,
        "limited": limited_any,
    }


def _true_peak_limit(y: np.ndarray, fs: float, ceil_lin: float):
    """True-peak limiter: per-sample gain envelope = required attenuation
    (ceiling / oversampled local peak), MIN-filtered over a 5 ms radius
    then moving-average smoothed over the SAME radius. With equal radii
    the smoothed envelope is provably <= the raw requirement everywhere
    (each averaged min covers the sample), so the ceiling holds without
    zipper noise."""
    from scipy.ndimage import minimum_filter1d, uniform_filter1d
    from scipy.signal import resample_poly

    peak_y = np.abs(y) if y.ndim == 1 else np.max(np.abs(y), axis=0)
    n = peak_y.shape[-1]
    up = 2 if fs >= 96000 else 4
    over = np.abs(resample_poly(peak_y, up, 1))
    over = over[: n * up]
    if len(over) < n * up:
        over = np.pad(over, (0, n * up - len(over)))
    req = np.minimum(1.0, ceil_lin / np.maximum(
        over.reshape(n, up).max(axis=1), 1e-12
    ))
    limited = bool(np.any(req < 1.0))
    if limited:
        radius = max(1, int(0.005 * fs))
        g_lim = uniform_filter1d(
            minimum_filter1d(req, 2 * radius + 1), 2 * radius + 1
        )
        y = y * g_lim if y.ndim == 1 else y * g_lim[None, :]
    return y, limited
