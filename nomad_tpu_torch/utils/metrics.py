"""Evaluation metrics: SRCC/PCC and the 3rd-order polynomial MOS mapping
(counterpart of ``nomad_tpu.utils.metrics``), on numpy/scipy. scipy loads
at the first call, not with the trainer (a data-parallel rank that never
evaluates does not pay its import)."""

from __future__ import annotations

import numpy as np


def order_three(x, a, b, c, d):
    return a * x + b * x**2 + c * x**3 + d


def fit_order_three(distance, mos):
    """Fit Distance -> MOS and return the mapping. With fewer than 4 points
    the cubic is underdetermined, and where curve_fit fails, the mapping is
    the identity, so an eval still reports its raw correlations."""
    distance = np.asarray(distance, dtype=np.float64)
    mos = np.asarray(mos, dtype=np.float64)
    if distance.size < 4:
        return lambda x: np.asarray(x)
    from scipy.optimize import curve_fit

    try:
        popt, _ = curve_fit(order_three, distance, mos)
    except (RuntimeError, TypeError, ValueError):
        return lambda x: np.asarray(x)
    a, b, c, d = popt
    return lambda x: order_three(np.asarray(x), a, b, c, d)


def srcc(x, y) -> float:
    from scipy.stats import spearmanr

    r, _ = spearmanr(x, y)
    return float(r)


def pcc(x, y) -> float:
    from scipy.stats import pearsonr

    r, _ = pearsonr(x, y)
    return float(r)


def correlation_report(distance, mos) -> dict:
    """SRCC/PCC, raw and after the 3rd-order mapping, as the reference
    prints them."""
    mapped = fit_order_three(distance, mos)(distance)
    return {
        "SRCC": srcc(distance, mos),
        "SRCC_map": srcc(mapped, mos),
        "PCC": pcc(distance, mos),
        "PCC_map": pcc(mapped, mos),
    }
