"""NSIM-guided triplet sampling (counterpart of
``nomad_tpu.utils.nsim_sampling``; the reference code's
``nsim_triplet_sampling.py:13-77``), on rows read by the stdlib ``csv``
module (``training/data.py::read_table``) where the JAX module uses pandas.

Input: rows with columns (reference, degraded, nsim), the NSIM labels of
the offline ViSQOL tool. Per reference group: append the clean file as an
NSIM = 1.0 row, draw an anchor, positive = the nearest-NSIM neighbour,
negative = 'easy' (NSIM distance > the positive's + margin, drawn) or
'hard' (the smallest remaining distance); N triplets per reference.

The draws and the order are the JAX module's: ``default_rng(seed)`` called
in the same order, and the candidates ordered as pandas'
``sort_values("nsim_dist")`` orders them, by numpy's quicksort ``argsort``
of the same float64 distances in the same row order (not stable: ties,
common here, keep the order that sort gives, which a stable sort would
not), NaN last.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

from ..training.data import drop_duplicates, read_table, write_rows

MARGIN = 0.05
TRIPLET_COLUMNS = ("Anchor", "Positive", "Negative", "anc_pos_dist", "anc_neg_dist")


def _sort_order(dist: np.ndarray) -> np.ndarray:
    """pandas' ``nargsort``: quicksort argsort of the non-NaN values, NaN
    positions last."""
    nan = np.isnan(dist)
    idx = np.arange(len(dist))
    order = idx[~nan][dist[~nan].argsort(kind="quicksort")]
    return np.concatenate([order, np.flatnonzero(nan)])


def create_triplets(rows: list, N: int = 1, hard_sampling: bool = True,
                    margin: float = MARGIN, seed: Optional[int] = None) -> list:
    """Rows (dicts with reference, degraded, nsim) -> triplet rows (dicts
    with ``TRIPLET_COLUMNS``), in the JAX module's order."""
    rng = np.random.default_rng(seed)
    rows = drop_duplicates(rows)
    out = []
    for ref in dict.fromkeys(r["reference"] for r in rows):
        group = [r for r in rows if r["reference"] == ref]
        names = [r["degraded"] for r in group] + [os.path.join("CLEAN", ref)]
        nsim = np.array([r["nsim"] for r in group] + [1.0], np.float64)
        for _ in range(N):
            a = int(rng.integers(len(names)))
            dist = np.abs(nsim - nsim[a])
            rest = np.delete(np.arange(len(names)), a)
            rest = rest[_sort_order(dist[rest])]
            if len(rest) < 2:
                continue
            pos, rest = rest[0], rest[1:]
            if not hard_sampling:
                cand = rest[dist[rest] > dist[pos] + margin]
                if len(cand) == 0:
                    continue
                neg = cand[rng.integers(len(cand))]
            else:
                neg = rest[0]
                if not dist[pos] < dist[neg]:
                    continue  # a tie; the reference would assert
            out.append({"Anchor": names[a], "Positive": names[pos], "Negative": names[neg],
                        "anc_pos_dist": float(dist[pos]), "anc_neg_dist": float(dist[neg])})
    return out


def _missing(v) -> bool:
    """A cell pandas reads as NaN: a NaN number or an empty string."""
    return v == "" or (isinstance(v, float) and math.isnan(v))


def build_triplet_csvs(train_nsim_csv: str, valid_nsim_csv: str, out_train: str,
                       out_valid: str, N: int = 3, seed: int = 10) -> list:
    """The reference's train.csv/valid.csv: easy (db = 1) and hard (db = 2)
    triplets concatenated (the levels the trainer filters by
    ``current_level``), rows with a missing cell dropped. Returns each
    file's rows."""
    tables = []
    for path, out in ((train_nsim_csv, out_train), (valid_nsim_csv, out_valid)):
        rows = read_table(path)
        both = ([{"db": 1, **r} for r in create_triplets(rows, N, False, seed=seed)]
                + [{"db": 2, **r} for r in create_triplets(rows, N, True, seed=seed)])
        both = [r for r in both if not any(_missing(v) for v in r.values())]
        write_rows(out, ("db", *TRIPLET_COLUMNS), both)
        tables.append(both)
    return tables
