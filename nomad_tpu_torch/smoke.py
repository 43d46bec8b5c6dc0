"""Smoke runner (counterpart of ``nomad_tpu.smoke``; the reference's
``nomad_score_test.py`` with checks): ``predict`` in dir mode on a
directory pair, then in csv mode when ``data/nmr_file.csv`` and
``data/test_file.csv`` exist. The dispatcher (``main.py``) runs it for the
smoke scripts' names."""

from __future__ import annotations

import os
from typing import Optional

NMR_CSV, DEG_CSV = "data/nmr_file.csv", "data/test_file.csv"


def run(config=None, nmr_dir: str = "data/nmr-data", deg_dir: str = "data/test-data",
        device: Optional[str] = None):
    """Score ``deg_dir`` against ``nmr_dir``; raises when a table has the
    wrong shape or a score falls outside [0, 2] (L2 distances of unit
    vectors). Returns the average and pairwise tables."""
    from .api import get_nomad

    nomad = get_nomad(device=device)
    avg, scores = nomad.predict("dir", nmr_dir, deg_dir)
    n_deg, n_nmr = len(os.listdir(deg_dir)), len(os.listdir(nmr_dir))
    if avg.values.shape != (n_deg, 1) or scores.values.shape != (n_deg, n_nmr):
        raise RuntimeError(f"smoke: tables of shape {avg.values.shape} and "
                           f"{scores.values.shape} for {n_deg} x {n_nmr} files")
    if not ((avg.values >= 0).all() and (avg.values <= 2.0).all()):
        raise RuntimeError(f"smoke: an average score outside [0, 2]: {avg.values.ravel()}")
    print(avg.head(n_deg))
    print(scores.head(n_deg))
    if os.path.isfile(NMR_CSV) and os.path.isfile(DEG_CSV):
        avg_csv, scores_csv = nomad.predict("csv", NMR_CSV, DEG_CSV)
        print(avg_csv.head(len(avg_csv.index)))
        print(scores_csv.head(len(scores_csv.index)))
    return avg, scores
