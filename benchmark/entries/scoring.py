"""What the scoring entries share: the reference's distances for the
scored files, and the comparison of the system's distance matrices and
rounded tables with them."""

from __future__ import annotations

import numpy as np
import torch

from .. import reference
from ..reference import wav, wav2vec2 as ref_w2v


def capture_score_matrix(nomad) -> list:
    """Wrap the instance's ``score_matrix`` (which ``predict`` calls) so that
    each call's raw distance matrix, before ``predict`` rounds it, is kept
    with its paths: ``[(nmr_paths, test_paths, matrix)]``."""
    calls = []
    inner = nomad.score_matrix

    def score_matrix(nmr_paths, test_paths):
        m = inner(nmr_paths, test_paths)
        calls.append((list(nmr_paths), list(test_paths), m))
        return m

    nomad.score_matrix = score_matrix
    return calls


def reference_embeddings(run, paths: list, control: bool) -> dict:
    """path -> the reference's embedding of the file, one file at a time
    (kept in the run, so that the control reuses the float32 ones)."""
    p, w = run.state["sd"], run.config["wav2vec2"]
    out = run.state.setdefault(("ref_emb", control), {})
    paths = [q for q in paths if q not in out]
    with reference.precision(tf32=control), torch.no_grad():
        for path in paths:
            x, _ = wav.read_pcm16(path)
            out[path] = ref_w2v.embed(p, w, torch.from_numpy(x).to(run.device)[None])[0]
    return out


def dm_gap(run, scored: list, files: list, control: bool) -> float:
    """The widest gap between a distance the system computed for one of
    ``files`` and the reference's (float64 distances of float32
    embeddings), over every call that scored it; with ``control`` the
    reference in TF32 takes the system's place. Every file has to have
    been scored."""
    nmr = sorted(scored[0][0])
    ref = reference_embeddings(run, files + nmr, control=False)
    ref_dm = ref_w2v.distances(torch.stack([ref[p] for p in files]),
                               torch.stack([ref[p] for p in nmr])).cpu().numpy()
    if control:
        low = reference_embeddings(run, files + nmr, control=True)
        got = ref_w2v.distances(torch.stack([low[p] for p in files]),
                                torch.stack([low[p] for p in nmr])).cpu().numpy()
        return float(np.abs(got - ref_dm).max())
    gap, seen = 0.0, set()
    for nmr_paths, test_paths, m in scored:
        rows = {p: i for i, p in enumerate(test_paths)}
        cols = {p: i for i, p in enumerate(nmr_paths)}
        here = [k for k, p in enumerate(files) if p in rows]
        if not here:
            continue
        seen.update(here)
        got = m[np.ix_([rows[files[k]] for k in here], [cols[p] for p in nmr])]
        gap = max(gap, float(np.abs(got.astype(np.float64) - ref_dm[here]).max()))
    return gap if len(seen) == len(files) else float("inf")


def table_gap(scored: list, tables: list) -> float:
    """The widest gap between a returned table's value and the rounding of
    the raw matrix it came from (3 decimals; the mean over the NMRs for the
    average table): 0 unless an answer was altered after the distances."""
    gap = 0.0
    for (_, _, m), (avg, dm) in zip(scored, tables, strict=True):
        gap = max(gap, float(np.abs(np.asarray(avg, np.float64).ravel()
                                    - np.round(np.mean(m, axis=1), 3)).max()),
                  float(np.abs(np.asarray(dm, np.float64) - np.round(m, 3)).max()))
    return gap
