"""A scoring corpus: groups of degraded and non-matching reference (NMR)
files in two directories.

Mix parameters: ``sizes_seed``; ``groups``, each ``{"dir": "deg" | "nmr",
"count", "seconds": [low, high], "noise": amplitude or [low, high]}``.
Returns ``{"deg": [(path, samples)], "nmr": [...], "deg_dir", "nmr_dir"}``."""

from __future__ import annotations

import numpy as np

from . import audio


def make(run, mix: dict) -> dict:
    out = {"deg": [], "nmr": []}
    jobs = []
    rng = np.random.default_rng([run.seed, 1])
    for gi, group in enumerate(mix["groups"]):
        d = run.tmp / group["dir"]
        d.mkdir(exist_ok=True)
        out[group["dir"] + "_dir"] = str(d)
        n = audio.sizes(mix["sizes_seed"] + gi, group["count"], group["seconds"])
        for i in rng.permutation(len(n)):
            path = str(d / f"{group['dir']}{gi}_{len(jobs):05d}.wav")
            jobs.append((path, int(n[i]), [run.seed, 2, len(jobs)], group["noise"]))
            out[group["dir"]].append((path, int(n[i])))
    audio.write_many(jobs)
    return out
