"""Step-indexed checkpoints for resuming training (counterpart of
``nomad_tpu.training.checkpoint``, npz only: no orbax).

    <root>/step_<n>/arrays.npz + meta.json
    <root>/LATEST                  (the step number)

A step is written to ``step_<n>.tmp`` and renamed into place, so a crash
leaves the previous step whole; ``keep`` prunes all but the newest steps.
The state is a nested dict of arrays (flattened to "a/b/c" keys in the
npz), the meta a JSON-able dict.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np

from ..convert.from_jax import flatten


def _unflatten(flat) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = os.path.abspath(root)
        self.keep = keep
        os.makedirs(self.root, exist_ok=True)

    def save(self, step: int, state: dict, meta: Optional[dict] = None) -> None:
        path = os.path.join(self.root, f"step_{step}")
        tmp = path + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flatten(state))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta or {}, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        with open(os.path.join(self.root, "LATEST"), "w") as f:
            f.write(str(step))
        for s in self.steps()[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"), ignore_errors=True)

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        latest = os.path.join(self.root, "LATEST")
        if os.path.isfile(latest):
            with open(latest) as f:
                text = f.read().strip()
            if text.isdigit() and os.path.isdir(os.path.join(self.root, f"step_{text}")):
                return int(text)
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Optional[tuple[int, dict, dict]]:
        """(step, state, meta) of ``step`` (default: the latest), or None."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.root, f"step_{step}")
        npz = os.path.join(path, "arrays.npz")
        if not os.path.isfile(npz):
            return None
        with np.load(npz) as flat:
            state = _unflatten(dict(flat))
        meta_path = os.path.join(path, "meta.json")
        meta = {}
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return step, state, meta
