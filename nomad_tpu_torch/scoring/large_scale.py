"""Large-scale scoring (counterpart of ``nomad_tpu.scoring.large_scale``):
BASELINE config 4, ~10k degraded utterances x ~100 NMRs.

  1. Embeddings: the engine, over a ``data`` mesh when a process
     group of more than one rank runs (each rank embeds 1/n of every
     batch; the engine's gather gives every rank all of them).
  2. The distance matrix, rows (degraded) by columns (NMR), on a 2-D
     ``("row", "col")`` grid of the same ranks: rank (r, c) computes its
     block (``parallel.sharded_cdist``), centred as the whole matrix is.
  3. The blocks are all-gathered, so every rank holds the whole matrix,
     and the per-row means are numpy's ``dm.mean(axis=1)`` of it, as on
     one rank.

With one rank the matrix is the dense ``ops.distance.cdist`` on the device,
copied back once, and the means numpy's ``dm.mean(axis=1)``, as the JAX
module computes them; a 1 x 1 grid gives the dense path's bits.
Every rank returns ``(avg [n], dm [n, m])`` as numpy, as the JAX function
returns them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.distance import cdist
from ..parallel.mesh import (
    data_mesh,
    gather_blocks,
    grid_mesh,
    mesh_device,
    pad_to_multiple,
    sharded_cdist,
    world_size,
)
from .engine import EmbeddingEngine


@dataclass
class LargeScaleScorer:
    engine: EmbeddingEngine
    rows: int = 0  # grid rows; 0 -> auto (2 x N/2 when N >= 4 and even, else 1 x N)
    _mesh: Optional[object] = field(default=None, repr=False)

    def _grid(self):
        """The ``("row", "col")`` grid over the process group, None with one
        rank. Built once: a mesh's groups are made by every rank together."""
        n = world_size()
        if n == 1:
            return None
        if self._mesh is None:
            r = self.rows or (2 if n >= 4 and n % 2 == 0 else 1)
            self._mesh = grid_mesh(r, n // r)
        return self._mesh

    def score(self, deg_paths: Sequence[str],
              nmr_paths: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """Returns (avg [N_deg], distance_matrix [N_deg, N_nmr]). The
        embeddings stay on the device. (The JAX signature's ``progress``
        is left out: the port's engine prints no progress.)"""
        deg_emb = self.engine.embed_files_device(deg_paths)
        nmr_emb = self.engine.embed_files_device(nmr_paths)
        return self.score_embeddings(deg_emb, nmr_emb)

    def score_embeddings(self, deg_emb, nmr_emb) -> tuple[np.ndarray, np.ndarray]:
        """(avg, dm) of [n, D] and [m, D] embeddings (arrays or tensors),
        the same on every rank."""
        grid = self._grid()
        if grid is None:
            dev = self.engine.device
            dm = cdist(torch.as_tensor(deg_emb).to(dev), torch.as_tensor(nmr_emb).to(dev))
            dm = dm.cpu().numpy()
            return dm.mean(axis=1), dm
        return self.score_on_grid(grid, deg_emb, nmr_emb)

    @staticmethod
    def score_on_grid(grid, deg_emb, nmr_emb) -> tuple[np.ndarray, np.ndarray]:
        """``score_embeddings`` on a given ``grid_mesh`` (a 1 x 1 grid too)."""
        rows, cols = grid.size(0), grid.size(1)
        dev = mesh_device(grid)
        deg = torch.as_tensor(deg_emb).to(device=dev, dtype=torch.float32)
        nmr = torch.as_tensor(nmr_emb).to(device=dev, dtype=torch.float32)
        n, m = deg.shape[0], nmr.shape[0]
        # zero rows pad n and m to multiples of the grid; they take part in
        # the centre, as in the JAX module's padded arrays
        a = torch.zeros((pad_to_multiple(n, rows), deg.shape[1]), device=dev)
        a[:n] = deg
        b = torch.zeros((pad_to_multiple(m, cols), nmr.shape[1]), device=dev)
        b[:m] = nmr
        dm = gather_blocks(sharded_cdist(a, b, grid), grid).cpu().numpy()[:n, :m]
        return dm.mean(axis=1), dm


def make_large_scale_scorer(model, mesh=None, device: Optional[str] = None) -> LargeScaleScorer:
    """The engine over a ``data`` mesh of the process group (built when one
    of more than one rank runs) and the 2-D distance grid. The model moves
    to the engine's device."""
    if mesh is None and world_size() > 1:
        mesh = data_mesh()
    if mesh is None:
        from ..api import resolve_device

        device = resolve_device(device)
    engine = EmbeddingEngine(model, device, mesh=mesh)
    model.to(engine.device).eval()
    return LargeScaleScorer(engine)
