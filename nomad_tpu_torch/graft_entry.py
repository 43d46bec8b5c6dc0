"""Entry points of the port (counterpart of the repository's root
``__graft_entry__.py``).

``entry(device=None)``  -- the single-card forward: the NOMAD embedding of
                           BASE at the "balanced" islands, emb 256, on a
                           (2, 16000) batch with lengths [16000, 12000].
                           Returns ``(fn, args)``: ``fn(params, wav,
                           lengths)`` -> [2, 256], ``params`` a state dict
                           (the seeded init).
``dryrun_multichip(n)`` -- n ranks, one per card (``device_type="cpu"``:
                           gloo ranks on the CPU): a data-parallel triplet
                           train step on the tiny config (one 64-wide head,
                           the width the card's attention kernels take;
                           the JAX dryrun's tiny has four 16-wide) over a ``data``
                           mesh (2n triplets, dropout on), the mesh engine on
                           2n waves, and with n >= 4 and even the 2-D
                           sharded distance matrix. Raises when the machine
                           has fewer than n cards.
"""

from __future__ import annotations

import numpy as np
import torch

from .api import resolve_device, set_exact_precision
from .models import NomadModel, Wav2Vec2Config, init_weights
from .parallel.mesh import (
    data_mesh,
    gather_blocks,
    grid_mesh,
    launch,
    sharded_cdist,
)


def entry(device=None):
    dev = resolve_device(device)
    set_exact_precision()
    model = NomadModel(Wav2Vec2Config.balanced(), emb_dim=256)
    init_weights(model, seed=0).to(dev).eval().requires_grad_(False)
    wav = torch.zeros((2, 16000), device=dev)
    lengths = torch.tensor([16000, 12000], device=dev)

    def fn(params, wav, lengths):
        with torch.inference_mode():
            return torch.func.functional_call(model, params, (wav, lengths))

    return fn, (dict(model.state_dict()), wav, lengths)


def _dryrun_rank(n: int) -> float:
    """One rank of ``dryrun_multichip``: its loss after the step."""
    from .scoring.engine import EmbeddingEngine
    from .training.data import TripletBatch
    from .training.triplet import Training

    set_exact_precision()
    mesh = data_mesh(n)
    cfg = Wav2Vec2Config.tiny(num_heads=1)
    model = init_weights(NomadModel(cfg, emb_dim=16), seed=0)
    config = {
        "experiment_name": "none",  # skip dataset construction
        "lr": 1e-4,
        "freeze_convnet": True,
        "freeze_all": False,
        "margin": 0.2,
        "emb_dim": 16,
        "masked_pool": True,
    }
    tr = Training(config, mesh=mesh, params=model.state_dict(), model_config=cfg)
    tr._build_optimizer()

    b = 2 * n
    rng = np.random.default_rng(0)
    lengths = rng.integers(500, 801, size=(b,)).astype(np.int32)
    a, p, neg = (rng.standard_normal((b, 800)).astype(np.float32) for _ in range(3))
    loss = tr.train_step(TripletBatch(a, p, neg, lengths, lengths, lengths),
                         torch.Generator().manual_seed(1)).item()
    assert np.isfinite(loss), loss

    engine = EmbeddingEngine(tr.model, mesh=mesh)
    waves = [(0.1 * rng.standard_normal(k)).astype(np.float32)
             for k in rng.integers(600, 1200, size=2 * n)]
    emb = engine.embed_waves(waves)
    assert emb.shape == (2 * n, 16) and np.isfinite(emb).all(), emb.shape

    if n >= 4 and n % 2 == 0:
        grid = grid_mesh(2, n // 2)
        a = rng.standard_normal((8, 16)).astype(np.float32)
        bmat = rng.standard_normal((n, 16)).astype(np.float32)
        d = gather_blocks(sharded_cdist(a, bmat, grid), grid)
        assert d.shape == (8, n) and bool(torch.isfinite(d).all()), d.shape
    return loss


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> None:
    threads = 1 if device_type == "cpu" else None
    losses = launch(_dryrun_rank, n_devices, device_type, args=(n_devices,), threads=threads)
    if len(set(losses)) != 1:
        raise AssertionError(f"the ranks returned different losses: {losses}")
    print(f"dryrun_multichip OK on {n_devices} {device_type} ranks; loss={losses[0]:.4f}")
