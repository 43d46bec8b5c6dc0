"""Rank functions for the gloo tests of the port's data-parallel and
large-scale paths (``tests/test_torch_parallel.py``,
``tests/test_torch_large_scale.py``). ``parallel.launch`` spawns the ranks,
which import this module by name and never JAX: keep JAX and the JAX
package out of it (``tests/test_torch_isolation.py`` checks)."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

import nomad_tpu_torch.api as tapi
from nomad_tpu_torch.api import Nomad
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config
from nomad_tpu_torch.parallel import data_mesh, gather_blocks, grid_mesh, sharded_cdist
from nomad_tpu_torch.scoring import EmbeddingEngine, make_large_scale_scorer
from nomad_tpu_torch.training import Training
from nomad_tpu_torch.training.data import TripletBatch

EMB = 16
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "nomad_tpu"}


def torch_sd(sd: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def numpy_sd(sd: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def tiny_model(sd: dict) -> NomadModel:
    model = NomadModel(Wav2Vec2Config.tiny(), emb_dim=EMB)
    model.load_state_dict(torch_sd(sd), strict=True)
    return model.eval().requires_grad_(False)


def forbidden_loaded() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def train_step(config: dict, sd: dict, batch: dict, seed: int, rates: dict, mesh=None) -> dict:
    """One train step and one eval step of ``Training`` from the state
    dict: the step's loss, the parameters and gradients after it, Adam's
    state, the eval loss."""
    tr = Training(dict(config), device=None if mesh is not None else "cpu", mesh=mesh,
                  params=torch_sd(sd), model_config=Wav2Vec2Config.tiny(**rates))
    tr._build_optimizer()
    tb = TripletBatch(**batch)
    loss = tr.train_step(tb, torch.Generator().manual_seed(seed)).item()
    names = tr._opt_names()
    adam = {names[i]: numpy_sd(s) for i, s in tr.optimizer.state_dict()["state"].items()}
    return {"loss": loss, "params": numpy_sd(tr.model.state_dict()),
            "grads": {n: p.grad.numpy().copy() for n, p in tr.model.named_parameters()
                      if p.grad is not None},
            "adam": adam, "eval_loss": tr.eval_step(tb).item()}


def parallel_rank(sd: dict, waves: list, cdist_ab: tuple, step: dict, dirs: dict) -> dict:
    """A rank of ``test_torch_parallel``: the mesh engine, the sharded
    cdist on a 2 x n/2 grid, the DP steps (dropout on, rates at 0),
    ``Nomad(mesh=).predict`` and ``Nomad(mesh=)`` on ``.pt`` weights."""
    n = dist.get_world_size()
    mesh = data_mesh()
    out = {"rank": dist.get_rank(), "world": n}
    engine = EmbeddingEngine(tiny_model(sd), mesh=mesh)
    out["emb"] = engine.embed_waves(waves)
    out["plan"] = [(len(c), b, blen) for c, b, blen in engine.plan([len(w) for w in waves])]
    out["engine_batches"] = engine.batches

    grid = grid_mesh(2, n // 2)
    block = sharded_cdist(*cdist_ab, grid)
    out["block"] = block.numpy()
    out["cdist"] = gather_blocks(block, grid).numpy()

    for key, rates in (("dropout", {}), ("rates0", step["zero_rates"])):
        out[key] = train_step(step["config"], sd, step["batch"], step["seed"], rates, mesh)

    writes = []
    plain = tapi.write_results
    tapi.write_results = lambda *a: writes.append(a[2]) or plain(*a)
    try:
        nomad = Nomad(config=Wav2Vec2Config.tiny(), emb_dim=EMB, params=torch_sd(sd), mesh=mesh)
        avg, dm = nomad.predict("dir", dirs["nmr"], dirs["deg"], dirs["out"])
    finally:
        tapi.write_results = plain
    paths = [nomad._resolve_paths(dirs[k]) for k in ("nmr", "deg")]
    out["predict"] = {"avg": avg.values, "dm": dm.values, "rows": avg.index,
                      "writes": writes, "raw": nomad.score_matrix(*paths)}
    out["pt"] = pt_weights(dirs["weights"], waves, mesh)
    out["forbidden"] = forbidden_loaded()
    return out


def pt_weights(weights_dir: str, waves: list, mesh) -> dict:
    """``Nomad(mesh=)`` on a weights dir that holds only a ``.pt``: the
    embeddings, and how many times this rank converted the checkpoint."""
    conversions = []
    plain = tapi.convert_checkpoint
    tapi.convert_checkpoint = lambda *a: conversions.append(a[0]) or plain(*a)
    try:
        nomad = Nomad(config=Wav2Vec2Config.tiny(), emb_dim=EMB, weights_dir=weights_dir,
                      mesh=mesh)
        emb = nomad.engine.embed_waves(waves)
    finally:
        tapi.convert_checkpoint = plain
    return {"emb": emb, "conversions": len(conversions)}


def large_scale_rank(sd: dict, deg: np.ndarray, nmr: np.ndarray, waves: list,
                     paths: tuple) -> dict:
    """A rank of ``test_torch_large_scale``: ``make_large_scale_scorer``
    over the process group, on embeddings, on waves and on files."""
    scorer = make_large_scale_scorer(tiny_model(sd), device="cpu")
    out = {"rank": dist.get_rank(), "world_engine": scorer.engine.world}
    out["ragged"] = scorer.score_embeddings(deg, nmr)
    grid = scorer._grid()
    out["grid"] = (grid.size(0), grid.size(1))
    deg_emb = scorer.engine.embed_waves(waves[:12])
    nmr_emb = scorer.engine.embed_waves(waves[12:])
    out["waves_emb"] = (deg_emb, nmr_emb)
    out["waves"] = scorer.score_embeddings(deg_emb, nmr_emb)
    out["files"] = scorer.score(*paths)
    out["native_batches"] = scorer.engine.transfer["native_batches"]
    out["forbidden"] = forbidden_loaded()
    return out


def sleep(seconds: float) -> None:
    time.sleep(seconds)


def fail_on_rank(bad: int) -> None:
    """Rank ``bad`` raises; the others sleep for ten minutes."""
    if dist.get_rank() == bad:
        raise ValueError("planted fault")
    sleep(600)
