"""The port's parallel layer (``nomad_tpu_torch.parallel``), the mesh
engine, ``Training(mesh=)``, ``Nomad(mesh=)`` and the graft entries,
against the port's single-process paths and the JAX package on its 8
virtual CPU devices (``tests/conftest.py``), on ``tiny()``.

The ranks run over gloo: one launch per world size (2, 4) in a
module-scoped fixture, whose results the tests read. The rank functions
live in ``tests/torch_dist_workers.py``, which imports no JAX. The graft
entries are in ``tests/test_torch_graft_entry.py``."""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import nomad_tpu_torch.parallel.mesh as tmesh
import torch_dist_workers as workers
from nomad_tpu.api import _flatten
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
from nomad_tpu.parallel import data_mesh as jax_data_mesh
from nomad_tpu.parallel import grid_mesh as jax_grid_mesh
from nomad_tpu.parallel import pad_to_multiple as jax_pad_to_multiple
from nomad_tpu.parallel import sharded_cdist as jax_sharded_cdist
from nomad_tpu.scoring import EmbeddingEngine as JaxEngine
from nomad_tpu.scoring import engine as jengine
from nomad_tpu.training.triplet import Training as JaxTraining
from nomad_tpu_torch import graft_entry
from nomad_tpu_torch.api import CACHE_FILENAME, NOMAD_FILENAME, Nomad
from nomad_tpu_torch.convert import jax_to_state_dict, state_dict_to_jax
from nomad_tpu_torch.convert.fairseq_synth import write_nomad_checkpoint
from nomad_tpu_torch.io import write_wav
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config
from nomad_tpu_torch.ops import cdist
from nomad_tpu_torch.parallel import data_mesh, grid_mesh, launch, pad_to_multiple
from nomad_tpu_torch.scoring.engine import EmbeddingEngine, EmbeddingLRU
from nomad_tpu_torch.training import Training

torch.set_num_threads(2)

EMB = 16
WORLDS = [2, 4]
ZERO_RATES = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
STEP_CONFIG = {"experiment_name": "none", "lr": 1e-3, "freeze_convnet": True,
               "freeze_all": False, "emb_dim": EMB, "masked_pool": True, "margin": 0.2}


@pytest.fixture(scope="module")
def tiny():
    """JAX params of the tiny model (as tests/test_mesh.py makes them), the
    port's numpy state dict of them, seeded waves, cdist inputs, a triplet
    batch and WAV directories."""
    model = JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB)
    params = model.init(jax.random.key(0), jnp.zeros((1, 800)), method=JaxNomadModel.init_all)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(0)
    waves = [(0.2 * rng.standard_normal(n)).astype(np.float32)
             for n in [900, 1100, 700, 1300, 800, 1000, 950, 1050, 990]]
    ab = (rng.standard_normal((16, 32)).astype(np.float32),
          rng.standard_normal((8, 32)).astype(np.float32))
    lengths = rng.integers(500, 801, size=(3, 8)).astype(np.int32)
    wav = [rng.standard_normal((8, 800)).astype(np.float32) for _ in range(3)]
    for w, ln in zip(wav, lengths):
        for i, n in enumerate(ln):
            w[i, n:] = 0.0
    batch = {"anchor": wav[0], "positive": wav[1], "negative": wav[2],
             "lengths_a": lengths[0], "lengths_p": lengths[1], "lengths_n": lengths[2]}
    sd = {k: v.numpy() for k, v in jax_to_state_dict(params).items()}
    return {"params": params, "sd": sd, "waves": waves, "ab": ab, "batch": batch}


def wav_dirs(root, rng) -> dict:
    dirs = {k: root / k for k in ("nmr", "deg", "out")}
    for d in dirs.values():
        d.mkdir()
    for i, n in enumerate([3000, 5200, 4100]):
        write_wav(str(dirs["nmr"] / f"ref{i}.wav"), 0.2 * rng.standard_normal(n), 16000)
    for i, n in enumerate([2500, 4096, 6100, 900, 4500]):
        write_wav(str(dirs["deg"] / f"deg{i}.wav"), 0.3 * rng.standard_normal(n), 16000)
    return {k: str(v) for k, v in dirs.items()}


@pytest.fixture(scope="module", params=WORLDS, ids=[f"world{n}" for n in WORLDS])
def ranks(request, tiny, tmp_path_factory):
    """One gloo launch of n ranks; every rank's results."""
    n = request.param
    dirs = wav_dirs(tmp_path_factory.mktemp(f"world{n}"), np.random.default_rng(5))
    dirs["weights"] = str(tmp_path_factory.mktemp(f"weights{n}"))
    write_nomad_checkpoint(workers.tiny_model(tiny["sd"]),
                           os.path.join(dirs["weights"], NOMAD_FILENAME))
    step = {"config": STEP_CONFIG, "batch": tiny["batch"], "seed": 3, "zero_rates": ZERO_RATES}
    out = launch(workers.parallel_rank, n, "cpu",
                 args=(tiny["sd"], tiny["waves"], tiny["ab"], step, dirs), threads=1)
    return {"n": n, "out": out, "dirs": dirs}


@pytest.fixture(scope="module")
def single(tiny, tmp_path_factory):
    """The port's single-process paths on the same inputs."""
    sd = tiny["sd"]
    engine = EmbeddingEngine(workers.tiny_model(sd), torch.device("cpu"))
    steps = {key: workers.train_step(STEP_CONFIG, sd, tiny["batch"], 3, rates)
             for key, rates in (("dropout", {}), ("rates0", ZERO_RATES))}
    dirs = wav_dirs(tmp_path_factory.mktemp("single"), np.random.default_rng(5))
    nomad = Nomad(device="cpu", config=Wav2Vec2Config.tiny(), emb_dim=EMB,
                  params=workers.torch_sd(sd))
    avg, _dm = nomad.predict("dir", dirs["nmr"], dirs["deg"], dirs["out"])
    return {"emb": engine.embed_waves(tiny["waves"]), "steps": steps, "avg": avg}


@pytest.fixture(scope="module")
def jax_refs(tiny):
    """The JAX package on its 8 virtual devices: the data-mesh engine, the
    2 x 4 sharded cdist and the DP step with the rates at 0."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    params, model = tiny["params"], JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB)
    mesh = jax_data_mesh(8)
    emb = JaxEngine(model, params, mesh=mesh).embed_waves(tiny["waves"])
    d = np.asarray(jax_sharded_cdist(jnp.asarray(tiny["ab"][0]), jnp.asarray(tiny["ab"][1]),
                                     jax_grid_mesh(2, 4)))
    tr = JaxTraining(dict(STEP_CONFIG), mesh=mesh, params=params,
                     model_config=JaxConfig.tiny(**ZERO_RATES))
    tr.margin = 0.2
    tr._build_optimizer()
    b = tiny["batch"]
    step = tr._get_step(b["anchor"].shape)
    p2, _, loss = step(tr.params, tr.opt_state,
                       *(jnp.asarray(b[k]) for k in ("anchor", "positive", "negative",
                                                     "lengths_a", "lengths_p", "lengths_n")),
                       jnp.float32(1e-5), jnp.float32(1e-3), jax.random.key(3))
    return {"emb": emb, "cdist": d, "loss": float(loss),
            "params": _flatten(jax.device_get(p2["params"]))}


@pytest.fixture(scope="module")
def group1():
    """A one-rank gloo group in this process."""
    tmesh.init_process_group(0, 1, "cpu")
    try:
        yield
    finally:
        tmesh.destroy_process_group()


# ---------------- pure functions ----------------


def test_pad_to_multiple_matches_jax():
    for n in range(0, 41):
        for m in range(1, 10):
            assert pad_to_multiple(n, m) == jax_pad_to_multiple(n, m)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_mesh_batch_plan_matches_jax(world):
    """The engine's full batch under a mesh of ``world`` ranks: a multiple
    of the world size, no snap to 32, as the JAX engine's over
    ``data_mesh(world)``; a batch of fewer files takes pad rows to the next
    multiple (``test_torch_scoring.py::test_plan_invariants``)."""
    jeng = JaxEngine(JaxNomadModel(JaxConfig.base(attention_impl="pallas")), params={},
                     mesh=jax_data_mesh(world))
    model = NomadModel(Wav2Vec2Config.tiny())
    model.config = Wav2Vec2Config.base()  # only the config feeds the plan
    teng = EmbeddingEngine(model, torch.device("cpu"))
    teng.world = world  # the plan reads only the world size
    for n in (1, 4096, 4097, 16000, 160000, 163840, 163841, 480000, 1310720):
        blen = jengine.bucket_length(n)
        assert teng.batch_size_for(blen) == jeng.batch_size_for(blen)
    for rows in (1, 2, 3, 7, 31, 33, 95):  # a tail under the full batch
        assert teng._padded_rows(rows) == jeng.batch_size_for(163840, remaining=rows)


def test_mesh_refusals(group1, monkeypatch):
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        grid_mesh(2, 2)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        grid_mesh(1, 2)
    with pytest.raises(ValueError, match="spans the whole group"):
        data_mesh(2)
    assert grid_mesh(1, 1).size() == 1 and data_mesh().size() == 1
    mesh = data_mesh()
    model = workers.tiny_model(workers.numpy_sd(NomadModel(Wav2Vec2Config.tiny(),
                                                           emb_dim=EMB).state_dict()))
    engine = EmbeddingEngine(model, "cpu", mesh=mesh)
    assert engine.device == torch.device("cpu") and engine.world == 1
    with pytest.raises(ValueError, match="single-process"):
        engine.file_cache = EmbeddingLRU()
    for make in (lambda: EmbeddingEngine(model, "cuda", mesh=mesh),
                 lambda: Nomad(device="cuda", mesh=mesh),
                 lambda: Training(dict(STEP_CONFIG), device="cuda", mesh=mesh)):
        with pytest.raises(ValueError, match="disagrees with the mesh"):
            make()
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="no process group"):
        data_mesh()


def test_launch_refuses_missing_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch(workers.sleep, 1, "cuda", args=(0,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA cards; this machine has 1"):
        launch(workers.sleep, 2, "cuda", args=(0,))


def test_launch_bounds_its_waits():
    """A rank that raises fails the launch at once (its peer, asleep for
    ten minutes, is killed); a rank that hangs fails it at the timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*planted fault"):
        launch(workers.fail_on_rank, 2, "cpu", args=(1,), timeout_s=120, threads=1)
    assert time.monotonic() - t0 < 100
    with pytest.raises(TimeoutError, match="did not finish within 2"):
        launch(workers.sleep, 1, "cpu", args=(600,), timeout_s=2, threads=1)


def test_world_size_one_step_is_bit_equal(tiny, group1):
    """A one-rank mesh step (dropout on, remat on) gives the plain step's
    bits: the loss, every parameter, every gradient and Adam's state."""
    rates = {"remat": True}
    plain = workers.train_step(STEP_CONFIG, tiny["sd"], tiny["batch"], 3, rates)
    meshed = workers.train_step(STEP_CONFIG, tiny["sd"], tiny["batch"], 3, rates, data_mesh())
    assert meshed["loss"] == plain["loss"] and meshed["eval_loss"] == plain["eval_loss"]
    for key in ("params", "grads"):
        assert sorted(meshed[key]) == sorted(plain[key])
        for name, v in plain[key].items():
            np.testing.assert_array_equal(meshed[key][name], v, err_msg=name)
    for name, state in plain["adam"].items():
        for k, v in state.items():
            np.testing.assert_array_equal(meshed["adam"][name][k], v, err_msg=name)


# ---------------- gloo ranks ----------------


def test_spawned_ranks_load_no_jax(ranks):
    for out in ranks["out"]:
        assert out["forbidden"] == [], out["forbidden"]


def test_mesh_engine_matches_single_process(ranks, single):
    n = ranks["n"]
    first = ranks["out"][0]
    assert all(size % n == 0 for _k, size, _l in first["plan"])
    for out in ranks["out"]:
        np.testing.assert_array_equal(out["emb"], first["emb"])
        assert out["engine_batches"] == len(first["plan"])
    np.testing.assert_allclose(first["emb"], single["emb"], atol=1e-5, rtol=0)


def test_mesh_engine_matches_jax(ranks, jax_refs):
    np.testing.assert_allclose(ranks["out"][0]["emb"], jax_refs["emb"], atol=1e-5, rtol=0)


def test_sharded_cdist_matches_dense_and_jax(ranks, tiny, jax_refs):
    n = ranks["n"]
    dense = cdist(*(torch.from_numpy(x) for x in tiny["ab"])).numpy()
    rn, cm = 16 // 2, 8 // (n // 2)
    for out in ranks["out"]:
        np.testing.assert_array_equal(out["cdist"], ranks["out"][0]["cdist"])
        r, c = divmod(out["rank"], n // 2)
        np.testing.assert_array_equal(out["block"],
                                      out["cdist"][r * rn:(r + 1) * rn, c * cm:(c + 1) * cm])
    np.testing.assert_allclose(ranks["out"][0]["cdist"], dense, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ranks["out"][0]["cdist"], jax_refs["cdist"], atol=1e-5, rtol=0)


def test_dp_step_with_dropout_matches_single_process(ranks, single):
    """The gradient all-reduce over the mesh reproduces the single-process
    step, dropout included (the masks of the global batch): the loss and
    the parameters within 1e-5 (as tests/test_mesh.py holds the JAX
    package), the averaged gradient within 1e-5 of max |g|. Every rank
    holds the same bits."""
    ref = single["steps"]["dropout"]
    first = ranks["out"][0]["dropout"]
    for out in ranks["out"][1:]:
        assert out["dropout"]["loss"] == first["loss"]
        for name, v in first["params"].items():
            np.testing.assert_array_equal(out["dropout"]["params"][name], v, err_msg=name)
    assert abs(first["loss"] - ref["loss"]) < 1e-5
    assert abs(first["eval_loss"] - ref["eval_loss"]) < 1e-5
    for name, v in ref["params"].items():
        np.testing.assert_allclose(first["params"][name], v, atol=1e-5, rtol=0, err_msg=name)
    assert sorted(first["grads"]) == sorted(ref["grads"])
    gmax = max(np.abs(g).max() for g in ref["grads"].values())
    for name, g in ref["grads"].items():
        assert np.abs(first["grads"][name] - g).max() <= 1e-5 * gmax, name


def test_dp_step_at_rates_zero_matches_jax(ranks, jax_refs):
    """Against the JAX DP step on ``data_mesh(8)``, at the tolerances of
    tests/test_torch_training.py::test_one_train_step_matches_jax."""
    out = ranks["out"][0]["rates0"]
    assert abs(out["loss"] - jax_refs["loss"]) <= 1e-5
    ours = state_dict_to_jax(workers.torch_sd(out["params"]))
    theirs = jax_refs["params"]
    assert sorted(ours) == sorted(theirs)
    gmax = max(np.abs(g).max() for g in out["grads"].values())
    for key, want in theirs.items():
        d = np.abs(ours[key] - want)
        assert d.max() < 2.5e-3, (key, d.max())
        if key.endswith("k_proj/bias"):
            noise = [g for n, g in out["grads"].items() if n.endswith("k_proj.bias")]
            assert max(np.abs(g).max() for g in noise) < 1e-6 * gmax
        else:
            assert d.mean() < 5e-6, (key, d.mean())


def test_nomad_mesh_writes_its_csvs_once(ranks, single):
    """Every rank returns the same scores; rank 0 alone writes the CSVs."""
    outs = [o["predict"] for o in ranks["out"]]
    assert outs[0]["writes"] == [ranks["dirs"]["out"]]
    assert all(o["writes"] == [] for o in outs[1:])
    assert sorted(os.listdir(ranks["dirs"]["out"])) == ["nomad_avg.csv", "nomad_scores.csv"]
    for o in outs:
        np.testing.assert_array_equal(o["raw"], outs[0]["raw"])
        np.testing.assert_array_equal(o["avg"], outs[0]["avg"])
    assert outs[0]["rows"] == single["avg"].index
    np.testing.assert_allclose(outs[0]["avg"], single["avg"].values, atol=1e-3, rtol=0)


def test_nomad_mesh_converts_a_pt_once(ranks, single):
    """With only a ``.pt`` in the weights dir, rank 0 converts it and
    writes the cache; the other ranks wait and read the cache. No partly
    written file is left, and every rank embeds with the same weights."""
    outs = [o["pt"] for o in ranks["out"]]
    assert [o["conversions"] for o in outs] == [1] + [0] * (ranks["n"] - 1)
    assert sorted(os.listdir(ranks["dirs"]["weights"])) == sorted([NOMAD_FILENAME,
                                                                   CACHE_FILENAME])
    for o in outs:
        np.testing.assert_array_equal(o["emb"], outs[0]["emb"])
    np.testing.assert_allclose(outs[0]["emb"], single["emb"], atol=1e-5, rtol=0)
