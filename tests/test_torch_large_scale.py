"""The port's large-scale scorer (``nomad_tpu_torch.scoring.large_scale``)
over gloo ranks (world sizes 2 and 4: a 1 x 2 and a 2 x 2 grid) and in one
process, against scipy, the port's single-process scoring and the JAX
scorer on its 8 virtual CPU devices (a 2 x 4 grid), on ``tiny()``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist as scipy_cdist

import nomad_tpu_torch.parallel.mesh as tmesh
import torch_dist_workers as workers
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
from nomad_tpu.scoring.large_scale import make_large_scale_scorer as jax_make_scorer
from nomad_tpu_torch.api import Nomad
from nomad_tpu_torch.convert import jax_to_state_dict
from nomad_tpu_torch.io import native, write_wav
from nomad_tpu_torch.models import Wav2Vec2Config
from nomad_tpu_torch.ops import cdist
from nomad_tpu_torch.parallel import grid_mesh, launch
from nomad_tpu_torch.scoring import LargeScaleScorer, make_large_scale_scorer

torch.set_num_threads(2)

EMB = 16
WORLDS = [2, 4]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Tiny JAX params (as tests/test_large_scale.py makes them) and the
    port's numpy state dict of them; the ragged 37 x 13 unit embeddings,
    19 waves and a few WAV files."""
    model = JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB)
    params = model.init(jax.random.key(0), jnp.zeros((1, 800)), method=JaxNomadModel.init_all)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(0)
    deg = rng.standard_normal((37, EMB)).astype(np.float32)
    nmr = rng.standard_normal((13, EMB)).astype(np.float32)
    deg /= np.linalg.norm(deg, axis=1, keepdims=True)
    nmr /= np.linalg.norm(nmr, axis=1, keepdims=True)
    waves = [(0.2 * rng.standard_normal(n)).astype(np.float32)
             for n in rng.integers(700, 1500, size=19)]
    root = tmp_path_factory.mktemp("large_scale")
    deg_paths, nmr_paths = [], []
    for i, n in enumerate([2500, 4096, 6100, 900, 4500, 3300, 5000]):
        deg_paths.append(str(root / f"deg{i}.wav"))
        write_wav(deg_paths[-1], 0.3 * rng.standard_normal(n), 16000)
    for i, n in enumerate([3000, 5200, 4100]):
        nmr_paths.append(str(root / f"nmr{i}.wav"))
        write_wav(nmr_paths[-1], 0.2 * rng.standard_normal(n), 16000)
    sd = {k: v.numpy() for k, v in jax_to_state_dict(params).items()}
    return {"params": params, "sd": sd, "deg": deg, "nmr": nmr, "waves": waves,
            "paths": (deg_paths, nmr_paths)}


@pytest.fixture(scope="module", params=WORLDS, ids=[f"world{n}" for n in WORLDS])
def ranks(request, case):
    n = request.param
    out = launch(workers.large_scale_rank, n, "cpu",
                 args=(case["sd"], case["deg"], case["nmr"], case["waves"], case["paths"]),
                 threads=1)
    return {"n": n, "out": out}


@pytest.fixture(scope="module")
def jax_scorer(case):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    scorer = jax_make_scorer(JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB), case["params"])
    waves = case["waves"]
    deg_emb, nmr_emb = scorer.engine.embed_waves(waves[:12]), scorer.engine.embed_waves(waves[12:])
    return {"ragged": scorer.score_embeddings(case["deg"], case["nmr"]),
            "waves_emb": (deg_emb, nmr_emb), "waves": scorer.score_embeddings(deg_emb, nmr_emb)}


@pytest.fixture(scope="module")
def single(case):
    """The port in one process: the dense path and ``Nomad.score_matrix``."""
    scorer = make_large_scale_scorer(workers.tiny_model(case["sd"]), device="cpu")
    waves = case["waves"]
    nomad = Nomad(device="cpu", config=Wav2Vec2Config.tiny(), emb_dim=EMB,
                  params=workers.torch_sd(case["sd"]))
    deg_paths, nmr_paths = case["paths"]
    return {"scorer": scorer,
            "waves_emb": (scorer.engine.embed_waves(waves[:12]),
                          scorer.engine.embed_waves(waves[12:])),
            "score_matrix": nomad.score_matrix(nmr_paths, deg_paths)}


def test_spawned_ranks_load_no_jax(ranks):
    for out in ranks["out"]:
        assert out["forbidden"] == [], out["forbidden"]


def test_grid_and_data_mesh(ranks):
    """A data mesh of the whole group under the engine; the grid's rows
    default to 2 x N/2 when N >= 4 and even, else 1 x N."""
    n = ranks["n"]
    for out in ranks["out"]:
        assert out["world_engine"] == n
        assert out["grid"] == ((2, n // 2) if n >= 4 else (1, n))


def test_sharded_matches_scipy_and_jax_with_ragged_sizes(ranks, case, jax_scorer):
    """37 x 13 is no multiple of either grid: padding and the masked row
    sums over the valid columns."""
    ref = scipy_cdist(case["deg"], case["nmr"])
    avg, dm = ranks["out"][0]["ragged"]
    for out in ranks["out"]:
        np.testing.assert_array_equal(out["ragged"][0], avg)
        np.testing.assert_array_equal(out["ragged"][1], dm)
    assert dm.shape == (37, 13) and avg.shape == (37,)
    np.testing.assert_allclose(dm, ref, atol=1e-4)
    np.testing.assert_allclose(avg, ref.mean(axis=1), atol=1e-4)
    jax_avg, jax_dm = jax_scorer["ragged"]
    np.testing.assert_allclose(dm, jax_dm, atol=1e-5, rtol=0)
    np.testing.assert_allclose(avg, jax_avg, atol=1e-5, rtol=0)


def test_end_to_end_waves(ranks, single, jax_scorer):
    for out in ranks["out"]:
        for ours, mine in zip(out["waves_emb"], single["waves_emb"]):
            np.testing.assert_allclose(ours, mine, atol=1e-5, rtol=0)
        for ours, theirs in zip(out["waves_emb"], jax_scorer["waves_emb"]):
            np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)
        avg, dm = out["waves"]
        assert dm.shape == (12, 7)
        assert np.all(np.isfinite(dm))
        assert np.all(dm >= 0) and np.all(dm <= 2.0 + 1e-5)
        np.testing.assert_allclose(dm, jax_scorer["waves"][1], atol=1e-5, rtol=0)
        np.testing.assert_allclose(avg, jax_scorer["waves"][0], atol=1e-5, rtol=0)


def test_score_on_files_matches_score_matrix(ranks, single):
    """``score(deg_paths, nmr_paths)`` through the mesh engine's file path
    against the single-process ``Nomad.score_matrix`` of the same files."""
    want = single["score_matrix"]
    for out in ranks["out"]:
        avg, dm = out["files"]
        assert dm.shape == want.shape == (7, 3)
        np.testing.assert_allclose(dm, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(avg, want.mean(axis=1), atol=1e-5, rtol=0)
        assert out["native_batches"] > 0 or not native.available()


def test_one_rank_is_the_dense_path(case, single):
    """No process group: ``cdist`` and numpy's row mean, bit for bit."""
    scorer = single["scorer"]
    assert scorer._grid() is None and scorer.engine.mesh is None
    avg, dm = scorer.score_embeddings(case["deg"], case["nmr"])
    want = cdist(torch.from_numpy(case["deg"]), torch.from_numpy(case["nmr"])).numpy()
    np.testing.assert_array_equal(dm, want)
    np.testing.assert_array_equal(avg, want.mean(axis=1))
    np.testing.assert_allclose(dm, scipy_cdist(case["deg"], case["nmr"]), atol=1e-4)


def test_one_by_one_grid_is_bit_equal_to_the_dense_path(case, single):
    """In a one-rank group, the grid path on a 1 x 1 grid gives the dense
    path's bits, and ``make_large_scale_scorer`` builds no data mesh."""
    tmesh.init_process_group(0, 1, "cpu")
    try:
        grid = grid_mesh(1, 1)
        for deg, nmr in ((case["deg"], case["nmr"]), single["waves_emb"]):
            want_avg, want_dm = single["scorer"].score_embeddings(deg, nmr)
            avg, dm = LargeScaleScorer.score_on_grid(grid, deg, nmr)
            np.testing.assert_array_equal(dm, want_dm)
            np.testing.assert_array_equal(avg, want_avg)
        scorer = make_large_scale_scorer(workers.tiny_model(case["sd"]), device="cpu")
        assert scorer.engine.mesh is None and scorer._grid() is None
    finally:
        tmesh.destroy_process_group()
