"""The port's four eval experiments and the ``eval_w2v`` ablation against
the JAX package's on one synthetic tree and the same weights, and the
port's ``utils.metrics`` against the JAX package's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from nomad_tpu.api import _flatten
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
from nomad_tpu.training import Training as JaxTraining
from nomad_tpu.utils import metrics as jmetrics
from nomad_tpu_torch.io import write_wav
from nomad_tpu_torch.models import Wav2Vec2Config
from nomad_tpu_torch.training import Training
from nomad_tpu_torch.utils import metrics

torch.set_num_threads(2)
EMB = 16
TOL = 1e-5


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """NMR dir, degraded WAVs in two dbs, the metadata CSVs of all four
    experiments, and a JAX-written best_model.npz."""
    base = tmp_path_factory.mktemp("evals")
    rng = np.random.default_rng(0)
    nmr = base / "nmr"
    nmr.mkdir()
    for i in range(3):
        write_wav(str(nmr / f"tsp_{i}.wav"), (0.2 * rng.standard_normal(1200)).astype(np.float32),
                  16000, bits=16)
    deg = base / "deg"
    (deg / "NOISE").mkdir(parents=True)
    (deg / "REF").mkdir()
    quality, fr, intensity, valid = [], [], [], []
    for ci, level in enumerate((5, 10, 15, 30)):
        for j in range(2):
            name = f"NOISE/f{j}_NOISE_{level}.wav"
            n = 1100 + 60 * j
            clean = (0.2 * rng.standard_normal(n)).astype(np.float32)
            write_wav(str(deg / f"REF/f{j}_{level}.wav"), clean, 16000, bits=16)
            noisy = clean + 0.03 * (ci + 1) * rng.standard_normal(n).astype(np.float32)
            write_wav(str(deg / name), noisy, 16000, bits=16)
            for db in ("dbA", "dbB"):
                quality.append(f"{db},{name},NOISE_{level},{4.5 - 0.9 * ci + 0.1 * j},"
                               f"REF/f{j}_{level}.wav")
            intensity.append(f"{name},NOISE,{level}")
            intensity.append(f"{name},CLIP,{level + j}")
            valid.append(f"{1 + j},{name},NOISE/f{j}_NOISE_5.wav,NOISE/f{j}_NOISE_15.wav,0.1,0.3")
    files = {
        "quality": "db,filepath_deg,condition,mos,filepath_ref\n" + "\n".join(quality),
        "intensity": "filepath_deg,Degradation,Condition\n" + "\n".join(intensity),
        "valid": "db,Anchor,Positive,Negative,anc_pos_dist,anc_neg_dist\n" + "\n".join(valid),
    }
    paths = {}
    for key, text in files.items():
        paths[key] = str(base / f"{key}.csv")
        (base / f"{key}.csv").write_text(text + "\n")
    model_dir = base / "model"
    model_dir.mkdir()
    params = JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB).init(
        jax.random.key(2), jnp.zeros((1, 800)), method=JaxNomadModel.init_all)
    ckpt = str(model_dir / "best_model.npz")
    np.savez(ckpt, **_flatten(jax.device_get(params["params"])))
    return {"base": base, "nmr": str(nmr), "deg": str(deg) + "/", "ckpt": ckpt, **paths}


def eval_config(t, **over):
    cfg = {
        "experiment_name": "quality_nmr", "non_match_dir": t["nmr"],
        "test_db_file": t["quality"], "test_db_file_fr": t["quality"],
        "test_root_wav": t["deg"], "test_mono_data": t["intensity"],
        "test_mono_wav": t["deg"], "root": t["deg"], "valid_df": t["valid"],
        "nomad_model_path": t["ckpt"], "db": None, "conds": None, "emb_dim": EMB,
        "eval_w2v": False, "current_level": [1, 2], "trim": False,
    }
    cfg.update(over)
    return cfg


def pair(t, **over):
    return (JaxTraining(eval_config(t, **over), model_config=JaxConfig.tiny()),
            Training(eval_config(t, **over), device="cpu", model_config=Wav2Vec2Config.tiny()))


def assert_reports_match(ours, theirs):
    assert list(ours) == sorted(theirs)
    for db in theirs:
        assert ours[db].keys() == theirs[db].keys()
        for k, v in theirs[db].items():
            np.testing.assert_allclose(ours[db][k], v, rtol=TOL, atol=TOL, err_msg=f"{db} {k}")


@pytest.mark.parametrize("over", [{}, {"db": ["dbB"], "conds": ["NOISE_5", "NOISE_1"]}],
                         ids=["all", "filtered"])
def test_eval_audio_quality_matches_jax(eval_tree, over):
    jtr, tr = pair(eval_tree, **over)
    theirs = jtr.eval_audio_quality(eval_tree["ckpt"], plot=False)
    ours = tr.eval_audio_quality(eval_tree["ckpt"], plot=False)
    assert_reports_match(ours, theirs)
    assert list(ours) == (["dbB"] if over else ["dbA", "dbB"])


def test_eval_full_reference_matches_jax(eval_tree):
    jtr, tr = pair(eval_tree, experiment_name="quality_fr")
    theirs = jtr.eval_full_reference(eval_tree["ckpt"], plot=False)
    ours = tr.eval_full_reference(eval_tree["ckpt"], plot=False)
    assert_reports_match(ours, theirs)
    assert all(np.isfinite(v) for r in ours.values() for v in r.values())


def test_eval_degradation_intensity_matches_jax(eval_tree):
    jtr, tr = pair(eval_tree, experiment_name="intensity")
    theirs = jtr.eval_degradation_intensity(eval_tree["ckpt"])
    ours = tr.eval_degradation_intensity(eval_tree["ckpt"])
    assert list(ours) == sorted(theirs) == ["CLIP", "NOISE"]
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], v, rtol=TOL, atol=TOL)


def test_eval_degr_level_matches_jax(eval_tree):
    jtr, tr = pair(eval_tree, experiment_name="valid_rank")
    theirs = jtr.eval_degr_level(eval_tree["ckpt"], plot=False)
    ours = tr.eval_degr_level(eval_tree["ckpt"], plot=False)
    assert ours["Anchor"] == list(theirs["Anchor"])
    assert ours["condition"] == list(theirs["condition"])
    np.testing.assert_allclose(ours["Distance"], theirs["Distance"].to_numpy(),
                               rtol=TOL, atol=TOL)
    assert np.all(np.diff(ours["Distance"]) >= 0)


def test_eval_w2v_embeds_the_raw_features_like_jax(eval_tree):
    jtr, tr = pair(eval_tree, eval_w2v=True)
    jtr.load_checkpoint(eval_tree["ckpt"])  # the same weights on both sides
    tr.load_checkpoint(eval_tree["ckpt"])
    names = ["NOISE/f0_NOISE_5.wav", "NOISE/f1_NOISE_30.wav"]
    want = jtr.get_embeddings_csv(pd.Series(names, name="filepath_deg"), root=eval_tree["deg"])
    got_names, got = tr.get_embeddings_csv(names, root=eval_tree["deg"])
    assert got_names == names and got.shape == (2, Wav2Vec2Config.tiny().hidden_size)
    np.testing.assert_allclose(got, want.iloc[:, 1:].to_numpy(), rtol=TOL, atol=TOL)
    # under eval_w2v the eval leaves the weights as they are, as JAX's does
    theirs = jtr.eval_degradation_intensity(eval_tree["base"] / "absent.npz")
    ours = tr.eval_degradation_intensity(eval_tree["base"] / "absent.npz")
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], v, rtol=TOL, atol=TOL)


def test_port_written_checkpoint_reloads_and_plots(eval_tree, tmp_path):
    _, tr = pair(eval_tree)
    tr.load_checkpoint(eval_tree["ckpt"])
    path = str(tmp_path / "again.npz")
    tr.save_checkpoint(path)
    with np.load(path) as a, np.load(eval_tree["ckpt"]) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in b.files)
    tr2 = Training(eval_config(eval_tree, nomad_model_path=str(tmp_path / "m.npz")),
                   device="cpu", model_config=Wav2Vec2Config.tiny())
    tr2.eval_audio_quality(eval_tree["ckpt"], plot=True)
    tr2.eval_degr_level(eval_tree["ckpt"], plot=True)
    assert os.path.isfile(tmp_path / "dbA_embeddings.png")
    assert os.path.isfile(tmp_path / "validset_embeddings.png")
    # a .pt is read now (tests/test_torch_training.py); a missing one raises
    with pytest.raises(FileNotFoundError):
        tr2.load_checkpoint(str(tmp_path / "missing.pt"))


@pytest.mark.parametrize("n", [3, 6])
def test_metrics_match_jax(n):
    rng = np.random.default_rng(n)
    dist = rng.uniform(0.2, 1.5, n)
    mos = 5 - 2.5 * dist + 0.1 * rng.standard_normal(n)
    x = np.linspace(0.1, 2.0, 7)
    np.testing.assert_allclose(metrics.fit_order_three(dist, mos)(x),
                               jmetrics.fit_order_three(dist, mos)(x), rtol=1e-9)
    ours, theirs = metrics.correlation_report(dist, mos), jmetrics.correlation_report(dist, mos)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-12)
    assert metrics.srcc(dist, mos) == jmetrics.srcc(dist, mos)
    assert metrics.pcc(dist, mos) == jmetrics.pcc(dist, mos)
    np.testing.assert_allclose(metrics.order_three(x, 1, 2, 3, 4),
                               jmetrics.order_three(x, 1, 2, 3, 4))
