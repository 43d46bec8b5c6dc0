"""The port's config reader and experiment dispatcher
(``nomad_tpu_torch.main``), the weight bridge back to the JAX package, and
the entry points' refusals (no CPU fallback, the dropout loss)."""

import glob
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from nomad_tpu.api import _flatten
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
from nomad_tpu.training import Training as JaxTraining
from nomad_tpu_torch import main as dispatch
from nomad_tpu_torch.api import Nomad
from nomad_tpu_torch.convert import jax_to_state_dict, state_dict_to_jax
from nomad_tpu_torch.io import write_wav
from nomad_tpu_torch.models import Wav2Vec2Config
from nomad_tpu_torch.training import Training, triplet
from nomad_tpu_torch.utils import config as config_io

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(glob.glob(str(ROOT / "nomad_tpu" / "configs" / "*.yaml")))
EMB = 16


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_config_reader_equals_yaml_safe_load(path):
    ours = config_io.load(path)
    theirs = yaml.safe_load(open(path))
    assert ours == theirs
    assert all(type(ours[k]) is type(theirs[k]) for k in theirs)
    text = config_io.dumps(ours)
    assert config_io.loads(text) == ours == yaml.safe_load(text)


def test_config_dump_writes_every_key_of_the_se_recipe(tmp_path):
    recipe = config_io.load(str(ROOT / "nomad_tpu" / "configs" / "se_config.yaml"))
    path = str(tmp_path / "config.yaml")
    config_io.dump(recipe, path)
    back = config_io.load(path)
    assert back == recipe == yaml.safe_load(open(path))
    assert sorted(back) == sorted(yaml.safe_load(open(ROOT / "nomad_tpu" / "configs"
                                                      / "se_config.yaml")))


def test_config_reader_scalars_and_refusals():
    text = ("a: 1e-05\nb: 1.5e-05\nc: 'it''s # not a comment'\nd: x#y  # comment\n"
            "e: [1, \"a,b\", null, -2.5]\nf:\ng: ~\nh: .5\ni: off\nj:\n  - 1\n  -\n")
    assert config_io.loads(text) == yaml.safe_load(text)
    for bad in ("a: {b: 1}\n", "a:\n  b: 1\n", "- 1\n", "a: [1, 2\n", "a: 1\na: 2\n"):
        with pytest.raises(ValueError):
            config_io.loads(bad)
    with pytest.raises(TypeError):
        config_io.dumps({"a": {"b": 1}})


class FakeTraining:
    calls: list = []

    def __init__(self, config_file, device=None):
        self.calls.append(("init", config_file, device))

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name,) + args)


ROUTES = [("Training", "training_loop", ()), ("quality_nmr", "eval_audio_quality", ("m.npz",)),
          ("valid_rank", "eval_degr_level", ("m.npz",)),
          ("intensity", "eval_degradation_intensity", ("m.npz",)),
          ("quality_fr", "eval_full_reference", ("m.npz",))]
SCRIPTS = [None, "nomad_tpu.training.triplet", "src.training.train_triplet",
           "nomad_tpu_torch.training.triplet"]


@pytest.mark.parametrize("script", SCRIPTS)
@pytest.mark.parametrize("experiment,method,args", ROUTES, ids=[r[0] for r in ROUTES])
def test_dispatcher_routes_experiments_and_aliases(tmp_path, monkeypatch, script, experiment,
                                                   method, args):
    monkeypatch.setattr(triplet, "Training", FakeTraining)
    monkeypatch.setattr(FakeTraining, "calls", [])
    cfg = {"experiment_name": experiment, "nomad_model_path": "m.npz"}
    if script is not None:
        cfg["training_script"] = script
    path = str(tmp_path / "c.yaml")
    config_io.dump(cfg, path)
    dispatch.main(["--config_file", path, "--device", "cpu"])
    assert FakeTraining.calls == [("init", path, "cpu"), (method,) + args]


SMOKE_SCRIPTS = ["nomad_tpu.smoke", "src.nomad_ar.nomad_score_test",
                 "src.nomad_audio.nomad_score_test"]


@pytest.mark.parametrize("script", SMOKE_SCRIPTS)
def test_dispatcher_refuses_the_scripts_not_ported(tmp_path, monkeypatch, script):
    """The smoke scripts, once refused as not ported, now run the port's
    smoke runner with the config and the device, as the JAX dispatcher runs
    ``nomad_tpu.smoke.run(config)``; no script is refused any more."""
    from nomad_tpu_torch import smoke

    calls = []
    monkeypatch.setattr(smoke, "run", lambda config, device=None: calls.append((config, device)))
    cfg = {"experiment_name": "Test pip", "training_script": script}
    path = str(tmp_path / "c.yaml")
    config_io.dump(cfg, path)
    dispatch.run(path, device="cpu")
    assert calls == [(cfg, "cpu")]
    assert not hasattr(dispatch, "NOT_PORTED")


@pytest.mark.parametrize("script", ["nomad_tpu.training.se", "src.nomad_audio.nomad_loss_test"])
def test_dispatcher_runs_the_se_demo(tmp_path, monkeypatch, script):
    """The SE scripts train the port's Wave-U-Net for an epoch, tiny NOMAD,
    on the CPU: ``se_models/<time>/`` gets the config and the best model."""
    rng = np.random.default_rng(8)
    cfg = {"training_script": script, "experiment_name": "Test pip", "model_size": "tiny",
           "n_layers": 3, "num_epochs": 1, "train_bs": 2, "valid_bs": 2, "test_bs": 2,
           "lr": 1e-3, "nomad_weight": 0.001, "patience": 5, "test_every": 10,
           "loss_dropout": False}
    for split in ("train", "valid", "test"):
        for kind in ("noisy", "clean"):
            d = tmp_path / f"{kind}_{split}"
            d.mkdir()
            cfg[f"{kind}_{split}_dir"] = str(d)
        for i in range(2):
            clean = (0.2 * rng.standard_normal(9000)).astype(np.float32)
            write_wav(str(tmp_path / f"clean_{split}" / f"p{i}.wav"), clean, 16000, bits=16)
            write_wav(str(tmp_path / f"noisy_{split}" / f"p{i}.wav"),
                      clean + (0.05 * rng.standard_normal(9000)).astype(np.float32), 16000,
                      bits=16)
    path = str(tmp_path / "se.yaml")
    config_io.dump(cfg, path)
    monkeypatch.chdir(tmp_path)
    dispatch.run(path, device="cpu")
    runs = glob.glob(str(tmp_path / "se_models" / "*"))
    assert len(runs) == 1
    assert config_io.load(os.path.join(runs[0], "config.yaml")) == cfg
    with np.load(os.path.join(runs[0], "best_model.npz")) as best:
        assert "params/out_conv/kernel" in best.files and "batch_stats/middle/bn/var" in best.files


def test_dispatcher_unknown_experiment_runs_nothing(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(triplet, "Training", FakeTraining)
    monkeypatch.setattr(FakeTraining, "calls", [])
    path = str(tmp_path / "c.yaml")
    config_io.dump({"experiment_name": "banana"}, path)
    dispatch.run(path, device="cpu")
    assert FakeTraining.calls == [("init", path, "cpu")]
    assert "Unknown experiment_name 'banana'" in capsys.readouterr().err


def test_no_cpu_fallback_and_no_dropout_loss(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="InvalidRngError"):
        Nomad(device="cpu", config=Wav2Vec2Config.tiny(), emb_dim=EMB).loss_fn(
            torch.zeros(1, 800), torch.zeros(1, 800), deterministic=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {"experiment_name": "quality_nmr", "model_size": "tiny", "emb_dim": EMB}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Training(cfg)
    path = str(tmp_path / "c.yaml")
    config_io.dump(cfg, path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dispatch.main(["--config_file", path])
    # the training precisions run (tests/test_torch_grad_modes.py), fast_bf16's
    # bf16 activations too (tests/test_torch_fast_bf16.py); what it does not
    # port is refused, naming ROADMAP
    assert Training(dict(cfg, precision="fast"), device="cpu").model_config.encoder_prec == \
        "default"
    assert Training(dict(cfg, precision="fast_bf16"), device="cpu").model_config.block_dtype == \
        torch.bfloat16
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Training(dict(cfg, precision="fast_bf16"), device="cpu",
                 model_config=Wav2Vec2Config.tiny(encoder_dtype=torch.bfloat16))


def test_the_dispatcher_trains_end_to_end(tmp_path, monkeypatch):
    """Training through the dispatcher on a YAML file, tiny model, CPU."""
    rng = np.random.default_rng(3)
    root = tmp_path / "degraded"
    root.mkdir()
    for i in range(3):
        write_wav(str(root / f"f{i}.wav"), (0.2 * rng.standard_normal(900)).astype(np.float32),
                  16000, bits=16)
    (tmp_path / "t.csv").write_text("db,Anchor,Positive,Negative\n1,f0.wav,f1.wav,f2.wav\n"
                                    "1,f1.wav,f2.wav,f0.wav\n")
    cfg = {"experiment_name": "Training", "training_script": "src.training.train_triplet",
           "root": str(root) + "/", "train_df": str(tmp_path / "t.csv"),
           "valid_df": str(tmp_path / "t.csv"), "train_bs": 2, "val_bs": 2, "lr": 1e-3,
           "num_epochs": 1, "num_workers": 2, "emb_dim": EMB, "freeze_convnet": True,
           "current_level": [1], "trim": True, "model_size": "tiny",
           "run_dir": str(tmp_path / "run")}
    path = str(tmp_path / "train.yaml")
    config_io.dump(cfg, path)
    monkeypatch.chdir(tmp_path)
    dispatch.main(["--config_file", path, "--device", "cpu"])
    assert os.path.isfile(tmp_path / "run" / "best_model.npz")
    assert config_io.load(str(tmp_path / "run" / "config.yaml")) == cfg


@pytest.fixture(scope="module")
def jax_params():
    params = JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB).init(
        jax.random.key(7), jnp.zeros((1, 800)), method=JaxNomadModel.init_all)
    return jax.tree_util.tree_map(np.asarray, params)


def test_bridge_round_trip(jax_params):
    flat = _flatten(jax_params["params"])
    for p in (flat, jax_params):
        back = state_dict_to_jax(jax_to_state_dict(p))
        assert sorted(back) == sorted(flat)
        for k, v in flat.items():
            assert back[k].dtype == np.float32 and back[k].shape == v.shape
            np.testing.assert_array_equal(back[k], v)


def test_port_written_checkpoint_loads_into_jax_training(jax_params, tmp_path):
    rng = np.random.default_rng(5)
    names = []
    for i, n in enumerate((1300, 1800)):
        names.append(str(tmp_path / f"w{i}.wav"))
        write_wav(names[-1], (0.2 * rng.standard_normal(n)).astype(np.float32), 16000, bits=16)
    cfg = {"experiment_name": "quality_nmr", "emb_dim": EMB}
    tr = Training(cfg, device="cpu", params=jax_to_state_dict(jax_params),
                  model_config=Wav2Vec2Config.tiny())
    with torch.no_grad():  # move the weights off the JAX init, so the load shows
        for p in tr.model.parameters():
            p.add_(0.01)
    ckpt = str(tmp_path / "best_model.npz")
    tr.save_checkpoint(ckpt)
    jtr = JaxTraining(cfg, model_config=JaxConfig.tiny())
    jtr.load_checkpoint(ckpt)
    want = jtr.get_embeddings_csv(names).iloc[:, 1:].to_numpy()
    _, got = tr.get_embeddings_csv(names)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
