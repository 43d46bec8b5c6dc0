"""The port's triplet trainer against the JAX package's, on the CPU and
``tiny()``: the loss, the data pipeline, the freeze policy, one train step
with the dropout rates at 0, the LR schedule and early stop, and resume."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.api import _flatten
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
from nomad_tpu.training import Training as JaxTraining
from nomad_tpu.training import data as jdata
from nomad_tpu.training.losses import triplet_margin_loss as jax_triplet_margin_loss
from nomad_tpu.training.triplet import param_labels as jax_param_labels
from nomad_tpu_torch.convert import jax_name, jax_to_state_dict, state_dict_to_jax
from nomad_tpu_torch.convert.fairseq_synth import write_nomad_checkpoint
from nomad_tpu_torch.io import write_wav
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config, init_weights
from nomad_tpu_torch.training import Training, data, param_labels
from nomad_tpu_torch.training.losses import triplet_margin_loss

torch.set_num_threads(2)
EMB = 16
ZERO_RATES = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Seeded PCM16 WAVs of unequal lengths under OPUS/MP3/NOISE and a
    triplet CSV with two db levels, a duplicate row and a level-3 row."""
    base = tmp_path_factory.mktemp("triplets")
    root = base / "degraded"
    rng = np.random.default_rng(21)
    for kind in ("OPUS", "MP3", "NOISE"):
        (root / kind).mkdir(parents=True)
        for i in range(5):
            n = 1100 + 97 * i + (40 if kind == "MP3" else 0)
            write_wav(str(root / kind / f"f{i}.wav"),
                      (0.2 * rng.standard_normal(n)).astype(np.float32), 16000, bits=16)
    lines = ["db,Anchor,Positive,Negative,anc_pos_dist,anc_neg_dist"]
    for i in range(5):
        lines.append(f"{1 + i % 2},OPUS/f{i}.wav,MP3/f{i}.wav,NOISE/f{(i + 1) % 5}.wav,0.1,0.3")
    lines.append("1,OPUS/f0.wav,MP3/f0.wav,NOISE/f1.wav,0.1,0.3")  # duplicate of row 0
    lines.append("3,OPUS/f4.wav,MP3/f3.wav,NOISE/f2.wav,0.1,0.3")  # filtered out
    csv_path = base / "train.csv"
    csv_path.write_text("\n".join(lines) + "\n")
    return {"root": str(root) + "/", "csv": str(csv_path), "base": base}


def train_config(tree, **over):
    cfg = {
        "experiment_name": "Training", "root": tree["root"],
        "train_df": tree["csv"], "valid_df": tree["csv"],
        "train_bs": 2, "val_bs": 2, "lr": 1e-3, "lr_decay_factor": 0.5,
        "lr_decay_step": 2, "num_epochs": 2, "num_workers": 2, "emb_dim": EMB,
        "patience": 5, "margin": 0.2, "freeze_convnet": True, "freeze_all": False,
        "current_level": [1, 2], "trim": True, "masked_pool": True,
        "checkpoint_path": None, "checkpoint_backend": "npz",
    }
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def jax_params():
    params = JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB).init(
        jax.random.key(3), jnp.zeros((1, 800)), method=JaxNomadModel.init_all)
    return jax.tree_util.tree_map(np.asarray, params)


def test_triplet_margin_loss_and_gradient_match_jax():
    rng = np.random.default_rng(1)
    a, p, n = (rng.standard_normal((6, EMB)).astype(np.float32) for _ in range(3))
    p[0] = a[0]  # a == p: eps keeps the gradient finite
    jl, jg = jax.value_and_grad(jax_triplet_margin_loss, argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(p), jnp.asarray(n), 0.2)
    ts = [torch.from_numpy(x).requires_grad_() for x in (a, p, n)]
    loss = triplet_margin_loss(*ts, margin=0.2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-7)


def test_pad_group_and_int16_groups_match_jax():
    rng = np.random.default_rng(2)
    waves = [np.rint(rng.uniform(-1, 1, n) * 32767).astype(np.float32) / 32768 for n in (5, 9, 7)]
    for pad_to in (None, 12):
        ours, jours = data.pad_group(waves, pad_to), jdata.pad_group(waves, pad_to)
        np.testing.assert_array_equal(ours[0], jours[0])
        np.testing.assert_array_equal(ours[1], jours[1])
    grid = data.pad_group(waves)[0]
    off = grid + np.float32(1e-7)
    for batch in (grid, off):
        ours, theirs = data._group_i16(batch), jdata._group_i16(batch)
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
    assert data._group_i16(grid).dtype == np.int16 and data._group_i16(off).dtype == np.float32


def test_dataset_collate_and_loader_order_match_jax(tree):
    cfg = train_config(tree)
    ours = data.TripletDataset(cfg, "train_df", level=[1, 2])
    theirs = jdata.TripletDataset(cfg, "train_df", level=[1, 2])
    assert len(ours) == len(theirs) == 5  # the duplicate and the level-3 row dropped
    for i in range(len(ours)):
        assert ours.item_paths(i) == theirs.item_paths(i)
        assert ours.item_paths(i)[0] == tree["root"] + ours.rows[i]["Anchor"]  # Q9
    assert len(data.TripletDataset(cfg, "train_df", level=[2])) == 2
    items = [ours.load_item(i) for i in range(3)]
    for bucket in (True, False):
        b, jb = data.collate_triplets(items, bucket), jdata.collate_triplets(items, bucket)
        for f in dataclasses.fields(b):
            x, y = getattr(b, f.name), getattr(jb, f.name)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    assert data.collate_triplets(items).anchor.dtype == np.int16
    loader = data.TripletLoader(ours, 2, shuffle=True, seed=4, num_threads=2)
    jloader = jdata.TripletLoader(theirs, 2, shuffle=True, seed=4, num_threads=2)
    for _epoch in range(2):
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == 3
        for b, jb in zip(got, want):
            for f in dataclasses.fields(b):
                np.testing.assert_array_equal(getattr(b, f.name), getattr(jb, f.name))


def test_loader_hands_on_a_decode_error(tree, tmp_path):
    cfg = train_config(tree, root=str(tmp_path) + "/")  # no WAVs there
    loader = data.TripletLoader(data.TripletDataset(cfg, level=[1, 2]), 2, shuffle=False,
                                num_threads=2)
    with pytest.raises(OSError):
        list(loader)


@pytest.mark.parametrize("freeze_convnet,freeze_all", [(False, False), (True, False),
                                                       (True, True), (False, True)])
def test_param_groups_match_jax_labels(jax_params, freeze_convnet, freeze_all):
    tr = Training({"experiment_name": "quality_nmr", "emb_dim": EMB}, device="cpu",
                  params=jax_to_state_dict(jax_params), model_config=Wav2Vec2Config.tiny())
    ours = param_labels(tr.model, freeze_convnet, freeze_all)
    theirs = dict(_flatten(jax_param_labels(jax_params["params"], freeze_convnet, freeze_all)))
    shapes = {n: p.ndim for n, p in tr.model.named_parameters()}
    mapped = {n: str(theirs[jax_name(n, shapes[n])[0]]) for n in ours}
    assert ours == mapped
    assert {"head", "backbone", "frozen"} >= set(ours.values())


def _jax_training(tree, jax_params, **over):
    jcfg = JaxConfig.tiny(**ZERO_RATES)
    return JaxTraining(train_config(tree, **over), params=jax_params, model_config=jcfg)


@pytest.mark.parametrize("freeze_convnet", [True, False])
def test_one_train_step_matches_jax(tree, jax_params, freeze_convnet):
    """One step with the rates at 0: the same loss, and parameters within
    Adam's step-1 bounds (an entry whose gradient sits at f32 noise can
    move by ~lr·sign(g) the other way: max |Δ| < 2.5e-3 at lr 1e-3). The
    key projection's bias has an analytic gradient of 0 (softmax does not
    see a shift shared by every key), so in both frameworks its whole
    update is noise: it is held to the max bound alone, and its gradient
    to the noise level."""
    jtr = _jax_training(tree, jax_params, freeze_convnet=freeze_convnet)
    tr = Training(train_config(tree, freeze_convnet=freeze_convnet), device="cpu",
                  params=jax_to_state_dict(jax_params),
                  model_config=Wav2Vec2Config.tiny(**ZERO_RATES))
    assert tr.model_config.remat and jtr.model_config.remat
    assert tr.model_config.frontend_stop_gradient == freeze_convnet
    assert tr.lr_backbone == jtr.lr_backbone and tr.lr_head == jtr.lr_head
    ds = tr.train_set
    batch = data.collate_triplets([ds.load_item(i) for i in (0, 1, 3)])
    assert batch.anchor.dtype == np.int16 and len(set(batch.lengths_a.tolist())) > 1
    step = jtr._get_step(batch.anchor.shape, True)
    jparams, _, jloss = step(
        jtr.params, jtr.opt_state, *(jnp.asarray(getattr(batch, f.name))
                                     for f in dataclasses.fields(batch)),
        jnp.float32(jtr.lr_backbone), jnp.float32(jtr.lr_head), jax.random.key(0))
    before = state_dict_to_jax(tr.model.state_dict())
    loss = tr.train_step(batch, torch.Generator().manual_seed(0))
    assert abs(loss.item() - float(jloss)) <= 1e-5
    ours = state_dict_to_jax(tr.model.state_dict())
    theirs = _flatten(jax.device_get(jparams["params"]))
    assert sorted(ours) == sorted(theirs)
    grads = {n: p.grad for n, p in tr.model.named_parameters() if p.grad is not None}
    gmax = max(g.abs().max().item() for g in grads.values())
    for key, want in theirs.items():
        d = np.abs(ours[key] - want)
        assert d.max() < 2.5e-3, (key, d.max())
        if key.endswith("k_proj/bias"):
            noise = [g for n, g in grads.items() if n.endswith("k_proj.bias")]
            assert max(g.abs().max().item() for g in noise) < 1e-6 * gmax
        else:
            assert d.mean() < 5e-6, (key, d.mean())
        if key.startswith("lossnet_embedding") or (freeze_convnet and "feature_encoder" in key):
            np.testing.assert_array_equal(ours[key], before[key])  # frozen: untouched
        else:
            assert not np.array_equal(ours[key], before[key]), key


def test_remat_dots_step_equals_no_remat(tree, jax_params):
    """``remat_policy: dots`` (the selective checkpoint: products kept, the
    rest recomputed) against the step without remat, dropout on: the same
    loss and gradients within 1e-6; the JAX trainer takes the same key."""
    def step(**over):
        tr = Training(train_config(tree, **over), device="cpu",
                      params=jax_to_state_dict(jax_params), model_config=Wav2Vec2Config.tiny())
        batch = data.collate_triplets([tr.train_set.load_item(i) for i in (0, 1, 3)])
        loss = tr.train_step(batch, torch.Generator().manual_seed(0))
        return tr, loss.item(), {n: p.grad.clone() for n, p in tr.model.named_parameters()
                                 if p.grad is not None}

    tr, loss, grads = step(remat=True, remat_policy="dots")
    assert tr.model_config.remat and tr.model_config.remat_policy == "dots"
    assert tr.model_config.dropout > 0
    assert _jax_training(tree, jax_params, remat_policy="dots").model_config.remat_policy == "dots"
    plain, loss0, grads0 = step(remat=False)
    assert not plain.model_config.remat
    assert abs(loss - loss0) <= 1e-6
    assert grads.keys() == grads0.keys()
    for name, g in grads0.items():
        torch.testing.assert_close(grads[name], g, rtol=0, atol=1e-6, msg=name)


def test_lr_decay_and_early_stop_match_jax(tree, jax_params, tmp_path, monkeypatch):
    """Q10 and early stop over scripted validation losses: the same LRs
    per epoch, the same saves and the same last epoch as the JAX loop."""
    script = [1.0, 0.9, 0.95, 0.97, 0.99, 0.85, 0.9, 0.91, 0.92, 0.93, 0.94, 0.95]
    over = dict(lr_decay_step=2, patience=3, num_epochs=len(script), freeze_convnet=True)
    runs = []
    for make, name in ((lambda d: _jax_training(tree, jax_params, run_dir=d, **over), "jax"),
                       (lambda d: Training(train_config(tree, run_dir=d, **over), device="cpu",
                                           params=jax_to_state_dict(jax_params),
                                           model_config=Wav2Vec2Config.tiny()), "port")):
        tr = make(str(tmp_path / name))
        seen, saves = [], []
        losses = iter(script)
        monkeypatch.setattr(tr, "train", lambda rng_seed=0, tr=tr, seen=seen: (
            seen.append((rng_seed, tr.lr_backbone, tr.lr_head)), 0.0)[1])
        monkeypatch.setattr(tr, "eval", lambda: next(losses))
        real_save = tr.save_checkpoint
        monkeypatch.setattr(tr, "save_checkpoint", lambda p, real_save=real_save, saves=saves: (
            saves.append(len(saves)), real_save(p)))
        tr.training_loop()
        runs.append((seen, len(saves), tr.lr_backbone, tr.lr_head))
    assert runs[0] == runs[1]
    seen = runs[1][0]
    assert len(seen) < len(script) and seen[-1][1] < seen[0][1]  # stopped early, decayed


def _state(tr):
    params = {k: v.clone() for k, v in tr.model.state_dict().items()}
    opt = {i: {k: v.clone() for k, v in s.items()}
           for i, s in tr.optimizer.state_dict()["state"].items()}
    return params, opt, (tr.lr_backbone, tr.lr_head)


def test_resume_is_bit_exact(tree, jax_params, tmp_path):
    """Two epochs straight through, against one epoch, a new Training with
    resume, and the second: the same parameters, Adam state and LRs to the
    bit, with dropout on."""
    sd = jax_to_state_dict(jax_params)
    over = dict(lr_decay_step=1, lr_decay_factor=0.5)  # decay every epoch

    def run(run_dir, epochs, resume=False):
        tr = Training(train_config(tree, run_dir=str(run_dir), num_epochs=epochs,
                                   resume=resume, **over),
                      device="cpu", params=sd, model_config=Wav2Vec2Config.tiny())
        tr.training_loop()
        return tr

    straight = _state(run(tmp_path / "a", 2))
    first = run(tmp_path / "b", 1)
    resumed = Training(train_config(tree, run_dir=str(tmp_path / "b"), num_epochs=2,
                                    resume=True, **over),
                       device="cpu", params=sd, model_config=Wav2Vec2Config.tiny())
    assert resumed._load_resume_state()[2] == 1  # the next epoch
    after_one = _state(first)
    got = _state(resumed)
    assert got[2] == after_one[2]
    for k, v in after_one[0].items():
        assert torch.equal(got[0][k], v), k
    resumed.training_loop()
    got = _state(resumed)
    assert got[2] == straight[2]
    for k, v in straight[0].items():
        assert torch.equal(got[0][k], v), k
    assert got[1].keys() == straight[1].keys()
    for i, s in straight[1].items():
        for k, v in s.items():
            assert torch.equal(got[1][i][k], v), (i, k)
    assert os.path.isfile(tmp_path / "b" / "best_model.npz")


def test_load_checkpoint_reads_a_pt_as_the_jax_trainer_does(tree, jax_params, tmp_path):
    """``Training.load_checkpoint`` on a NOMAD-layout ``.pt`` (written by
    ``convert.fairseq_synth.write_nomad_checkpoint``): every tensor the
    file holds equals the JAX trainer's load of the same file, through
    the bridge (both compose the positional conv's weight norm in
    float64); the lossnet head, which the file lacks, keeps each package's
    seeded init (quirk Q7). An npz the trainer saved still loads."""
    src = init_weights(NomadModel(Wav2Vec2Config.tiny(), emb_dim=EMB), seed=7)
    with torch.no_grad():  # a positional conv whose norm is not 1 at every tap
        src.backbone.encoder.pos_conv.conv.weight.mul_(
            torch.linspace(0.5, 2.0, src.config.pos_conv_kernel))
    pt = str(tmp_path / "nomad_best_model.pt")
    write_nomad_checkpoint(src, pt)
    tr = Training(train_config(tree), device="cpu", params=jax_to_state_dict(jax_params),
                  model_config=Wav2Vec2Config.tiny(**ZERO_RATES))
    tr.load_checkpoint(pt)
    jtr = _jax_training(tree, jax_params)
    jtr.load_checkpoint(pt)
    ours = tr.model.state_dict()
    theirs = jax_to_state_dict(_flatten(jax.device_get(jtr.params["params"])))
    assert sorted(ours) == sorted(theirs)
    head = ("lossnet_embedding.weight", "lossnet_embedding.bias")
    seeded = init_weights(NomadModel(Wav2Vec2Config.tiny(), emb_dim=EMB), seed=0).state_dict()
    for k, v in ours.items():
        if k in head:
            assert torch.equal(v, seeded[k]), k
        else:
            assert torch.equal(v, theirs[k]), k
            assert torch.equal(v, src.state_dict()[k]) or k.endswith("pos_conv.conv.weight"), k
    npz = str(tmp_path / "saved.npz")
    tr.save_checkpoint(npz)
    again = Training(train_config(tree), device="cpu", params=seeded,
                     model_config=Wav2Vec2Config.tiny(**ZERO_RATES))
    again.load_checkpoint(npz)
    assert all(torch.equal(v, ours[k]) for k, v in again.model.state_dict().items())
