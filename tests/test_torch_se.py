"""The port's speech-enhancement demo (``nomad_tpu_torch.training.se``)
against the JAX package's, on the CPU: a Wave-U-Net of 3 levels, the tiny
NOMAD lossnet (16-wide embedding) on the same weights, seeded PCM16 pairs.
The paired data, one train step (loss, gradients, Adam, running
statistics), the eval step, ``enhance`` and ``loss_components``,
checkpoints both ways, the PESQ copy, the refusals, and learning."""

import jax
import numpy as np
import pytest
import torch

from nomad_tpu.api import Nomad as JaxNomad
from nomad_tpu.api import _flatten, _unflatten
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
from nomad_tpu.training import data as jdata
from nomad_tpu.training import se as jse_module
from nomad_tpu.utils import pesq as jpesq
from nomad_tpu_torch.api import Nomad
from nomad_tpu_torch.convert import jax_to_state_dict, waveunet_to_jax
from nomad_tpu_torch.io import write_wav
from nomad_tpu_torch.models import Wav2Vec2Config
from nomad_tpu_torch.training import PairedAudioDataset, SpeechEnhancement, se
from nomad_tpu_torch.utils import pesq

torch.set_num_threads(2)
SR, EMB, N_LAYERS, LR = 16000, 16, 3, 1e-3
# a conv ahead of a batch norm: BN removes any per-channel shift, so the
# analytic gradient of its bias is 0 and Adam's first step moves it by
# ~lr·sign(f32 noise) in either framework
PRE_BN_BIAS = tuple(f"params/{m}/conv/bias" for m in
                    [f"down_{i}" for i in range(N_LAYERS)] + ["middle"]
                    + [f"up_{i}" for i in range(N_LAYERS)])


def speech_like(rng, n):
    t = np.arange(n) / SR
    f0 = rng.uniform(100, 220) * (1 + 0.1 * np.sin(2 * np.pi * 3.1 * t))
    phase = np.cumsum(2 * np.pi * f0 / SR)
    x = sum(np.sin(k * phase) / k for k in range(1, 5))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(0.8, 2.0) * t), 0, 1)
    return (0.2 * x * env).astype(np.float32)


def write_pairs(base, split, count, rng, lengths=(20000, 12000)):
    """``count`` noisy/clean pairs, cropped (20,000) or padded (12,000) to
    16,384 samples by the dataset."""
    nd, cd = base / f"noisy_{split}", base / f"clean_{split}"
    nd.mkdir()
    cd.mkdir()
    for i in range(count):
        clean = speech_like(rng, lengths[i % len(lengths)])
        noisy = clean + (0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
        write_wav(str(cd / f"p{i}.wav"), clean, SR, bits=16)
        write_wav(str(nd / f"p{i}.wav"), noisy, SR, bits=16)
    return str(nd), str(cd)


@pytest.fixture(scope="module")
def se_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("valentini")
    rng = np.random.default_rng(0)
    return {split: write_pairs(base, split, 5, rng) for split in ("train", "valid", "test")}


def se_config(dirs, **over):
    cfg = {
        "noisy_train_dir": dirs["train"][0], "clean_train_dir": dirs["train"][1],
        "noisy_valid_dir": dirs["valid"][0], "clean_valid_dir": dirs["valid"][1],
        "noisy_test_dir": dirs["test"][0], "clean_test_dir": dirs["test"][1],
        "train_bs": 2, "valid_bs": 3, "test_bs": 3, "lr": LR, "nomad_weight": 0.001,
        "target_sr": SR, "patience": 3, "num_epochs": 1, "test_every": 1,
        "n_layers": N_LAYERS, "loss_dropout": False,
    }
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def jax_params():
    params = JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB).init(
        jax.random.key(0), np.zeros((1, 800), np.float32), method=JaxNomadModel.init_all)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def port_nomad(jax_params):
    return Nomad(device="cpu", config=Wav2Vec2Config.tiny(), emb_dim=EMB,
                 params=jax_to_state_dict(jax_params))


@pytest.fixture(scope="module")
def jax_se(se_dirs, jax_params):
    """The JAX SE on the same lossnet, and its U-Net init as a flat dict."""
    jse = jse_module.SpeechEnhancement(
        se_config(se_dirs), nomad=JaxNomad(config=JaxConfig.tiny(), emb_dim=EMB,
                                           params=jax_params))
    init = _flatten(jax.device_get({"params": jse.params, "batch_stats": jse.batch_stats}))
    return jse, init


def port_se(dirs, nomad, flat, **over) -> SpeechEnhancement:
    s = SpeechEnhancement(se_config(dirs, **over), device="cpu", nomad=nomad)
    s.load_flat(flat)
    return s


def first_batch(s):
    return next(s.train_set.batches(2, shuffle=False))


def test_paired_dataset_items_and_order_match_jax(se_dirs, tmp_path):
    ours = PairedAudioDataset(*se_dirs["train"])
    theirs = jdata.PairedAudioDataset(*se_dirs["train"])
    assert ours.noisy == theirs.noisy == [f"p{i}.wav" for i in range(5)]
    for i in range(len(ours)):
        for a, b in zip(ours.load_item(i), theirs.load_item(i)):
            assert a.shape == (PairedAudioDataset.FIXED_LEN,) and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for shuffle, seed in ((False, 0), (True, 0), (True, 1)):
        got = list(ours.batches(2, shuffle=shuffle, seed=seed))
        want = list(theirs.batches(2, shuffle=shuffle, seed=seed))
        assert [b[0].shape for b in got] == [(2, 16384), (2, 16384), (1, 16384)]
        for (n, c), (jn, jc) in zip(got, want, strict=True):
            np.testing.assert_array_equal(n, jn)
            np.testing.assert_array_equal(c, jc)
    (tmp_path / "noisy").mkdir()
    (tmp_path / "clean").mkdir()
    write_wav(str(tmp_path / "noisy" / "lonely.wav"), np.zeros(100, np.float32), SR, bits=16)
    with pytest.raises(AssertionError, match="clean file missing"):
        PairedAudioDataset(str(tmp_path / "noisy"), str(tmp_path / "clean")).load_item(0)


@pytest.mark.parametrize("weight,grad_tol", [(0.001, 1e-4), (10.0, 3e-4)])
def test_one_train_step_matches_jax(se_dirs, port_nomad, jax_se, weight, grad_tol):
    """The JAX step (``_get_step()``) against the port's ``train_step``:
    loss, parameters after Adam, running statistics; and ``jax.grad`` of
    its ``_loss`` against the port's gradients.

    Gradients: the JAX ones come op by op. Against an f64 run of the JAX
    loss (``scripts/se_precision_probe.py``, on its own pairs) the JAX
    package's f32 gradients stand 8.9e-5 (weight 0.001) and 3.2e-4
    (weight 10) of max|g| off, jitted 6.1e-4 and 3.6e-3, the port's 1.2e-6
    and 2.0e-6, with no L1 sign differing: held to 1e-4 and 3e-4 here (2.2e-4
    read at weight 10). The pre-BN conv biases (gradient 0 analytically)
    are held to the f32 residue of a sum over [B, T], below 5e-6 of max|g|
    (the probe reads 1.1e-6 for both packages at weight 10).

    Adam: the first step moves an entry by lr·g/(|g| + eps) ~ lr·sign(g).
    Where |g| is above 1e-3 of max|g| both frameworks take one sign, and the
    parameters agree to 1e-6; an entry closer to 0 may go either way (at
    most 2·lr apart), and the mean |Δ| over all parameters stays below
    5e-6."""
    jse, init = jax_se
    jse.nomad_weight, jse._step = weight, None
    noisy, clean = first_batch(jse)
    tree = _unflatten(init)
    args = (jse._nomad_params_dev(), noisy, clean, jax.random.key(0))
    jp, jbs, _, jloss = jse._get_step()(tree["params"], tree["batch_stats"],
                                        jse.tx.init(tree["params"]), *args)
    jgrads = jax.grad(jse._loss, has_aux=True)(tree["params"], tree["batch_stats"], *args)[0]
    ours = port_se(se_dirs, port_nomad, init, nomad_weight=weight)
    loss = ours.train_step(noisy, clean).item()
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))

    grads = waveunet_to_jax({n: p.grad for n, p in ours.unet.named_parameters()})
    want = _flatten({"params": jax.device_get(jgrads)})
    assert sorted(grads) == sorted(want)
    gmax = max(np.abs(g).max() for g in want.values())
    for key, g in want.items():
        if key in PRE_BN_BIAS:
            assert np.abs(grads[key]).max() < 5e-6 * gmax and np.abs(g).max() < 5e-6 * gmax
        else:
            assert np.abs(grads[key] - g).max() <= grad_tol * gmax, key

    after = waveunet_to_jax(ours.unet.state_dict())
    jafter = _flatten(jax.device_get({"params": jp, "batch_stats": jbs}))
    assert sorted(after) == sorted(jafter)
    total, count = 0.0, 0
    for key, value in jafter.items():
        d = np.abs(after[key] - value)
        if key.startswith("batch_stats/"):
            assert d.max() <= 1e-5, key
        elif key in PRE_BN_BIAS:
            for moved in (after[key], value):
                assert np.abs(moved - init[key]).max() <= LR * (1 + 1e-6), key
        else:
            settled = np.abs(want[key]) > 1e-3 * gmax
            assert settled.any() and d[settled].max() <= 1e-6, key
            assert d.max() <= 2 * LR * (1 + 1e-6), key
            total, count = total + d.sum(), count + d.size
        assert not np.array_equal(after[key], init[key]), key  # the step moved it
    assert total / count < 5e-6


def test_eval_step_enhance_and_loss_components_match_jax(se_dirs, port_nomad, jax_se):
    """After a port step (running statistics off 0/1), both packages on the
    same U-Net: the eval step and ``eval()``, ``enhance`` and
    ``loss_components``."""
    jse, init = jax_se
    ours = port_se(se_dirs, port_nomad, init)
    noisy, clean = first_batch(ours)
    ours.train_step(noisy, clean)
    tree = _unflatten(waveunet_to_jax(ours.unet.state_dict()))
    jse.params, jse.batch_stats = tree["params"], tree["batch_stats"]
    jse.nomad_weight, jse._eval_step = 0.001, None

    got = ours.eval_step(noisy, clean).item()
    want = float(jse._get_eval_step()(jse.params, jse.batch_stats, jse._nomad_params_dev(),
                                      noisy, clean))
    assert abs(got - want) <= 1e-5 * abs(want)
    got, want = ours.eval(), jse.eval()
    assert abs(got - want) <= 1e-5 * abs(want)
    est = ours.enhance(noisy[:, None, :])
    assert est.shape == (2, 1, 16384)
    np.testing.assert_allclose(est.numpy(), np.asarray(jse.enhance(noisy[:, None, :])),
                               rtol=0, atol=2e-5)
    for got, want in zip(ours.loss_components(), jse.loss_components(), strict=True):
        assert abs(got - want) <= 1e-5 * abs(want)


def test_checkpoints_load_both_ways(se_dirs, port_nomad, jax_se, tmp_path):
    jse, init = jax_se
    ours = port_se(se_dirs, port_nomad, init)
    noisy, clean = first_batch(ours)
    ours.train_step(noisy, clean)  # off the init, so a load shows
    ours.save(str(tmp_path / "port.npz"))
    jse.load(str(tmp_path / "port.npz"))
    np.testing.assert_allclose(ours.enhance(noisy).numpy(), np.asarray(jse.enhance(noisy)),
                               rtol=0, atol=2e-5)
    jse.save(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    back = port_se(se_dirs, port_nomad, init)
    back.load(str(tmp_path / "jax.npz"))
    for k, v in ours.unet.state_dict().items():
        assert torch.equal(back.unet.state_dict()[k], v), k
    assert torch.equal(back.enhance(noisy), ours.enhance(noisy))


def add_noise(x, snr_db, seed):
    n = np.random.default_rng(seed).standard_normal(x.shape)
    n *= np.sqrt(np.mean(x**2) / np.mean(n**2)) / 10 ** (snr_db / 20)
    return x + n


@pytest.mark.parametrize("snr", [0.0, 10.0, 25.0])
def test_pesq_copy_and_si_sdr_equal_the_jax_ones(snr):
    rng = np.random.default_rng(7)
    ref = np.stack([speech_like(rng, 2 * SR) for _ in range(2)]).astype(np.float64)
    deg = np.stack([add_noise(r, snr, seed=i) for i, r in enumerate(ref)])
    assert pesq.pesq_wb(ref[0], deg[0]) == jpesq.pesq_wb(ref[0], deg[0])
    np.testing.assert_array_equal(pesq.pesq_batch(SR, ref, deg, mode="wb"),
                                  jpesq.pesq_batch(SR, ref, deg, mode="wb"))
    assert se._try_pesq_batch(SR, ref, deg) == jse_module._try_pesq_batch(SR, ref, deg)
    assert se.si_sdr(deg, ref) == jse_module.si_sdr(deg, ref)


def test_refusals(se_dirs, monkeypatch):
    with pytest.raises(NotImplementedError, match="InvalidRngError"):
        SpeechEnhancement(se_config(se_dirs, loss_dropout=True), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpeechEnhancement(se_config(se_dirs))


def test_se_objective_falls_on_tiny_data(tmp_path, port_nomad):
    """Two epochs of the port's SE on 6 pairs at lr 1e-3: the validation
    objective (mse + nomad) falls below 0.7 of where it started (it reads
    0.47 here; at the JAX test's lr 3e-3 both packages overshoot on these
    pairs by the third epoch), and the test quality stays finite."""
    rng = np.random.default_rng(11)
    dirs = {}
    for split in ("train", "valid", "test"):
        nd, cd = tmp_path / f"noisy_{split}", tmp_path / f"clean_{split}"
        nd.mkdir()
        cd.mkdir()
        for i in range(6):
            clean = (0.3 * np.sin(2 * np.pi * (140 + 25 * i) * np.arange(17000) / SR)).astype(
                np.float32)
            noisy = clean + (0.1 * rng.standard_normal(17000)).astype(np.float32)
            write_wav(str(cd / f"p{i}.wav"), clean, SR)
            write_wav(str(nd / f"p{i}.wav"), noisy, SR)
        dirs[split] = (str(nd), str(cd))
    ours = SpeechEnhancement(se_config(dirs, train_bs=3, valid_bs=3, test_bs=3),
                             device="cpu", nomad=port_nomad)
    before = ours.eval()
    for epoch in range(2):
        ours.train(seed=epoch)
    after = ours.eval()
    assert after < 0.7 * before, (before, after)
    assert np.isfinite(ours.test()["value"])
