"""WavLM Large on the port's normal path (``Wav2Vec2Config.wavlm_large``):
at a tiny size on the CPU against the benchmark's plain reference
(``benchmark/reference/wavlm.py``) on seeded weights, the buckets, exact
masking, the refusals and the checkpoint guard; on the card (``cuda``
marker) K1r against its plain version. The file imports nothing of JAX:

    python -m pytest --noconftest tests/test_torch_wavlm.py
"""

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import wavlm as ref
from nomad_tpu_torch.api import Nomad, write_cache
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config, init_weights
from nomad_tpu_torch.models import wav2vec2
from nomad_tpu_torch.ops import attention, flash_attention

torch.set_num_threads(2)

EMB = 16
# the tiny WavLM: a layer-norm frontend of 3 convolutions, 2 pre-LN blocks
# of 4 heads of 16, 32 buckets (the last at the published 800 frames)
W = {"conv_dim": [32, 32, 32], "conv_kernel": [10, 3, 2], "conv_stride": [5, 2, 2],
     "conv_bias": False, "hidden_size": 64, "num_layers": 2, "num_heads": 4, "ffn_dim": 128,
     "pos_conv_kernel": 16, "pos_conv_groups": 4, "layer_norm_eps": 1e-5, "num_buckets": 32,
     "max_bucket_distance": 800}
# 6,000 samples give T' = 299 frames: offsets up to 298, far into the log
# scale that starts at 8 (buckets 8 .. 14 of each sign)
SAMPLES = 6000
# float32 on one CPU, the same operations in another order (the port's
# masks, layouts and pre-scaled q): the embeddings agree to a few ulps
# (6e-8 seen), the block outputs (values up to ~20) to ~4e-6
TOL_EMB, TOL_BLOCK = 1e-6, 2e-5


def tiny_config(**kw) -> Wav2Vec2Config:
    return Wav2Vec2Config.wavlm_large(**(dict(
        conv_dim=tuple(W["conv_dim"]), conv_kernel=tuple(W["conv_kernel"]),
        conv_stride=tuple(W["conv_stride"]), hidden_size=W["hidden_size"],
        num_layers=W["num_layers"], num_heads=W["num_heads"], ffn_dim=W["ffn_dim"],
        pos_conv_kernel=W["pos_conv_kernel"], pos_conv_groups=W["pos_conv_groups"],
        relative_position_buckets=W["num_buckets"]) | kw))


@pytest.fixture(scope="module")
def sd():
    return weights.seeded(ref.param_shapes(W, EMB), 3, "cpu")


@pytest.fixture(scope="module")
def waves():
    g = torch.Generator().manual_seed(0)
    clean = 0.1 * torch.randn(3, SAMPLES, generator=g)
    return clean, clean + 0.05 * torch.randn(3, SAMPLES, generator=g)


def _nomad(sd, **kw) -> Nomad:
    return Nomad(device="cpu", config=tiny_config(**kw), emb_dim=EMB, params=sd)


def test_wavlm_large_is_the_published_config():
    cfg = Wav2Vec2Config.wavlm_large()
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.ffn_dim) == (1024, 24, 16, 4096)
    assert (tuple(cfg.conv_dim), tuple(cfg.conv_kernel), tuple(cfg.conv_stride)) == (
        (512,) * 7, (10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2))
    assert (cfg.pos_conv_kernel, cfg.pos_conv_groups, cfg.layer_norm_eps) == (128, 16, 1e-5)
    assert (cfg.arch, cfg.relative_position_buckets) == ("wavlm", 320)
    assert wav2vec2.MAX_RELATIVE_DISTANCE == 800
    assert Wav2Vec2Config.base().arch == "wav2vec2"
    model = NomadModel(cfg, emb_dim=256)
    assert model.backbone.feature_encoder.conv_0.bias is None  # as the published config
    n = sum(p.numel() for p in model.parameters())
    assert 315e6 < n < 318e6  # ~316 M with both 1024 -> 256 heads


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_the_port_matches_the_reference(sd, waves, impl):
    clean, est = waves
    nomad = _nomad(sd, attention_impl=impl)
    with torch.no_grad():
        res = nomad.model.backbone(clean)
        outs, last = ref._encode(sd, W, clean)
        got, want = nomad.model(clean), ref.embed(sd, W, clean)
    assert float((got - want).abs().max()) < TOL_EMB
    assert len(res["layers"]) == len(outs) == W["num_layers"]
    for a, b in zip(res["layers"], outs):
        assert float((a - b).abs().max()) < TOL_BLOCK
    # the pooled x is the encoder's LayerNorm of the last block, not the block
    assert float((res["x"] - last).abs().max()) < TOL_BLOCK
    assert float((res["x"] - res["layers"][-1]).abs().max()) > 0.1
    x = est.clone().requires_grad_(True)
    loss = nomad.forward(x, clean)
    loss.backward()
    ref_loss, ref_grad = ref.loss_and_grad(sd, W, est, clean, rows=2)
    # a sum of 3 means of ~1e5 f32 terms each: a few ulps of the loss
    assert abs(float(loss.detach()) - ref_loss) <= 1e-6 * abs(ref_loss)
    # the gradient through 2 blocks, the frontend and the L1 signs (no
    # element within rounding of 0 at this seed): 5e-7 seen
    assert float((x.grad - ref_grad).norm() / ref_grad.norm()) < 1e-5


@pytest.mark.parametrize("buckets", [320, 32])
def test_buckets_equal_the_references(buckets):
    distance = wav2vec2.MAX_RELATIVE_DISTANCE
    delta = torch.arange(-4000, 4001)
    got = wav2vec2.relative_position_bucket(delta, buckets)
    want = ref.relative_position_bucket(delta, buckets, distance)
    assert torch.equal(got, want)
    half = buckets // 2
    assert got.min() == 0 and got.max() == buckets - 1
    assert int(got[4000]) == 0 and int(got[4001]) == half + 1 and int(got[3999]) == 1
    assert int(got[4000 + distance]) == buckets - 1 and int(got[4000 - distance]) == half - 1


def test_a_padded_batch_gives_batch_one_embeddings(sd, waves):
    clean, _ = waves
    nomad = _nomad(sd)
    lens = torch.tensor([SAMPLES, 4100, 2500])
    wav = clean.clone()
    for i, n in enumerate(lens):
        wav[i, n:] = 0.0
    with torch.no_grad():
        batch = nomad.model(wav, lens)
        one = torch.cat([nomad.model(wav[i:i + 1, :n]) for i, n in enumerate(lens)])
    # the same frames, keys and offsets; the padded rows' sums differ only
    # in their order (1.2e-7 seen)
    assert float((batch - one).abs().max()) < TOL_EMB


def _no_bias(nomad, monkeypatch):
    with torch.no_grad():
        nomad.model.backbone.encoder.layers[0].rel_attn_embed.weight.zero_()


def _gates_at_one(nomad, monkeypatch):
    monkeypatch.setattr(wav2vec2.EncoderLayer, "_gate",
                        lambda self, u: torch.ones(u.shape[0], self.config.num_heads,
                                                   u.shape[1]))


@pytest.mark.parametrize("break_it", [_no_bias, _gates_at_one], ids=["no_bias", "gates_at_1"])
def test_the_tolerance_sees_the_bias_and_its_gates(sd, waves, break_it, monkeypatch):
    """Without the bias, or with every gate 1, the embeddings leave the
    reference by at least 10x the tolerance the port is held to."""
    clean, _ = waves
    nomad = _nomad({k: v.clone() for k, v in sd.items()})
    break_it(nomad, monkeypatch)
    with torch.no_grad():
        gap = float((nomad.model(clean) - ref.embed(sd, W, clean)).abs().max())
    assert gap >= 10 * TOL_EMB, gap


def test_the_kernel_paths_gradients_match_plain_autograd():
    """``FlashAttentionRel`` (its backward recomputes the plain version)
    against autograd through ``mha_ref`` with the bias: dq, dk, dv, the
    gate's and the table's gradients."""
    g = torch.Generator().manual_seed(7)
    b, t, h, d = 2, 37, 3, 64
    q, k, v = (torch.randn(b, t, h, d, generator=g) for _ in range(3))
    gate = 1.0 + torch.rand(b, h, t, generator=g)
    table = 0.5 * torch.randn(h, 2 * t - 1, generator=g)
    lens = torch.tensor([t, 20], dtype=torch.int32)
    mask = torch.arange(t)[None, :] < lens[:, None].long()
    do = torch.randn(b, t, h, d, generator=g)
    out = []
    for path in ("kernel", "ref"):
        args = [x.clone().requires_grad_(True) for x in (q, k, v, gate, table)]
        o = attention.mha(*args[:3], key_mask=mask, impl=path, rel=tuple(args[3:]))
        out.append((o, torch.autograd.grad(o, args, do)))
    (o1, g1), (o2, g2) = out
    assert float((o1 - o2).detach().abs().max()) < 1e-5
    for a, b_ in zip(g1, g2):  # f32 sums of up to 37 keys in two orders
        assert float((a - b_).abs().max()) <= 1e-4 * max(1.0, float(b_.abs().max()))
    assert float(g1[3].abs().max()) > 0 and float(g1[4].abs().max()) > 0


@pytest.mark.parametrize("kw,match", [
    (dict(attention_impl="fused_qkv"), "fused_qkv"),
    (dict(attn_score_precision="default"), "K1r"),
    (dict(wav2vec2.BALANCED_ISLANDS), "K1r"),
    (dict(dtype=torch.bfloat16), "bfloat16"),
    (dict(encoder_dtype=torch.bfloat16), "bfloat16"),
    (dict(encoder_tail_start=1, encoder_tail_precision="default"), "K1r"),
    (dict(layerdrop=0.05), "layerdrop"),
], ids=["fused", "score_default", "balanced", "dtype_bf16", "encoder_dtype_bf16", "tail_default",
        "layerdrop"])
def test_refusals(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        tiny_config(**kw)


@pytest.mark.parametrize("kw", [dict(arch="hubert"), dict(relative_position_buckets=31),
                                dict(relative_position_buckets=2)], ids=["arch", "odd", "two"])
def test_bad_structure_values(kw):
    with pytest.raises(ValueError):
        tiny_config(**kw)


def test_the_plain_path_takes_every_island(sd, waves):
    clean, _ = waves
    nomad = Nomad(device="cpu", config=tiny_config(attention_impl="ref",
                                                   **wav2vec2.FAST_ISLANDS), emb_dim=EMB,
                  params=sd)
    with torch.no_grad():
        gap = float((nomad.model(clean) - ref.embed(sd, W, clean)).abs().max())
    assert 0 < gap < 0.05  # bf16 products: far from exact, still the model


def test_a_base_checkpoint_is_refused(sd, tmp_path):
    base = init_weights(NomadModel(Wav2Vec2Config.tiny(), emb_dim=EMB), seed=1)
    write_cache(str(tmp_path / "nomad_tpu_params.npz"), base.state_dict())
    wavlm = Nomad(device="cpu", config=tiny_config(), emb_dim=EMB, weights_dir=str(tmp_path))
    with pytest.raises(ValueError, match="wav2vec 2.0 BASE"):
        wavlm.model  # noqa: B018
    # the BASE config still reads it, and params= still serves WavLM
    assert Nomad(device="cpu", config=Wav2Vec2Config.tiny(), emb_dim=EMB,
                 weights_dir=str(tmp_path)).model is not None
    assert Nomad(device="cpu", config=tiny_config(), emb_dim=EMB, params=sd,
                 weights_dir=str(tmp_path)).model is not None


def test_predict_scores_a_directory(sd, tmp_path):
    from nomad_tpu_torch.io import write_wav

    rng = np.random.default_rng(4)
    for d, n in (("nmr", 2), ("deg", 3)):
        (tmp_path / d).mkdir()
        for i in range(n):
            write_wav(str(tmp_path / d / f"{d}{i}.wav"),
                      0.2 * rng.standard_normal(int(16000 * rng.uniform(0.3, 0.6))), 16000)
    nomad = _nomad(sd)
    avg, dm = nomad.predict("dir", str(tmp_path / "nmr"), str(tmp_path / "deg"))
    assert dm.values.shape == (3, 2) and np.isfinite(dm.values).all()
    from nomad_tpu_torch.io import read_wav

    paths = sorted(str(p) for p in (tmp_path / "deg").iterdir())
    for p in paths:
        x, _ = read_wav(p)
        with torch.no_grad():
            want = ref.embed(sd, W, torch.from_numpy(np.asarray(x, np.float32)))
        got = torch.from_numpy(nomad.engine.embed_files([p]))
        assert float((got - want).abs().max()) < TOL_EMB


# ---------------- on the card ----------------


@pytest.fixture
def cuda():
    """The card with TF32 off ("exact"), the global flags put back after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1r runs only there")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _rel_inputs(b, t, h, lengths, seed, dev):
    g = torch.Generator().manual_seed(seed)
    q, k, v = torch.randn(b, t, 3, h, 64, generator=g).to(dev).unbind(2)
    gate = (1.0 + 2.0 * torch.rand(b, h, t, generator=g)).to(dev)
    table = (0.3 * torch.randn(h, 2 * t - 1, generator=g)).to(dev)
    return q, k, v, gate, table, torch.tensor(lengths, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("t,lengths", [(50, [50, 31, 1, 0]), (499, [499, 300, 64]),
                                       (1023, [1023, 1000]), (2000, [2000, 1357])])
def test_k1r_matches_its_plain_version(cuda, t, lengths):
    q, k, v, gate, table, lens = _rel_inputs(len(lengths), t, 4, lengths, t, cuda)
    before = (flash_attention.launches_rel, flash_attention.launches)
    o, lse = flash_attention.mha_flash_rel(q, k, v, gate, table, lens)
    torch.cuda.synchronize()
    assert (flash_attention.launches_rel, flash_attention.launches) == (before[0] + 1, before[1])
    ro, rlse = flash_attention.flash_attention_ref(
        q, k, v, lens, bias=flash_attention.relative_bias(gate, table))
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    # K1's tolerance: f32 sums of 64 products and of up to 2,000 keys in
    # the kernel's order against cuBLAS's
    torch.testing.assert_close(o, ro, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=2e-5, rtol=0)


@pytest.mark.cuda
def test_k1r_without_a_bias_gives_k1s_bits(cuda):
    q, k, v, gate, table, lens = _rel_inputs(3, 511, 12, [511, 200, 0], 1, cuda)
    o, lse = flash_attention.mha_flash_rel(q, k, v, torch.zeros_like(gate),
                                           torch.zeros_like(table), lens)
    o1, lse1 = flash_attention.mha_flash(q, k, v, lens)
    assert torch.equal(o, o1) and torch.equal(lse, lse1)


@pytest.mark.cuda
def test_k1r_occupancy(cuda):
    assert flash_attention.flash_rel_occupancy() == flash_attention.flash_occupancy() == 3


@pytest.mark.cuda
def test_the_model_on_the_card_matches_the_reference(cuda, sd, waves):
    """Tiny widths but 64-wide heads, so that K1r runs: 2 heads of 64."""
    w = W | {"hidden_size": 128, "num_heads": 2}
    sdc = weights.seeded(ref.param_shapes(w, EMB), 5, cuda)
    cfg = tiny_config(hidden_size=128, num_heads=2)
    nomad = Nomad(device="cuda", config=cfg, emb_dim=EMB, params=sdc)
    clean = waves[0].to(cuda)
    before = flash_attention.launches_rel
    with torch.no_grad():
        got = nomad.model(clean)
        want = ref.embed(sdc, w, clean)
    assert flash_attention.launches_rel == before + w["num_layers"]
    assert float((got - want).abs().max()) < 1e-5


@pytest.mark.cuda
def test_the_loss_and_its_gradient_on_the_card_match_the_reference(cuda, waves):
    """``Nomad.forward`` with gradients on the card: K1r a block in the
    forward, ``FlashAttentionRel``'s backward (the plain recompute) in the
    backward, at tiny widths with 64-wide heads; against the reference's
    loss and gradient on the card."""
    w = W | {"hidden_size": 128, "num_heads": 2}
    sdc = weights.seeded(ref.param_shapes(w, EMB), 5, cuda)
    nomad = Nomad(device="cuda", config=tiny_config(hidden_size=128, num_heads=2), emb_dim=EMB,
                  params=sdc)
    clean, est = (x.to(cuda) for x in waves)
    before = (flash_attention.launches_rel, flash_attention.launches)
    x = est.clone().requires_grad_(True)
    loss = nomad.forward(x, clean)
    loss.backward()
    # two forwards (estimate and clean) of 2 blocks each, no K1
    assert (flash_attention.launches_rel, flash_attention.launches) == (
        before[0] + 2 * w["num_layers"], before[1])
    ref_loss, ref_grad = ref.loss_and_grad(sdc, w, est, clean, rows=2)
    # the CPU test's tolerances: the same f32 sums in another order
    assert abs(float(loss.detach()) - ref_loss) <= 1e-6 * abs(ref_loss)
    assert float((x.grad - ref_grad).norm() / ref_grad.norm()) < 1e-5
