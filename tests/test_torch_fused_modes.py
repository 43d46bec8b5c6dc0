"""The projection-fused path at a "default" encoder island (K4b's plain
version on the CPU) against a float64 emulation of one bf16 pass, the
port's unfused "default" composition and the JAX package.

Seeded numpy inputs go through both sides. On the JAX side the fused
kernel runs in interpret mode at ``mode="default"``; XLA on the CPU
computes its products in f32 (it ignores dot precision), so the port,
which rounds, is held to it at a mode tolerance measured here. The
port's plain K4b rounds the operands of all five products to bf16
(``precision.round_bf16``): against the emulation, and against
``precision.linear`` + ``flash_attention_ref(precision="default")``, it
differs only by f32 summation order. Inputs of the unit class (bf16
values whose products sum exactly in f32) keep the projections exact, so
the only rounding that f32 order can move is that of p, and rows where a
p lies near a bf16 rounding midpoint are left out (and must be few), as
in ``test_torch_precision.py``. K4b itself is held to this plain version
on the card (``test_torch_cuda.py``, ``chip_smoke.py`` phase 12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.api import Nomad as JaxNomad
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
from nomad_tpu.ops import fused_attention as jfa
from nomad_tpu_torch.api import Nomad
from nomad_tpu_torch.convert import jax_to_state_dict
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config
from nomad_tpu_torch.models.wav2vec2 import PRECISION_ISLANDS
from nomad_tpu_torch.ops import attention, flash_attention, fused_attention, precision

torch.set_num_threads(2)

H, DM = 2, 128  # K4's head width, 64
EMB = 16
LENGTHS = [1900, 1333, 800]
FAST = PRECISION_ISLANDS["fast"]


def bf16_np(x):
    """x (float32) rounded to the nearest bfloat16, ties to even, by bit
    manipulation, returned as float64."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def unit_class(rng, shape, scale=1.0):
    """Magnitudes in [0.5, 1) times a power of two, random signs: after
    rounding to bf16 each is a multiple of 2^-8 scale, so the f32 sums of
    the projections' 128 products are exact."""
    x = rng.uniform(0.5, 1.0, shape) * rng.choice([-1.0, 1.0], shape) * scale
    return x.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _inputs(seed, b, t):
    """x, four (w [out, in], bias) pairs (q, k, v, out) in the unit class;
    the weights at 2^-4 keep the scores near unit scale."""
    rng = np.random.default_rng(seed)
    x = unit_class(rng, (b, t, DM))
    ws = [unit_class(rng, (DM, DM), 2.0**-4) for _ in range(4)]
    bs = [unit_class(rng, (DM,), 2.0**-4) for _ in range(4)]
    return x, ws, bs


def _port_params(ws, bs):
    return [a for w, b in zip(ws, bs) for a in (_t(w), _t(b))]


def _jax_params(ws, bs):
    """The port's (w [out, in], b) -> JAX's wq, bq, ..., wo, bo with w [in, out]."""
    return [a for w, b in zip(ws, bs) for a in (w.T, b)]


def emulate(x, ws, bs, lengths):
    """K4b's arithmetic in float64 on numpy: each projection the exact sum
    of the bf16 operands' products, its bias added in f32 (the sum is
    exact in f32, so that add rounds as the port's does), q times 1/8;
    s = bf16(q) . bf16(k) over the valid keys, p = exp(s - m),
    O = bf16(p) . bf16(v) / sum(p). Returns O head-major [B, H, T, 64] and
    the rows [B, H, T] whose every p lies clear of a bf16 rounding
    midpoint (1e-6 relative)."""
    b, t, _ = x.shape
    hd = DM // H
    proj = []
    for w, bias, scale in zip(ws[:3], bs[:3], (0.125, 1.0, 1.0)):
        y = (bf16_np(x) @ bf16_np(w).T).astype(np.float32) + bias
        proj.append(bf16_np(y * np.float32(scale)).reshape(b, t, H, hd).transpose(0, 2, 1, 3))
    q, k, v = proj
    o = np.zeros((b, H, t, hd))
    clear = np.ones((b, H, t), bool)
    for i, n in enumerate(lengths):
        if n == 0:
            continue
        s = q[i] @ k[i, :, :n].transpose(0, 2, 1)
        p = np.exp(s - s.max(axis=-1, keepdims=True))
        o[i] = (bf16_np(p.astype(np.float32)) @ v[i, :, :n]) / p.sum(axis=-1, keepdims=True)
        lo = bf16_np((p * (1 - 1e-6)).astype(np.float32))
        hi = bf16_np((p * (1 + 1e-6)).astype(np.float32))
        clear[i] = (lo == hi).all(axis=-1)
    return o, clear


# ---------------- (a) the plain K4b against its float64 emulation ----------------


@pytest.mark.parametrize("t,lengths", [(50, [50, 31, 1, 0]), (130, [130, 65, 64])])
def test_plain_k4b_matches_emulation(t, lengths):
    x, ws, bs = _inputs(t, len(lengths), t)
    before = fused_attention.launches_bf16
    o = fused_attention.fused_qkv_mha(_t(x), *_port_params(ws[:3], bs[:3]),
                                      torch.tensor(lengths, dtype=torch.int32), H,
                                      "default").numpy()
    assert fused_attention.launches_bf16 == before  # no kernel on the CPU
    emu, clear = emulate(x, ws, bs, lengths)
    scale = np.abs(emu).max()
    diff = np.abs(o - emu).max(axis=-1)  # [B, H, T]
    assert (diff[clear] <= 1e-6 * scale).all(), diff[clear].max() / scale
    assert clear.sum() >= 0.9 * clear.size, clear.sum()
    for i, n in enumerate(lengths):
        if n == 0:
            assert not o[i].any()  # no key: O = 0
    o32 = fused_attention.fused_qkv_mha(_t(x), *_port_params(ws[:3], bs[:3]),
                                        torch.tensor(lengths, dtype=torch.int32), H).numpy()
    assert np.abs(o32 - o).max() > 1e-4 * scale  # the f32 flavour differs: it rounds


# ---------------- (b) against the JAX kernel at mode "default" ----------------

# the port's "default" sublayer vs JAX's interpreted kernel at "default",
# which XLA's CPU computes in f32: measured 3.24e-3 of max|out| on these
# inputs (the unfused route past MAX_FUSED_T, (f): 2.28e-3); ~2.5x the larger
TOL_SUBLAYER_VS_JAX = 8e-3


def test_plain_k4b_sublayer_matches_jax_default_mode():
    t, lengths = 200, [200, 137]
    x, ws, bs = _inputs(7, len(lengths), t)
    key_mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    theirs = np.asarray(jfa.fused_qkv_attention(
        x, *_jax_params(ws, bs), key_mask=key_mask, heads=H, mode="default", interpret=True))
    ours = fused_attention.fused_qkv_attention(
        _t(x), *_port_params(ws, bs), key_mask=_t(key_mask), heads=H,
        precision="default").numpy()
    f32 = fused_attention.fused_qkv_attention(
        _t(x), *_port_params(ws, bs), key_mask=_t(key_mask), heads=H).numpy()
    scale = np.abs(theirs).max()
    np.testing.assert_allclose(f32, theirs, atol=2e-5 * scale, rtol=0)  # XLA's CPU: f32
    assert np.abs(ours - f32).max() > 1e-5 * scale  # the port rounds
    assert np.abs(ours - theirs).max() <= TOL_SUBLAYER_VS_JAX * scale, \
        np.abs(ours - theirs).max() / scale


# ---------------- (b2) K4b's prologue: the packed weights ----------------


def test_packed_weights_are_jax_per_head_w_rounded(monkeypatch):
    """K4b's prologue packs the weights as the JAX package hands them to
    its kernel: ``per_head_w`` ([H, D, hd] column slices of the [in, out]
    weights) of q, k and v, each head's slice transposed and the three
    stacked per head, then rounded to bf16 (ties to even), bit for bit.
    ``pack_weights_ref`` is the plain version; the card holds the
    kernel's prologue to it (``test_torch_cuda.py``, ``chip_smoke.py``)."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 40, DM)).astype(np.float32)
    ws = [rng.standard_normal((DM, DM)).astype(np.float32) for _ in range(4)]
    bs = [rng.standard_normal(DM).astype(np.float32) for _ in range(4)]
    seen = {}

    def capture(xp, wq, wk, wv, bq, bk, bv, lengths, heads, block_q, mode, interpret):
        seen["w"] = [np.asarray(w) for w in (wq, wk, wv)]
        return jnp.zeros((xp.shape[0], heads, xp.shape[1], DM // heads), xp.dtype)

    monkeypatch.setattr(jfa, "_fused_call", capture)
    jfa._fused_fwd_impl(x, *_jax_params(ws, bs), None, H, "default", True)
    per_head = np.stack(seen["w"], axis=1)  # [H, 3, D, hd]
    want = bf16_np(per_head.transpose(0, 1, 3, 2).reshape(H * 3 * (DM // H), DM))
    got = fused_attention.pack_weights_ref(*(_t(w) for w in ws[:3]), H)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert np.array_equal(got.double().numpy(), want)


# ---------------- (c) the identity: fused = precision.linear + K1b's plain version ----------------


def test_plain_k4b_equals_the_unfused_default_composition():
    """K4b computes what the unfused "fast" path computes: the three
    ``precision.linear`` projections at "default", then K1b. The plain
    versions differ only in f32 summation order (exact here for the
    projections), held on the rows whose p round clear of a midpoint."""
    t, lengths = 150, [150, 77, 1]
    x, ws, bs = _inputs(9, len(lengths), t)
    lens = torch.tensor(lengths, dtype=torch.int32)
    fused = fused_attention.fused_qkv_mha(_t(x), *_port_params(ws[:3], bs[:3]), lens, H,
                                          "default").numpy()
    q, k, v = (precision.linear(_t(x), _t(w), _t(b), "default").view(len(lengths), t, H, 64)
               for w, b in zip(ws[:3], bs[:3]))
    unfused = flash_attention.flash_attention_ref(q, k, v, lens, "default")[0]
    unfused = unfused.transpose(1, 2).numpy()
    _, clear = emulate(x, ws, bs, lengths)
    scale = np.abs(unfused).max()
    diff = np.abs(fused - unfused).max(axis=-1)
    assert (diff[clear] <= 1e-6 * scale).all(), diff[clear].max() / scale
    assert clear.sum() >= 0.9 * clear.size


# ---------------- (d) gradients ----------------

# d/dx and d/dW of <out, r> at "default" vs jax.grad through the JAX
# custom_vjp (f32 on the CPU): measured 4.2e-3 (x), 4.9e-3, 5.1e-3 and
# 2.8e-3 (wq, wk, wv) of max|g|; ~3x the largest. Against the port's
# unfused "default" autograd: measured 0 (the same products, summed in the
# same order)
TOL_GRAD_VS_JAX = 1.5e-2


def test_gradients_at_default_match_jax_and_the_unfused_autograd():
    t, lengths = 120, [120, 70]
    x, ws, bs = _inputs(13, len(lengths), t)
    key_mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    r = np.random.default_rng(14).standard_normal((len(lengths), t, DM)).astype(np.float32)
    names = ("x", "wq", "wk", "wv")

    def jax_loss(x_, wq, wk, wv):
        jw = _jax_params(ws, bs)
        return jnp.sum(r * jfa.fused_qkv_attention(
            x_, wq, jw[1], wk, jw[3], wv, jw[5], jw[6], jw[7], key_mask=key_mask, heads=H,
            mode="default", interpret=True))

    jg = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(x, ws[0].T, ws[1].T, ws[2].T)
    jg = [np.asarray(jg[0])] + [np.asarray(g).T for g in jg[1:]]

    def port_grads(sublayer):
        xt = _t(x).requires_grad_()
        params = _port_params(ws, bs)
        for i in (0, 2, 4):
            params[i].requires_grad_()
        out = sublayer(xt, params)
        (out * _t(r)).sum().backward()
        return [xt.grad.numpy()] + [params[i].grad.numpy() for i in (0, 2, 4)]

    fused = port_grads(lambda xt, p: fused_attention.fused_qkv_attention(
        xt, *p, key_mask=_t(key_mask), heads=H, precision="default"))

    def unfused_sublayer(xt, p):
        b = xt.shape[0]
        q, k, v = (precision.linear(xt, p[i], p[i + 1], "default").view(b, t, H, 64)
                   for i in (0, 2, 4))
        a = attention.mha(q, k, v, key_mask=_t(key_mask), impl="kernel", precision="default")
        return precision.linear(a.reshape(b, t, DM), p[6], p[7], "default")

    unfused = port_grads(unfused_sublayer)
    for name, ours, plain, theirs in zip(names, fused, unfused, jg):
        scale = np.abs(theirs).max()
        # the backward recomputes through the unfused composition: the same
        # products of the same operands, summed in the same order
        np.testing.assert_allclose(ours, plain, atol=1e-6 * scale, rtol=0, err_msg=name)
        assert np.abs(ours - theirs).max() <= TOL_GRAD_VS_JAX * scale, \
            (name, np.abs(ours - theirs).max() / scale)


# ---------------- (e) the tiny model in "fast" with fused_qkv ----------------

# the port's "fast" fused model vs the JAX package's same config (f32 on
# the CPU): embeddings measured 1.30e-3; the loss 2.1e-5 relative and its
# gradient, under the port's L1 signs, 1.9e-3 of max|g|: ~3x each
TOL_EMB_VS_JAX, TOL_LOSS_VS_JAX, TOL_LOSS_GRAD_VS_JAX = 4e-3, 6e-5, 6e-3
# against the port's own "fast" kernel path (unfused): the same roundings
# of the same operands; embeddings and loss measured 0. The input
# gradient 1.5e-4 of max|g|: the fused backward sums x's three projection
# gradients before the residual's, autograd in another order, and the
# bf16-rounded cotangents of the blocks below carry that f32 difference
# on; ~3x
TOL_EMB_VS_KERNEL_PATH, TOL_GRAD_VS_KERNEL_PATH = 1e-6, 5e-4


@pytest.fixture(scope="module")
def bridged():
    jcfg = JaxConfig.tiny(attention_impl="fused_qkv", **FAST)
    rng = np.random.default_rng(15)
    wav = np.zeros((len(LENGTHS), max(LENGTHS)), np.float32)
    for i, n in enumerate(LENGTHS):
        wav[i, :n] = 0.3 * rng.standard_normal(n)
    params = JaxNomadModel(jcfg, emb_dim=EMB).init(
        jax.random.key(2), jnp.asarray(wav[:1, :800]), method=JaxNomadModel.init_all)
    params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, jax_to_state_dict(params), wav


def _embed(sd, cfg, wav, lengths):
    model = NomadModel(cfg, emb_dim=EMB)
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        return model.eval()(_t(wav), _t(lengths).long()).numpy()


def test_fast_fused_model_matches_jax_and_the_kernel_path(bridged):
    jcfg, params, sd, wav = bridged
    lengths = np.asarray(LENGTHS, np.int32)
    theirs = np.asarray(JaxNomadModel(jcfg, emb_dim=EMB).apply(
        params, jnp.asarray(wav), jnp.asarray(lengths)))
    before = fused_attention.launches_bf16
    ours = _embed(sd, Wav2Vec2Config.tiny(attention_impl="fused_qkv", **FAST), wav, lengths)
    assert fused_attention.launches_bf16 == before
    kernel_path = _embed(sd, Wav2Vec2Config.tiny(**FAST), wav, lengths)
    exact = _embed(sd, Wav2Vec2Config.tiny(attention_impl="fused_qkv"), wav, lengths)
    assert np.isfinite(ours).all()
    assert np.abs(ours - exact).max() > 1e-5  # the port rounds
    assert np.abs(ours - theirs).max() <= TOL_EMB_VS_JAX, np.abs(ours - theirs).max()
    assert np.abs(ours - kernel_path).max() <= TOL_EMB_VS_KERNEL_PATH, \
        np.abs(ours - kernel_path).max()


def test_fast_fused_loss_and_gradient_match_jax_and_the_kernel_path(bridged):
    """``Nomad.forward(est, clean)`` and its gradient on the fused "fast"
    path against the JAX ``Nomad`` of the same config, the gradient under
    one L1 sign pattern, the port's (an element of a layer difference
    within rounding of 0 takes either sign), as
    ``test_torch_grad_modes.py`` holds the modes; and against the port's
    own "fast" kernel path."""
    jcfg, params, sd, _ = bridged
    rng = np.random.default_rng(16)
    clean = (0.3 * rng.standard_normal((2, 1600))).astype(np.float32)
    est = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    results = {}
    for name, cfg in (("fused", Wav2Vec2Config.tiny(attention_impl="fused_qkv", **FAST)),
                      ("kernel", Wav2Vec2Config.tiny(**FAST))):
        nomad = Nomad(device="cpu", config=cfg, emb_dim=EMB, params=sd)
        e = _t(est).requires_grad_()
        loss = nomad.forward(e, _t(clean))
        loss.backward()
        results[name] = (loss.item(), e.grad.numpy(), nomad)
        assert nomad.forward(_t(clean).requires_grad_(), _t(clean)).item() == 0.0
    loss, grad, nomad = results["fused"]
    assert grad.shape == est.shape and np.isfinite(grad).all()
    with torch.no_grad():
        signs = [torch.sign(a - c).numpy() for a, c in zip(
            nomad.model.forward_layers(_t(est)), nomad.model.forward_layers(_t(clean)))]
    jn = JaxNomad(device="cpu", config=jcfg, emb_dim=EMB, params=params)
    jloss = float(jn.loss_fn(jnp.asarray(est), jnp.asarray(clean)))
    ref = jn.model.apply(params, jnp.asarray(clean), method=JaxNomadModel.forward_layers)

    def signed(x):
        layers = jn.model.apply(params, x, method=JaxNomadModel.forward_layers)
        return sum((s * (a - c)).mean() for s, a, c in zip(signs, layers, ref))

    jgrad = np.asarray(jax.grad(signed)(jnp.asarray(est)))
    rel_loss = abs(loss - jloss) / abs(jloss)
    rel_grad = np.abs(grad - jgrad).max() / np.abs(jgrad).max()
    k_loss, k_grad, _ = results["kernel"]
    rel_k = np.abs(grad - k_grad).max() / np.abs(k_grad).max()
    assert rel_loss <= TOL_LOSS_VS_JAX, rel_loss
    assert rel_grad <= TOL_LOSS_GRAD_VS_JAX, rel_grad
    assert abs(loss - k_loss) <= TOL_EMB_VS_KERNEL_PATH * abs(k_loss)
    assert rel_k <= TOL_GRAD_VS_KERNEL_PATH, rel_k


@pytest.mark.parametrize("mode,want", [("exact", "high"), ("balanced", "high"),
                                       ("fast", "default")])
def test_fused_kernel_takes_the_projections_island(bridged, monkeypatch, mode, want):
    """The fused sublayer runs at ``encoder_prec``, never at
    ``attn_score_prec``, as the JAX package's fused kernel has one mode
    from ``attn_prec``: "balanced" (attention products at "default",
    projections at "high") keeps the f32 K4, "fast" takes K4b."""
    from nomad_tpu_torch.models import wav2vec2

    _, _, sd, wav = bridged
    seen = []
    real = wav2vec2.fused_qkv_attention

    def spy(*args, precision, **kw):
        seen.append(precision)
        return real(*args, precision=precision, **kw)

    monkeypatch.setattr(wav2vec2, "fused_qkv_attention", spy)
    cfg = Wav2Vec2Config.tiny(attention_impl="fused_qkv", **PRECISION_ISLANDS[mode])
    assert np.isfinite(_embed(sd, cfg, wav[:1, :800], np.array([800], np.int32))).all()
    assert seen == [want] * cfg.num_layers


# ---------------- (f) long inputs take the unfused route at "default" ----------------


def test_long_input_takes_the_unfused_default_route(monkeypatch):
    """T = 1100 > MAX_FUSED_T at "default": ``precision.linear`` and
    ``mha(precision="default")`` (K1b on the card), JAX's ``_unfused_ref``
    at DEFAULT; never the fused route."""

    def refuse(*args):
        raise AssertionError("the fused route ran past MAX_FUSED_T")

    calls = []
    real_mha, real_linear = fused_attention.mha, fused_attention.prec_ops.linear

    def mha_spy(*args, **kw):
        calls.append(("mha", kw["precision"], kw["impl"]))
        return real_mha(*args, **kw)

    def linear_spy(x, w, b, prec):
        calls.append(("linear", prec))
        return real_linear(x, w, b, prec)

    monkeypatch.setattr(fused_attention.FusedQKVAttention, "apply", refuse)
    monkeypatch.setattr(fused_attention, "mha", mha_spy)
    monkeypatch.setattr(fused_attention.prec_ops, "linear", linear_spy)
    t = 1100
    x, ws, bs = _inputs(11, 1, t)
    key_mask = np.arange(t)[None, :] < 1000
    ours = fused_attention.fused_qkv_attention(
        _t(x), *_port_params(ws, bs), key_mask=_t(key_mask), heads=H,
        precision="default").numpy()
    assert calls == [("linear", "default")] * 3 + [("mha", "default", "kernel"),
                                                  ("linear", "default")]
    theirs = np.asarray(jfa._unfused_ref(x, *_jax_params(ws, bs), key_mask, heads=H,
                                         mode="default"))
    scale = np.abs(theirs).max()
    assert np.abs(ours - theirs).max() <= TOL_SUBLAYER_VS_JAX * scale, \
        np.abs(ours - theirs).max() / scale
