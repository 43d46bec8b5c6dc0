"""bf16 activations on every attention path in the port against the JAX
package, on the CPU.

(1) The plain versions of the bf16-I/O flavours of K4 and K4b
(``fused_qkv_mha`` on a bf16 x with the f32 weights) against the JAX
package's ``_fused_kernel`` in interpret mode at each of its modes, and
of K1, K2 and K3 at "highest" (``mha_flash``, ``flash_attention_bwd``)
against ``mha_pallas(precision=HIGHEST)`` and its ``jax.vjp``, at tile
edges with a full, a ragged, a 1-key and a 0-key row: every output bf16,
equal to the f32-I/O flavour on the upcast inputs rounded once, bit for
bit, and within one bf16 ulp of the JAX kernel's output beyond what the
two sides' f32 results on the upcast inputs differ by (both compute in
f32 and round once; XLA on the CPU runs DEFAULT products in f32, so at
"default" that f32 distance holds the port's DEFAULT roundings). (2)
``precision.linear_raw_weights`` against ``_unfused_ref``'s projection and
``_out_proj`` on a bf16 x, value and gradients, at each mode; the fused
sublayer on a bf16 x takes it for its out-projection, its backward's
recompute and its fallback beyond MAX_FUSED_T. (3) The three
configurations the port refused before (bf16 activations in "fast" and
"balanced" with ``fused_qkv``, and in BASE on the K1 path) as whole
models: embeddings and the loss's input gradient against the JAX model
with the same weights. (4) One ``Training`` step with the fused path on
bf16 activations against the JAX trainer's. (5) The plain attention's
products off "default" on bf16 q/k/v against ``mha_xla``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fast_bf16 import (  # noqa: F401  (tree: a fixture)
    _jax_loss_and_grads,
    as_bf16,
    bf16_ulp,
    f64,
    train_config,
    tree,
)
from test_torch_grad_modes import SUM_TOL, bf16_np

from nomad_tpu.api import Nomad as JaxNomad
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
from nomad_tpu.ops import fused_attention as jfa
from nomad_tpu.ops.attention import mha_xla
from nomad_tpu.ops.flash_attention import mha_pallas
from nomad_tpu_torch.api import Nomad
from nomad_tpu_torch.convert import jax_to_state_dict, state_dict_to_jax
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config
from nomad_tpu_torch.models.wav2vec2 import BALANCED_ISLANDS, FAST_ISLANDS
from nomad_tpu_torch.ops import attention, flash_attention, fused_attention, precision
from nomad_tpu_torch.training import Training, data, triplet

torch.set_num_threads(2)
H, HD = 2, 64
DM = H * HD
EMB = 16
BF16 = torch.bfloat16
F64 = np.float64
HIGHEST = jax.lax.Precision.HIGHEST
# the JAX fused kernel's modes and the port's islands that select them
MODES = {"highest": "highest", "high3": "high", "default": "default"}
ZERO_RATES = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
LENGTHS = [1900, 1333, 800]


def _t(x):
    return torch.from_numpy(np.array(x))


def _edge_lengths(t):
    """A full, a ragged, a 1-key and a 0-key row."""
    return [t, max(t // 2, 1), 1, 0]


def _weights(rng, n=3):
    """n (w [out, in], bias) pairs at the seeded init's scale."""
    return [((rng.standard_normal((DM, DM)) / DM**0.5).astype(np.float32),
             (0.1 * rng.standard_normal(DM)).astype(np.float32)) for _ in range(n)]


def within_one_ulp(ours, theirs, f32_gap):
    """|ours - theirs| <= the two sides' f32 distance + one bf16 ulp (each
    rounds its f32 result once, by at most half an ulp), elementwise."""
    ours, theirs = f64(ours), f64(theirs)
    tol = f32_gap + bf16_ulp(np.maximum(np.abs(ours), np.abs(theirs)))
    return np.abs(ours - theirs) <= tol


# ---------------- (1) the plain bf16-I/O flavours against the Pallas kernels ----------------


def jax_fused_o(x, wb, lengths, mode):
    """``_fused_kernel`` in interpret mode on x (jnp, bf16 or f32) with the
    port's [out, in] weights, as ``_fused_fwd_impl`` calls it: O head-major
    [B, H, T, hd] in x's dtype, as float64."""
    b, t, dm = x.shape
    t_pad = jfa._round_up(t, 128)
    xp = jnp.pad(x, ((0, 0), (0, t_pad - t), (0, 0)))
    hw = [jnp.asarray(w.T).reshape(dm, H, HD).transpose(1, 0, 2) for w, _ in wb]
    hb = [jnp.asarray(bias).reshape(H, 1, HD) for _, bias in wb]
    out = jfa._fused_call(xp, *hw, *hb, jnp.asarray(lengths, jnp.int32), H,
                          jfa._block_q_for(t_pad), mode, True)
    assert out.dtype == x.dtype
    return f64(out[:, :, :t])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("t", [1, 17, 65])
def test_fused_bf16_io_plain_flavours_against_the_pallas_kernel(mode, t):
    """K4's ("highest", "high3") and K4b's ("default") bf16-I/O plain
    version: O bf16, the f32 flavour's O on the upcast x rounded once, bit
    for bit, a 0-key row O = 0; against ``_fused_kernel`` in interpret
    mode on the same bf16 x within one bf16 ulp beyond the two f32 results'
    distance (f32 sums in two orders: at most 1e-5 of max |O| at "highest"
    and "high3"; the port's DEFAULT roundings at "default", within the
    mode tolerance of ``tests/test_torch_fused_modes.py``)."""
    rng = np.random.default_rng(100 + t)
    lengths = _edge_lengths(t)
    x, xj, xf = as_bf16(rng, (len(lengths), t, DM))
    wb = _weights(rng)
    params = [_t(a) for pair in wb for a in pair]
    lens = torch.tensor(lengths, dtype=torch.int32)
    ours = fused_attention.fused_qkv_mha(x, *params, lens, H, MODES[mode])
    f32 = fused_attention.fused_qkv_mha(x.float(), *params, lens, H, MODES[mode])
    assert ours.dtype == BF16 and f32.dtype == torch.float32
    assert torch.equal(ours, f32.to(BF16))
    assert (ours[3] == 0).all()
    rows = slice(0, 3)  # the JAX kernel's 0-key row is not defined
    theirs = jax_fused_o(xj, wb, lengths, mode)[rows]
    theirs32 = jax_fused_o(jnp.asarray(xf), wb, lengths, mode)[rows]
    gap = np.abs(f64(f32[rows]) - theirs32)
    scale = np.abs(theirs32).max()
    if mode == "default":
        assert 0 < gap.max() <= 8e-3 * scale  # the port rounds; XLA's CPU does not
    else:
        assert gap.max() <= 1e-5 * scale
    assert within_one_ulp(ours[rows], theirs, gap).all()


def flash_f64(q, k, v, lengths):
    """Exact masked attention in float64 of [B, T, H, D] arrays."""
    b, t, h, d = q.shape
    valid = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(F64), k.astype(F64)) / d**0.5
    s = np.where(valid[:, None, None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = np.nan_to_num(p / p.sum(-1, keepdims=True))
    return np.einsum("bhqk,bkhd->bqhd", p, v.astype(F64))


def flash_bwd_f64(q, k, v, do, o, lengths):
    """dQ, dK, dV in float64 with Di = rowsum(dO o O) from the given O (the
    bf16 O both sides' backward reads)."""
    b, t, h, d = q.shape
    valid = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    q, k, v, do, o = (x.astype(F64) for x in (q, k, v, do, o))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / d**0.5
    s = np.where(valid[:, None, None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = np.nan_to_num(p / p.sum(-1, keepdims=True))
    dp = np.einsum("bqhd,bkhd->bhqk", do, v)
    di = (do * o).sum(-1).transpose(0, 2, 1)[..., None]
    ds = p * (dp - di)
    vk = valid[:, :, None, None]
    return (np.einsum("bhqk,bkhd->bqhd", ds, k) / d**0.5,
            np.where(vk, np.einsum("bhqk,bqhd->bkhd", ds, q) / d**0.5, 0.0),
            np.where(vk, np.einsum("bhqk,bqhd->bkhd", p, do), 0.0))


@pytest.mark.parametrize("t", [1, 15, 16, 17, 63, 64, 65])
def test_flash_highest_bf16_io_plain_flavours_against_mha_pallas(t):
    """K1's, K2's and K3's bf16-I/O plain versions at "highest": O, dQ, dK
    and dV bf16, LSE f32, each the f32 flavour's output on the upcast
    inputs rounded once, bit for bit; a 0-key row O = 0 and zero
    gradients. Against ``mha_pallas(precision=HIGHEST)`` and its
    ``jax.vjp`` in interpret mode on the same bf16 tensors (the backward
    from the JAX kernel's O on both sides): each side within one bf16 ulp
    plus SUM_TOL of max |g| (f32 sums) of the float64 result, so the two
    within twice that."""
    rng = np.random.default_rng(200 + t)
    lengths = _edge_lengths(t)
    (q, qj, qf), (k, kj, kf), (v, vj, vf), (do, doj, dof) = (
        as_bf16(rng, (len(lengths), t, H, HD)) for _ in range(4))
    lens = torch.tensor(lengths, dtype=torch.int32)
    o, lse = flash_attention.mha_flash(q, k, v, lens, "highest")
    o32, lse32 = flash_attention.mha_flash(q.float(), k.float(), v.float(), lens, "highest")
    assert o.dtype == BF16 and lse.dtype == torch.float32
    assert torch.equal(o, o32.to(BF16)) and torch.equal(lse, lse32)
    assert (o[3] == 0).all() and (lse[3] == flash_attention.NEG_INF).all()
    mask = jnp.asarray(np.arange(t)[None, :] < np.asarray(lengths)[:, None])
    o_j, vjp = jax.vjp(lambda a, b, c: mha_pallas(a, b, c, mask, interpret=True,
                                                  precision=HIGHEST), qj, kj, vj)
    assert o_j.dtype == jnp.bfloat16
    grads_j = vjp(doj)
    o_jt = _t(np.asarray(o_j.astype(jnp.float32))).to(BF16)
    grads = flash_attention.flash_attention_bwd(q, k, v, o_jt, lse, do, lens, "highest")
    grads32 = flash_attention.flash_attention_bwd(q.float(), k.float(), v.float(), o_jt.float(),
                                                  lse, do.float(), lens, "highest")
    assert all(g.dtype == BF16 and torch.equal(g, w.to(BF16)) for g, w in zip(grads, grads32))
    assert all((g[3] == 0).all() for g in grads)
    rows = slice(0, 3)  # the JAX kernels' 0-key row is not defined
    exact = [flash_f64(qf, kf, vf, lengths)[rows]] + [
        g[rows] for g in flash_bwd_f64(qf, kf, vf, dof, f64(o_j), lengths)]
    # f32 sums against the largest output of the pass (dK of a 1-key row is
    # 0 up to the rounding of terms of that size)
    scales = [np.abs(exact[0]).max()] + [max(np.abs(g).max() for g in exact[1:])] * 3
    for name, ours, theirs, x, scale in zip(("o", "dq", "dk", "dv"), (o, *grads),
                                            (o_j, *grads_j), exact, scales):
        tol = SUM_TOL * scale + bf16_ulp(x)
        for side in (ours, theirs):
            assert np.all(np.abs(f64(side)[rows] - x) <= tol), name


# ---------------- (2) the product of the fused path on a bf16 x ----------------


@pytest.mark.parametrize("mode", list(MODES))
def test_raw_weight_product_matches_unfused_ref_and_out_proj(mode):
    """``precision.linear_raw_weights`` against the JAX package's fused-path
    products on a bf16 x: ``_unfused_ref``'s projection (``jnp.dot`` of the
    bf16 x with the f32 weight at the mode's precision, f32 out, the f32
    bias, one rounding) and ``_out_proj`` (the head-major bf16 attention
    output with the f32 ``wo``). y and dX bf16 within one bf16 ulp plus
    SUM_TOL of max |y| (f32 sums of 128 products in two orders); dW and db
    f32 within SUM_TOL of their max. XLA on the CPU computes a DEFAULT
    product in f32, so at "default" the oracle takes the weight rounded to
    bf16 as the TPU's pass rounds it, and the port must give the same bits
    from the unrounded weight."""
    rng = np.random.default_rng(300)
    b, t = 2, 37
    x, xj, _ = as_bf16(rng, (b, t, DM))
    g, gj, _ = as_bf16(rng, (b, t, DM))
    (w, bias), = _weights(rng, 1)
    w_oracle = bf16_np(w).astype(np.float32) if mode == "default" else w

    def proj(x_, w_, b_):  # _unfused_ref's proj, before its reshape
        y = jnp.dot(x_, w_, precision=jfa._prec(mode), preferred_element_type=jnp.float32)
        return (y + b_).astype(x_.dtype)

    def out_proj(x_, w_, b_):  # the head-major attention output
        return jfa._out_proj(x_.reshape(b, t, H, HD).transpose(0, 2, 1, 3), w_, b_, H, mode)

    for name, fn in (("proj", proj), ("out_proj", out_proj)):
        y_j, vjp = jax.vjp(fn, xj, jnp.asarray(w_oracle.T), jnp.asarray(bias))
        dx_j, dw_j, db_j = vjp(gj)
        assert y_j.dtype == dx_j.dtype == jnp.bfloat16
        xt, wt, bt = x.clone().requires_grad_(), _t(w).requires_grad_(), _t(bias).requires_grad_()
        y = precision.linear_raw_weights(xt, wt, bt, MODES[mode])
        y.backward(g)
        assert y.dtype == xt.grad.dtype == BF16 and wt.grad.dtype == bt.grad.dtype == torch.float32
        for ours, theirs in ((y, y_j), (xt.grad, dx_j)):
            gap = SUM_TOL * np.abs(f64(theirs)).max()
            assert within_one_ulp(ours, theirs, gap).all(), name
        for ours, theirs in ((wt.grad.numpy().T, dw_j), (bt.grad, db_j)):
            theirs = f64(theirs)
            assert np.abs(f64(ours) - theirs).max() <= SUM_TOL * np.abs(theirs).max(), name
    w_rounded = bf16_np(w).astype(np.float32)
    rounded = precision.linear_raw_weights(x, _t(w_rounded), _t(bias), MODES[mode])
    unrounded = precision.linear_raw_weights(x, _t(w), _t(bias), MODES[mode])
    assert torch.equal(rounded, unrounded) == (mode == "default")


@pytest.fixture
def raw_weight_calls(monkeypatch):
    """Counts the fused path's calls of ``precision.linear_raw_weights``
    and of ``precision.linear``."""
    calls = {"raw": 0, "linear": 0}
    raw, linear = precision.linear_raw_weights, precision.linear

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(precision, "linear_raw_weights", count("raw", raw))
    monkeypatch.setattr(precision, "linear", count("linear", linear))
    return calls


# the fused sublayer on a bf16 x against the JAX package's on the same
# inputs, in bf16 steps of the largest output (2^-7 here): measured 0 at
# "highest", 0.5 at "high3", 1 at "default" (the port's DEFAULT
# roundings; XLA's CPU runs f32), and 1 on the unfused route (whose JAX
# attention, mha_xla, rounds the normalised weights to bf16 where the
# port's flash attention keeps p in f32) at every mode
TOL_SUBLAYER_STEPS = 2


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_fused_sublayer_on_bf16_takes_the_raw_weight_product(raw_weight_calls, monkeypatch,
                                                            mode, route):
    """``fused_qkv_attention`` on a bf16 x: bf16 out, the out-projection
    through ``linear_raw_weights`` (1 call; the backward's q/k/v recompute
    3 more), never ``precision.linear``; beyond MAX_FUSED_T (here lowered
    to 16 frames) the unfused composition with the same product for its
    four projections, as ``_unfused_ref``. Against the JAX package's
    ``fused_qkv_attention`` (interpret mode) on the same inputs within
    TOL_SUBLAYER_STEPS bf16 steps of max |y|, and its input and weight
    gradients finite
    and of the inputs' dtypes. An f32 x takes ``precision.linear`` only."""
    if route == "unfused":
        monkeypatch.setattr(fused_attention, "MAX_FUSED_T", 16)
        monkeypatch.setattr(jfa, "MAX_FUSED_T", 0)
    rng = np.random.default_rng(400)
    t, lengths = 40, [40, 23]
    x, xj, xf = as_bf16(rng, (len(lengths), t, DM))
    wb = _weights(rng, 4)
    key_mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    theirs = jfa.fused_qkv_attention(xj, *(a for w, b in wb for a in (jnp.asarray(w.T), b)),
                                     key_mask=jnp.asarray(key_mask), heads=H, mode=mode,
                                     interpret=True)
    assert theirs.dtype == jnp.bfloat16
    xt = x.clone().requires_grad_()
    params = [_t(a).requires_grad_() for pair in wb for a in pair]
    y = fused_attention.fused_qkv_attention(xt, *params, key_mask=_t(key_mask), heads=H,
                                            precision=MODES[mode])
    assert y.dtype == BF16
    assert raw_weight_calls == {"raw": 1 if route == "fused" else 4, "linear": 0}
    d = np.abs(f64(y) - f64(theirs)).max() / bf16_ulp(np.abs(f64(theirs)).max())
    assert d <= TOL_SUBLAYER_STEPS, d
    y.backward(_t(rng.standard_normal(y.shape).astype(np.float32)).to(BF16))
    assert raw_weight_calls["raw"] == 4  # fused: the backward recomputes q, k and v
    assert xt.grad.dtype == BF16 and all(p.grad.dtype == torch.float32 for p in params)
    assert torch.isfinite(xt.grad.float()).all() and all(torch.isfinite(p.grad).all()
                                                        for p in params)
    before = dict(raw_weight_calls)
    fused_attention.fused_qkv_attention(_t(xf), *params, key_mask=_t(key_mask), heads=H,
                                        precision=MODES[mode])
    assert raw_weight_calls["raw"] == before["raw"] and raw_weight_calls["linear"] > 0


# ---------------- (3) the three configurations as whole models ----------------

# name: (islands, the port's attention_impl, the JAX package's): the
# port's "kernel" is JAX's "pallas" (the flash kernel; mha_xla rounds the
# normalised weights to bf16 on bf16 activations, the flash kernels do not)
CONFIGS = {"fast_fused": (FAST_ISLANDS, "fused_qkv", "fused_qkv"),
           "balanced_fused": (BALANCED_ISLANDS, "fused_qkv", "fused_qkv"),
           "base": ({}, "kernel", "pallas")}


def port_config(name, bf16, **kw):
    islands, impl, _ = CONFIGS[name]
    return Wav2Vec2Config.tiny(**islands, attention_impl=impl,
                               encoder_dtype=BF16 if bf16 else None, **kw)


def jax_config(name, bf16, **kw):
    islands, _, impl = CONFIGS[name]
    return JaxConfig.tiny(**islands, attention_impl=impl,
                          encoder_dtype=jnp.bfloat16 if bf16 else None, **kw)


@pytest.fixture(scope="module")
def bridged():
    rng = np.random.default_rng(17)
    wav = np.zeros((len(LENGTHS), max(LENGTHS)), np.float32)
    for i, n in enumerate(LENGTHS):
        wav[i, :n] = 0.3 * rng.standard_normal(n)
    params = JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB).init(
        jax.random.key(4), jnp.asarray(wav[:1, :800]), method=JaxNomadModel.init_all)
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, jax_to_state_dict(params), wav, np.asarray(LENGTHS, np.int32)


def _port_model(sd, cfg):
    model = NomadModel(cfg, emb_dim=EMB)
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_config_embeddings_against_jax(bridged, name):
    """The embeddings of a bf16-activation config against the JAX model's
    of the same config and weights: f32, finite, and within 1e-5 + twice
    D, D = the JAX package's own distance between the config on bf16 and
    on f32 activations plus the port's f32-activation distance to the JAX
    package (the port's DEFAULT roundings, which XLA on the CPU does not
    make: 0 at BASE's "high" islands up to f32 order); both from code
    that is not under test here, as chip_smoke.py's phase 10 rule.
    Measured 0.60 D (fast, fused), 0.64 D (balanced, fused) and 0.47 D
    (BASE)."""
    params, sd, wav, lengths = bridged
    w, lens = _t(wav), _t(lengths).long()
    ours, theirs = {}, {}
    for bf16 in (False, True):
        with torch.inference_mode():
            ours[bf16] = _port_model(sd, port_config(name, bf16))(w, lens)
        theirs[bf16] = f64(JaxNomadModel(jax_config(name, bf16), emb_dim=EMB).apply(
            params, jnp.asarray(wav), jnp.asarray(lengths)))
    assert ours[True].dtype == torch.float32 and torch.isfinite(ours[True]).all()
    d_jax = np.abs(theirs[True] - theirs[False]).max()
    d_mode = np.abs(f64(ours[False]) - theirs[False]).max()
    d = np.abs(f64(ours[True]) - theirs[True]).max()
    assert 0 < d_jax and d <= 1e-5 + 2 * (d_jax + d_mode), (d, d_jax, d_mode)


def _f32(a):
    return a.float() if torch.is_tensor(a) else a.astype(jnp.float32)


def _signed_loss(layers_fn, est, clean, signs):
    """The sum over layers of mean(sign o (layer(est) - layer(clean))) in
    f32: one L1 sign pattern for every side (an element of a layer
    difference within rounding of 0 takes either sign)."""
    ref = [_f32(c) for c in layers_fn(clean)]
    return sum((s * (_f32(a) - c)).mean() for s, a, c in zip(signs, layers_fn(est), ref))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_config_loss_gradient_against_jax(bridged, name):
    """``Nomad.forward(est, clean)`` on a bf16-activation config: finite,
    0 for ``forward(x, x)``, and within 1e-5 relative + twice D of the JAX
    ``Nomad.loss_fn``; the loss's input gradient under the port's L1 sign
    pattern against ``jax.grad`` of the same signed loss, relative to max
    |g|, within 1e-4 + twice D; D as for the embeddings (the JAX package's
    bf16-vs-f32 distance plus the port's f32-activation distance to it)."""
    params, sd, _, _ = bridged
    rng = np.random.default_rng(18)
    clean = (0.3 * rng.standard_normal((2, 1600))).astype(np.float32)
    est = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    nomad = Nomad(device="cpu", config=port_config(name, True), emb_dim=EMB, params=sd)
    loss = nomad.forward(_t(est).requires_grad_(), _t(clean))
    assert torch.isfinite(loss) and nomad.forward(_t(clean), _t(clean)).item() == 0.0
    with torch.no_grad():
        signs = [torch.sign(a.float() - c.float()) for a, c in zip(
            nomad.model.forward_layers(_t(est)), nomad.model.forward_layers(_t(clean)))]
    j_signs = [jnp.asarray(s.numpy()) for s in signs]
    grads, losses = {}, {}
    for bf16 in (False, True):
        model = _port_model(sd, port_config(name, bf16))
        e = _t(est).requires_grad_()
        _signed_loss(model.forward_layers, e, _t(clean), signs).backward()
        jcfg = jax_config(name, bf16)
        jm = JaxNomadModel(jcfg, emb_dim=EMB)

        def layers(x, jm=jm):
            return jm.apply(params, x, method=JaxNomadModel.forward_layers)

        jgrad = jax.grad(lambda x: _signed_loss(layers, x, jnp.asarray(clean), j_signs))(
            jnp.asarray(est))
        grads[bf16] = (e.grad.numpy().astype(F64), f64(jgrad))
        losses[bf16] = float(JaxNomad(device="cpu", config=jcfg, emb_dim=EMB, params=params)
                             .loss_fn(jnp.asarray(est), jnp.asarray(clean)))
    gmax = np.abs(grads[True][1]).max()
    d_jax = np.abs(grads[True][1] - grads[False][1]).max() / gmax
    d_mode = np.abs(grads[False][0] - grads[False][1]).max() / gmax
    d = np.abs(grads[True][0] - grads[True][1]).max() / gmax
    assert np.isfinite(grads[True][0]).all()
    assert 0 < d_jax and d <= 1e-4 + 2 * (d_jax + d_mode), (d, d_jax, d_mode)
    port_f32 = Nomad(device="cpu", config=port_config(name, False), emb_dim=EMB, params=sd)
    l32 = port_f32.forward(_t(est), _t(clean)).item()
    d_loss = abs(losses[True] - losses[False]) + abs(l32 - losses[False])
    assert abs(loss.item() - losses[True]) <= 1e-5 * abs(losses[True]) + 2 * d_loss


# ---------------- (4) one trainer step on the fused path with bf16 activations ----------------


def _fused_training(tree, params, precision_mode, **over):
    """``Training`` with ``precision_mode``'s config on the fused path."""
    config = triplet.resolve_model_config({"model_size": "tiny", "precision": precision_mode})
    config = dataclasses.replace(config, attention_impl="fused_qkv", **over)
    return Training(train_config(tree, precision=precision_mode), device="cpu",
                    params=jax_to_state_dict(params), model_config=config)


def _port_fused_loss_and_grads(tree, params, precision_mode, batch=None):
    """A rates-at-0 step's loss and trainable gradients (flat JAX keys) on
    the fused path, without the optimizer; and the batch."""
    tr = _fused_training(tree, params, precision_mode, **ZERO_RATES)
    if batch is None:
        batch = data.collate_triplets([tr.train_set.load_item(i) for i in (0, 1)])
    loss = tr.triplet_loss(batch, False, torch.Generator().manual_seed(0))
    loss.backward()
    grads = state_dict_to_jax({n: p.grad for n, p in tr.model.named_parameters()
                               if p.grad is not None})
    return loss.item(), grads, batch


def test_one_fused_fast_bf16_step_against_jax(tree, bridged):
    """``Training(model_config=...)`` with ``fast_bf16``'s config on the
    fused path (K4b's bf16-I/O flavour on the card): with the rates at 0,
    the loss and every trainable gradient against the JAX trainer's with
    the same config, weights and batch, by ``test_one_fast_bf16_step_
    against_jax``'s rule (within 1e-4 + 2 D of max |g|, D = the JAX
    package's fused fast_bf16-vs-exact distance plus the port's fused
    "fast" distance to the JAX package's; both from code not under test);
    then the recipe's step with dropout (the plain dropout attention, as
    JAX's ``use_fused`` falls back) runs and moves the trainable
    parameters."""
    params = bridged[0]
    loss, grads, batch = _port_fused_loss_and_grads(tree, params, "fast_bf16")
    assert not any(k.startswith("lossnet_embedding") or "feature_encoder" in k for k in grads)
    l_fast, g_fast, _ = _port_fused_loss_and_grads(tree, params, "fast", batch)
    frozen = dict(frontend_stop_gradient=True, attention_impl="fused_qkv", **ZERO_RATES)
    fast = dict(frontend_precision="high", encoder_precision="default")
    (l_bf16, g_bf16), (lj_fast, gj_fast), (l_exact, g_exact) = (
        _jax_loss_and_grads(config, params, batch) for config in (
            JaxConfig.tiny(**fast, encoder_dtype=jnp.bfloat16, **frozen),
            JaxConfig.tiny(**fast, **frozen), JaxConfig.tiny(**frozen)))
    gmax = max(np.abs(g_bf16[k]).max() for k in grads)

    def dist(a, b):
        return max(np.abs(a[k] - b[k]).max() for k in grads) / gmax

    d_plain = dist(g_bf16, g_exact) + dist(g_fast, gj_fast)
    d = dist(grads, g_bf16)
    assert 0 < d <= 1e-4 + 2 * d_plain, (d, d_plain)
    d_loss = abs(l_bf16 - l_exact) + abs(l_fast - lj_fast)
    assert abs(loss - l_bf16) <= 1e-5 * abs(l_bf16) + 2 * d_loss, (loss, l_bf16, d_loss)
    tr = _fused_training(tree, params, "fast_bf16")
    assert tr.model_config.attention_dropout > 0 and tr.model_config.block_dtype == BF16
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters() if p.requires_grad}
    step_loss = tr.train_step(batch, torch.Generator().manual_seed(1))
    assert np.isfinite(float(step_loss))
    assert any(not torch.equal(p.detach(), before[n]) for n, p in tr.model.named_parameters()
               if n in before)


# ---------------- (5) the plain attention off "default" on bf16 ----------------


def test_plain_attention_off_default_sums_bf16_into_f32():
    """``mha_ref`` on bf16 q/k/v at "highest" against ``mha_xla``: the
    scores are the f32 sums of the bf16 products (``preferred_element_type
    =f32``), the softmax f32, the weights rounded to bf16, the product
    summed in f32 and rounded once. O within one bf16 ulp plus SUM_TOL of
    max |O| (f32 order), and each of dQ, dK, dV (``jax.vjp``) within one
    ulp plus SUM_TOL of its max; a bf16 einsum of the scores (rounding
    each score) misses that bound."""
    rng = np.random.default_rng(500)
    b, t, lengths = 2, 70, [70, 41]
    (q, qj, _), (k, kj, _), (v, vj, _), (do, doj, _) = (as_bf16(rng, (b, t, H, HD), 2.0)
                                                      for _ in range(4))
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    with jax.default_matmul_precision("highest"):
        o_j, vjp = jax.vjp(lambda a, c, e: mha_xla(a, c, e, jnp.asarray(mask)), qj, kj, vj)
        grads_j = vjp(doj)
    xs = [a.clone().requires_grad_() for a in (q, k, v)]
    o = attention.mha_ref(*xs, _t(mask), "highest")
    o.backward(do)
    assert o.dtype == BF16 and all(a.grad.dtype == BF16 for a in xs)
    for ours, theirs in zip((o, *(a.grad for a in xs)), (o_j, *grads_j)):
        gap = SUM_TOL * np.abs(f64(theirs)).max()
        assert within_one_ulp(ours, theirs, gap).all()
    # the same attention with bf16 einsums (each score rounded to bf16)
    scores = torch.einsum("bqhd,bkhd->bhqk", q * 0.125, k).float()
    scores = scores + torch.where(_t(mask), 0.0, attention.NEG_INF)[:, None, None, :]
    weights = torch.softmax(scores, dim=-1).to(BF16)
    rounded = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    gap = SUM_TOL * np.abs(f64(o_j)).max()
    assert not within_one_ulp(rounded, o_j, gap).all()
