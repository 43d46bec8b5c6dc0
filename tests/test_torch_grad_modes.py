"""Gradients through the precision modes ("balanced", "fast") of the port
against the JAX package's, on the CPU.

(a) ``ops.precision.linear``/``conv1d``, the flash attention's backward
and the dropout attention at "default" against a float64 emulation of the
transposes JAX makes of a DEFAULT product: every backward product rounds
its operands (the cotangent included) to bf16 and sums in f32; (b) the
attention backward and the dropout attention against ``jax.vjp`` of the
JAX package's (K2/K3 in interpret mode, ``mha_xla_dropout``; XLA on the
CPU computes DEFAULT products in f32); (c) every product and convolution
of the loss's backward carries the precision the JAX package's
``jax.grad`` trace gives it; (d) the loss and its gradient, the triplet
trainer (its ``precision:`` rule, one step, a trajectory) and one SE step
in a mode, against the JAX package.

The emulations take inputs whose bf16 roundings make every product exact
(``unit_class``). Where the port rounds a value it computed in f32 (P, dS,
the dropped weights), the f64 value may lie within f32 error of a bf16
rounding boundary and round the other way: ``rounded_einsum`` bounds what
such a flip can move, one bf16 step of that element times its partner,
and the port must lie within that bound plus the f32 sums' rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.api import Nomad as JaxNomad
from nomad_tpu.api import _flatten
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
from nomad_tpu.models.heads import nomad_loss as jax_nomad_loss
from nomad_tpu.models.wav2vec2 import mha_xla_dropout
from nomad_tpu.ops.flash_attention import mha_pallas
from nomad_tpu.training import Training as JaxTraining
from nomad_tpu_torch import api as tapi
from nomad_tpu_torch import main as dispatch
from nomad_tpu_torch.convert import jax_to_state_dict, state_dict_to_jax
from nomad_tpu_torch.io import write_wav
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config
from nomad_tpu_torch.models.wav2vec2 import PRECISION_ISLANDS
from nomad_tpu_torch.ops import attention, flash_attention, precision
from nomad_tpu_torch.training import SpeechEnhancement, Training, data, triplet
from nomad_tpu_torch.utils import config as config_io

torch.set_num_threads(2)
EMB = 16
F64 = np.float64
MODES = ("balanced", "fast")
ZERO_RATES = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
JAX_PRECISION = {"DEFAULT": "default", "HIGH": "high", "HIGHEST": "highest"}
# relative f32 error of the values the port rounds to bf16 after computing
# them in f32 (exp, a softmax, a division): a few ulps; 1e-5 is ~80 ulps
REL_F32 = 1e-5
# f32 sums of up to a few hundred products against their float64 sums,
# relative to the output's max |y|
SUM_TOL = 1e-5


def bf16_np(x):
    """x (float32) rounded to the nearest bfloat16, ties to even, by bit
    manipulation, returned as float64."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(F64)


def unit_class(rng, shape):
    """Magnitudes in [0.5, 1) with random signs: after rounding to bf16 every
    value is a multiple of 2^-8, so sums of their products stay exact in
    f32 while below 2^7."""
    x = rng.uniform(0.5, 1.0, shape) * rng.choice([-1.0, 1.0], shape)
    return x.astype(np.float32)


def rounded_einsum(eq, a, a_err, b):
    """einsum(eq, bf16(a), b) in float64, for an ``a`` that the port
    computes in f32 within ``a_err`` (absolute, per element) of this
    float64 ``a``, and an exact ``b``; and the bound on what a rounding of
    ``a`` to another bf16 neighbour inside that error moves: the einsum of
    the largest such move per element with |b|."""
    ar = bf16_np(a.astype(np.float32))
    lo = bf16_np((a - a_err).astype(np.float32))
    hi = bf16_np((a + a_err).astype(np.float32))
    flip = np.maximum(np.abs(hi - ar), np.abs(ar - lo))
    return np.einsum(eq, ar, b), np.einsum(eq, flip, np.abs(b))


def assert_within(ours, emu, budget, what):
    """|ours - emu| <= budget (the flips) + SUM_TOL * max |emu|."""
    excess = np.abs(ours - emu) - budget - SUM_TOL * np.abs(emu).max()
    assert excess.max() <= 0, (what, excess.max(), np.abs(ours - emu).max())


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x))
    return t.requires_grad_() if grad else t


# ---------------- (a) products and convolutions: JAX's DEFAULT transposes ----------------


def test_linear_gradient_default_is_jaxs_transpose():
    """dX = bf16(dY) . bf16(W), dW = bf16(dY)^T . bf16(X), db = sum dY in
    f32. The rounded products of unit-class values are multiples of 2^-16
    and their sums (<= 111 terms) stay below 2^7, so the f32 sums are
    exact: dX and dW equal the emulation to the bit."""
    rng = np.random.default_rng(21)
    x, w, b = unit_class(rng, (3, 37, 96)), unit_class(rng, (80, 96)), unit_class(rng, (80,))
    g = unit_class(rng, (3, 37, 80))
    xt, wt, bt = _t(x, True), _t(w, True), _t(b, True)
    precision.linear(xt, wt, bt, "default").backward(_t(g))
    gq = bf16_np(g)
    np.testing.assert_array_equal(xt.grad.numpy(), gq @ bf16_np(w))
    np.testing.assert_array_equal(wt.grad.numpy(), np.einsum("bto,bti->oi", gq, bf16_np(x)))
    np.testing.assert_allclose(bt.grad.numpy(), g.astype(F64).sum(axis=(0, 1)), rtol=1e-5)
    # autograd through round_bf16 would differ: it keeps dY and W unrounded
    assert np.abs(xt.grad.numpy() - g.astype(F64) @ bf16_np(w)).max() > 1e-3
    assert np.abs(xt.grad.numpy() - bf16_np(g @ w)).max() > 1e-3
    # the f32 islands keep plain autograd
    xt.grad = None
    precision.linear(xt, wt, bt, "high").backward(_t(g))
    np.testing.assert_allclose(xt.grad.numpy(), g.astype(F64) @ w.astype(F64), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("a_shape, b_shape", [
    ((45, 96), (96, 80)),  # a linear layer's product, x . W^T
    ((2, 3, 37, 64), (2, 3, 64, 29)),  # the attention's, per batch row and head
], ids=["2d", "4d"])
def test_matmul_bf16_is_jaxs_transpose(a_shape, b_shape):
    """``precision.matmul_bf16``, the one bf16 product behind the linear
    layers and the plain and dropout attention: y = bf16(a) . bf16(b),
    da = bf16(g) . bf16(b)^T and db = bf16(a)^T . bf16(g), f32 out. Sums
    of at most 96 unit-class products are exact in f32: equal to the bit."""
    rng = np.random.default_rng(len(a_shape))
    a, b = unit_class(rng, a_shape), unit_class(rng, b_shape)
    at, bt = _t(a, True), _t(b, True)
    y = precision.matmul_bf16(at, bt)
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(y.detach().numpy(), bf16_np(a) @ bf16_np(b))
    g = unit_class(rng, tuple(y.shape))
    y.backward(_t(g))
    gq = bf16_np(g)
    np.testing.assert_array_equal(at.grad.numpy(), gq @ np.swapaxes(bf16_np(b), -1, -2))
    np.testing.assert_array_equal(bt.grad.numpy(), np.swapaxes(bf16_np(a), -1, -2) @ gq)


def conv_grads_f64(x, w, g, stride, padding, groups):
    """dX and dW of y = conv1d(bf16(x), bf16(w)) for the cotangent g, as
    JAX's DEFAULT transposes compute them: convolutions of bf16(g) with
    bf16(w) and bf16(x), in float64."""
    xq = np.pad(bf16_np(x), ((0, 0), (0, 0), (padding, padding)))
    wq, gq = bf16_np(w), bf16_np(g)
    cout, cg, k = w.shape
    per = cout // groups
    t_out = g.shape[2]
    dxp, dw = np.zeros_like(xq), np.zeros(w.shape)
    for o in range(cout):
        cs = slice((o // per) * cg, (o // per + 1) * cg)
        for j in range(k):
            taps = slice(j, j + stride * (t_out - 1) + 1, stride)
            dw[o, :, j] = np.einsum("bct,bt->c", xq[:, cs, taps], gq[:, o])
            dxp[:, cs, taps] += np.einsum("bt,c->bct", gq[:, o], wq[o, :, j])
    return dxp[:, :, padding:padding + x.shape[2]], dw


@pytest.mark.parametrize("shape", [
    # the positional conv's class: k even, SamePad-style padding, groups
    dict(bsz=2, cin=32, cout=32, t=70, k=16, stride=1, padding=8, groups=4),
    # the conv frontend's class: strided, one group
    dict(bsz=2, cin=8, cout=16, t=200, k=10, stride=5, padding=0, groups=1),
], ids=["positional", "frontend"])
def test_conv1d_gradient_default_is_jaxs_transpose(shape):
    """dX and dW are the f32 convolutions of bf16(dY) with bf16(W) and
    bf16(X); db = sum dY in f32. Exact sums as for the product (at most
    140 products of multiples of 2^-16 per output), so equal to the bit."""
    s = shape
    rng = np.random.default_rng(s["k"])
    x = unit_class(rng, (s["bsz"], s["cin"], s["t"]))
    w = unit_class(rng, (s["cout"], s["cin"] // s["groups"], s["k"]))
    b = unit_class(rng, (s["cout"],))
    xt, wt, bt = _t(x, True), _t(w, True), _t(b, True)
    y = precision.conv1d(xt, wt, bt, "default", stride=s["stride"], padding=s["padding"],
                         groups=s["groups"])
    g = unit_class(rng, tuple(y.shape))
    y.backward(_t(g))
    dx, dw = conv_grads_f64(x, w, g, s["stride"], s["padding"], s["groups"])
    np.testing.assert_array_equal(xt.grad.numpy(), dx)
    np.testing.assert_array_equal(wt.grad.numpy(), dw)
    np.testing.assert_allclose(bt.grad.numpy(), g.astype(F64).sum(axis=(0, 2)), rtol=1e-5)
    # the unrounded cotangent (autograd through round_bf16) gives another dW
    unrounded = torch.nn.grad.conv1d_weight(precision.round_bf16(_t(x)), w.shape, _t(g),
                                            s["stride"], s["padding"], 1, s["groups"])
    assert np.abs(unrounded.numpy() - dw).max() > 1e-3


# ---------------- (a, b) the flash attention's backward at "default" ----------------


def attention_bwd_emulation(q, k, v, do, o, lse, lengths):
    """K2b's and K3b's arithmetic in float64 from the port's O and LSE:
    s = bf16(q) . bf16(k) / 8, p = exp(s - LSE), dp = bf16(dO) . bf16(v)^T,
    ds = p (dp - Di), Di = rowsum(dO O); dQ = bf16(ds) . bf16(k) / 8,
    dK = bf16(ds)^T . bf16(q) / 8, dV = bf16(p)^T . bf16(dO). Returns the
    three gradients and their flip bounds."""
    b, t, h, d = q.shape
    outs = [np.zeros((b, t, h, d)) for _ in range(6)]
    for i, n in enumerate(lengths):
        if n == 0:
            continue
        qi, ki, vi, doi = bf16_np(q[i]), bf16_np(k[i, :n]), bf16_np(v[i, :n]), bf16_np(do[i])
        s = np.einsum("qhd,khd->hqk", qi, ki) / 8.0  # exact in f32 too
        p = np.exp(s - lse[i][:, :, None].astype(F64))
        dp = np.einsum("qhd,khd->hqk", doi, vi)  # exact
        terms = do[i].astype(F64) * o[i].astype(F64)
        di = terms.sum(axis=-1).T[:, :, None]
        di_err = 1e-5 * np.abs(terms).sum(axis=-1).T[:, :, None]  # f32 sum of 64 terms
        ds = p * (dp - di)
        ds_err = REL_F32 * np.abs(ds) + p * di_err
        dq, bq = rounded_einsum("hqk,khd->qhd", ds, ds_err, ki)
        dk, bk = rounded_einsum("hqk,qhd->khd", ds, ds_err, qi)
        dv, bv = rounded_einsum("hqk,qhd->khd", p, REL_F32 * p, doi)
        for out, val in zip(outs, (dq / 8, dk / 8, dv, bq / 8, bk / 8, bv)):
            out[i, :val.shape[0]] = val
    return outs[:3], outs[3:]


def _attention_inputs(seed, b, t, lengths):
    rng = np.random.default_rng(seed)
    q, k, v, do = (unit_class(rng, (b, t, 2, 64)) for _ in range(4))
    for i, n in enumerate(lengths):
        k[i, n:] = np.nan  # past the bound: must reach no gradient
        v[i, n:] = np.nan
    return q, k, v, do


def test_flash_backward_default_matches_emulation():
    """``FlashAttention``'s gradient at "default" on CPU tensors (the plain
    version of K2b + K3b, from K1b's plain O and LSE) against the float64
    emulation, with a full, a ragged, a 1-key and a 0-key row and NaN past
    each bound; the f32 flavour's gradient lies outside the bound."""
    lengths = [50, 31, 1, 0]
    q, k, v, do = _attention_inputs(3, 4, 50, lengths)
    lens = torch.tensor(lengths, dtype=torch.int32)
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    before = (flash_attention.launches_bwd_dq_bf16, flash_attention.launches_bwd_dkv_bf16)
    o = flash_attention.FlashAttention.apply(qt, kt, vt, lens, "default")
    o.backward(_t(do))
    assert (flash_attention.launches_bwd_dq_bf16,
            flash_attention.launches_bwd_dkv_bf16) == before  # no kernel on the CPU
    _, lse = flash_attention.flash_attention_ref(_t(q), _t(k), _t(v), lens, "default")
    emu, budget = attention_bwd_emulation(q, k, v, do, o.detach().numpy(), lse.numpy(), lengths)
    ours = [x.grad.numpy() for x in (qt, kt, vt)]
    for name, g, e, bd in zip(("dq", "dk", "dv"), ours, emu, budget):
        assert np.isfinite(g).all(), name
        assert_within(g, e, bd, name)
        # the flip bounds are small, so the check is not vacuous: their mean
        # measured 4.7e-5 (dq), 3.8e-5 (dk), 5.2e-7 (dv) of max |g|
        assert bd.mean() < 1.5e-4 * np.abs(e).max(), (name, bd.mean())
    for i, n in enumerate(lengths):
        assert np.all(ours[1][i, n:] == 0) and np.all(ours[2][i, n:] == 0)
    assert np.all(ours[0][3] == 0)
    f32 = flash_attention.flash_attention_bwd_ref(_t(q), _t(k), _t(v), o.detach(), lse, _t(do),
                                                  lens, "highest")
    excess = np.abs(f32[0].numpy() - emu[0]) - budget[0] - SUM_TOL * np.abs(emu[0]).max()
    assert excess.max() > 0  # an f32 backward would fail this test


# measured 6.4e-3 (dq), 3.2e-2 (dk), 1.4e-3 (dv) of max |g| between the
# port's "default" gradient and JAX's (XLA's CPU runs K2/K3 in f32) on these
# inputs; 0.08 is 2.5x the largest
TOL_ATTN_VS_JAX = 0.08


def test_flash_backward_default_against_pallas_vjp():
    """The same gradient against ``jax.vjp`` of ``mha_pallas(...,
    precision=DEFAULT, interpret=True)``, whose backward runs K2 and K3 at
    their default precision in interpret mode (f32 on the CPU): within
    bf16 rounding, and farther than the port's own f32 flavour, which
    matches it to 2e-5."""
    lengths = [50, 31, 1]
    q, k, v, do = _attention_inputs(4, 3, 50, [50] * 3)
    lens = torch.tensor(lengths, dtype=torch.int32)
    mask = np.arange(50)[None, :] < np.asarray(lengths)[:, None]
    _, vjp = jax.vjp(lambda a, b, c: mha_pallas(a, b, c, jnp.asarray(mask), interpret=True,
                                               precision=jax.lax.Precision.DEFAULT),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    theirs = [np.asarray(x) for x in vjp(jnp.asarray(do))]
    for prec in ("default", "highest"):
        qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
        flash_attention.FlashAttention.apply(qt, kt, vt, lens, prec).backward(_t(do))
        for name, ours, ref in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), theirs):
            rel = np.abs(ours.numpy() - ref).max() / np.abs(ref).max()
            if prec == "highest":
                assert rel < 2e-5, (name, rel)
            else:
                assert 1e-4 < rel < TOL_ATTN_VS_JAX, (name, rel)


# ---------------- (a, b) the dropout attention at "default" ----------------


def _dropout_case(seed):
    rng = np.random.default_rng(seed)
    b, t, h = 2, 40, 2
    q, k, v, g = (unit_class(rng, (b, t, h, 64)) for _ in range(4))
    mask = np.arange(t)[None, :] < np.asarray([40, 23])[:, None]
    return q, k, v, g, mask


def _port_dropout(q, k, v, g, mask, rate, seed, prec):
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    out = attention.mha_dropout(qt, kt, vt, _t(mask), rate, torch.Generator().manual_seed(seed),
                                precision=prec)
    out.backward(_t(g))
    return [out.detach().numpy()] + [x.grad.numpy() for x in (qt, kt, vt)]


# measured 3.6e-3 (out), 4.5e-3 (dq), 3.7e-3 (dk), 2.3e-3 (dv) of max |y|
# between the port's "default" dropout attention and JAX's (f32 on the
# CPU); 0.012 is 2.7x the largest
TOL_DROPOUT_VS_JAX = 0.012


def test_mha_dropout_default_against_jax(monkeypatch):
    """``mha_dropout(..., precision="default")`` against ``mha_xla_dropout``
    under ``default_matmul_precision("default")`` with the port's keep mask
    (``jax.random.bernoulli`` patched in this test to return it): the f32
    flavour to 1e-6, the bf16 one within bf16 rounding."""
    q, k, v, g, mask = _dropout_case(5)
    rate, seed = 0.25, 7
    keep = (torch.rand((2, 2, 40, 40), generator=torch.Generator().manual_seed(seed)) >= rate)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(keep.numpy()))
    with jax.default_matmul_precision("default"):
        out, vjp = jax.vjp(lambda a, b, c: mha_xla_dropout(a, b, c, jnp.asarray(mask), rate,
                                                           jax.random.key(0)),
                           jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        theirs = [np.asarray(out)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]
    for prec, lo, hi in (("highest", 0.0, 1e-6), ("default", 1e-4, TOL_DROPOUT_VS_JAX)):
        ours = _port_dropout(q, k, v, g, mask, rate, seed, prec)
        for name, a, b in zip(("out", "dq", "dk", "dv"), ours, theirs):
            rel = np.abs(a - b).max() / np.abs(b).max()
            assert lo <= rel <= hi, (prec, name, rel)


def test_mha_dropout_default_matches_emulation():
    """Value and gradient against float64: scores = bf16(q / 8) . bf16(k)
    (exact), the softmax and the dropped weights w' = keep w / (1 - rate)
    in float64, out = bf16(w') . bf16(v); dW' = bf16(dO) . bf16(v)^T,
    dS the softmax's backward of keep dW' / (1 - rate), dq = bf16(dS) .
    bf16(k) / 8, dk = bf16(dS)^T . bf16(q / 8), dv = bf16(w')^T . bf16(dO)."""
    q, k, v, g, mask = _dropout_case(6)
    rate, seed = 0.25, 3
    keep = (torch.rand((2, 2, 40, 40), generator=torch.Generator().manual_seed(seed))
            >= rate).numpy()
    ours = _port_dropout(q, k, v, g, mask, rate, seed, "default")
    qs, kq, vq, gq = bf16_np(q / 8), bf16_np(k), bf16_np(v), bf16_np(g)
    s = np.einsum("bqhd,bkhd->bhqk", qs, kq) + np.where(mask, 0.0, -1e9)[:, None, None, :]
    w = np.exp(s - s.max(axis=-1, keepdims=True))
    w /= w.sum(axis=-1, keepdims=True)
    wd = np.where(keep, w / (1 - rate), 0.0)
    out, b_out = rounded_einsum("bhqk,bkhd->bqhd", wd, REL_F32 * wd, vq)
    dwd = np.einsum("bqhd,bkhd->bhqk", gq, vq)  # exact
    dw = np.where(keep, dwd / (1 - rate), 0.0)
    inner = (w * dw).sum(axis=-1, keepdims=True)
    ds = w * (dw - inner)
    ds_err = REL_F32 * (np.abs(ds) + w * (np.abs(dw) + (w * np.abs(dw)).sum(-1, keepdims=True)))
    dq, b_q = rounded_einsum("bhqk,bkhd->bqhd", ds, ds_err, kq)
    dk, b_k = rounded_einsum("bhqk,bqhd->bkhd", ds, ds_err, qs)
    dv, b_v = rounded_einsum("bhqk,bqhd->bkhd", wd, REL_F32 * wd, gq)
    for name, a, e, bd in zip(("out", "dq", "dk", "dv"), ours, (out, dq / 8, dk, dv),
                              (b_out, b_q / 8, b_k, b_v)):
        assert_within(a, e, bd, name)
        assert bd.max() < 0.05 * np.abs(e).max(), (name, bd.max())


# ---------------- shared tiny weights and clips ----------------


@pytest.fixture(scope="module")
def bridged():
    jmodel = JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 800)), method=JaxNomadModel.init_all)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(12)
    clean = (0.2 * rng.standard_normal((2, 1600))).astype(np.float32)
    est = clean + (0.03 * rng.standard_normal(clean.shape)).astype(np.float32)
    return params, jax_to_state_dict(params), est, clean


def port_nomad(sd, mode):
    return tapi.Nomad(device="cpu", config=Wav2Vec2Config.tiny(**PRECISION_ISLANDS[mode]),
                      emb_dim=EMB, params=sd, precision=mode)


def jax_nomad(params, mode):
    return JaxNomad(device="cpu", config=JaxConfig.tiny(**PRECISION_ISLANDS[mode]), emb_dim=EMB,
                    params=params)


# ---------------- (c) the backward's products, placed as JAX's ----------------


def jax_sites(jaxpr):
    """(site, precision) of every dot_general and convolution of a trace: a
    product ("dot", (in, out)) by its 2-D weight, a convolution ("conv", k,
    its two channel counts sorted), ("attn",) for a product of 4-D
    operands; the head's products (2-D operands) are left out. A scan's
    body counts once per step."""
    out = []
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in ("dot_general", "conv_general_dilated"):
            lhs, rhs = (tuple(v.aval.shape) for v in eqn.invars)
            prec = {JAX_PRECISION[p.name] for p in eqn.params["precision"]}
            assert len(prec) == 1, eqn
            if len(lhs) == 4:
                site = ("attn",)
            elif name == "conv_general_dilated":
                site = ("conv", rhs[0], tuple(sorted(rhs[1:])))
            elif len(lhs) == 2:
                continue
            else:
                site = ("dot", rhs)
            out.append((site, prec.pop()))
            continue
        for value in eqn.params.values():
            sub = getattr(value, "jaxpr", value)
            if hasattr(sub, "eqns"):
                out += jax_sites(sub) * (eqn.params["length"] if name == "scan" else 1)
    return out


def port_backward_sites(monkeypatch, nomad, est, clean):
    """The same multiset for the port's backward of the loss: a bf16
    product or convolution records itself in its ``Function``'s backward;
    an f32 one when the gradient reaches its output (autograd's f32
    transpose follows); an attention backward records its four transposed
    products (dP, dS K, dS^T Q, P^T dO) at its flavour's precision."""
    sites = []
    real_linear, real_conv = precision.linear, precision.conv1d

    def hook(y, site, prec):
        if prec != "default" and y.requires_grad:
            y.register_hook(lambda g: sites.append((site, prec)))
        return y

    monkeypatch.setattr(precision, "linear", lambda x, w, b, prec: hook(
        real_linear(x, w, b, prec), ("dot", (w.shape[1], w.shape[0])), prec))
    monkeypatch.setattr(precision, "conv1d", lambda x, w, b, prec, **kw: hook(
        real_conv(x, w, b, prec, **kw), ("conv", w.shape[2], tuple(sorted(w.shape[:2]))), prec))

    def spy(fn, site):
        def backward(ctx, dy):
            sites.append((site(ctx), "default"))
            return fn(ctx, dy)
        return staticmethod(backward)

    monkeypatch.setattr(precision._MatmulBF16, "backward", spy(
        precision._MatmulBF16.backward, lambda ctx: ("dot", tuple(ctx.saved_tensors[1].shape))))
    monkeypatch.setattr(precision._Conv1dBF16, "backward", spy(
        precision._Conv1dBF16.backward,
        lambda ctx: ("conv", ctx.shapes[1][2], tuple(sorted(ctx.shapes[1][:2])))))
    real_bwd = flash_attention.flash_attention_bwd

    def attention_bwd(*args):
        sites.extend([(("attn",), args[7])] * 4)
        return real_bwd(*args)

    monkeypatch.setattr(flash_attention, "flash_attention_bwd", attention_bwd)
    nomad.forward(_t(est, True), _t(clean)).backward()
    return sites


@pytest.mark.parametrize("mode", MODES)
def test_backward_products_placed_as_in_jax(bridged, monkeypatch, mode):
    """Every product and convolution that the loss's backward adds, at the
    precision ``jax.make_jaxpr(jax.grad(loss))`` gives it (the grad's
    trace less the loss's own), as a multiset of (site, precision): the
    order of autograd differs from JAX's."""
    from collections import Counter

    params, sd, est, clean = bridged
    jn = jax_nomad(params, mode)

    def loss(e):
        return jn.loss_fn(e, jnp.asarray(clean))

    fwd = Counter(jax_sites(jax.make_jaxpr(loss)(jnp.asarray(est)).jaxpr))
    grad = Counter(jax_sites(jax.make_jaxpr(jax.grad(loss))(jnp.asarray(est)).jaxpr))
    assert not fwd - grad
    theirs = grad - fwd
    ours = Counter(port_backward_sites(monkeypatch, port_nomad(sd, mode), est, clean))
    assert ours == theirs
    assert theirs[("attn",), "default"] == 4 * 2  # four per block
    assert any(p == "default" for (site, p) in theirs if site[0] == "dot")


# ---------------- (d) the loss and its gradient in a mode ----------------


def layer_signs(nomad, est, clean):
    with torch.no_grad():
        return [torch.sign(a - c).numpy() for a, c in zip(
            nomad.model.forward_layers(_t(est)), nomad.model.forward_layers(_t(clean)))]


# measured: loss 3.7e-4 (balanced) and 4.4e-4 (fast) relative to the JAX
# package's (f32 on the CPU); gradient 2.0e-3 and 2.6e-3 of max |g| under
# the port's L1 signs (84 and 98 layer elements take the other sign in
# JAX, which alone moves the direct gradient 3.1e-2); 2.5x the larger
TOL_LOSS_VS_JAX, TOL_GRAD_VS_JAX = 1.1e-3, 6.5e-3


@pytest.mark.parametrize("mode", MODES)
def test_loss_and_gradient_in_a_mode_match_jax(bridged, mode):
    """``Nomad(precision=mode).forward(est, clean)`` and its gradient on
    the CPU against the JAX ``Nomad`` of the same islands; the gradient
    under one L1 sign pattern, the port's (an element of a layer
    difference within rounding of 0 takes either sign)."""
    params, sd, est, clean = bridged
    nomad = port_nomad(sd, mode)
    e = _t(est, True)
    loss = nomad.forward(e, _t(clean))
    loss.backward()
    jn = jax_nomad(params, mode)
    jloss = float(jn.loss_fn(jnp.asarray(est), jnp.asarray(clean)))
    signs = layer_signs(nomad, est, clean)
    jmodel = jn.model
    ref = jmodel.apply(params, jnp.asarray(clean), method=JaxNomadModel.forward_layers)

    def signed(x):
        layers = jmodel.apply(params, x, method=JaxNomadModel.forward_layers)
        return sum((s * (a - c)).mean() for s, a, c in zip(signs, layers, ref))

    jgrad = np.asarray(jax.grad(signed)(jnp.asarray(est)))
    assert abs(loss.item() - jloss) <= TOL_LOSS_VS_JAX * abs(jloss)
    rel = np.abs(e.grad.numpy() - jgrad).max() / np.abs(jgrad).max()
    assert rel <= TOL_GRAD_VS_JAX, rel
    exact = tapi.Nomad(device="cpu", config=Wav2Vec2Config.tiny(), emb_dim=EMB, params=sd)
    e32 = _t(est, True)
    exact.forward(e32, _t(clean)).backward()
    assert np.abs(e32.grad.numpy() - e.grad.numpy()).max() > 1e-4 * np.abs(jgrad).max()
    assert nomad.forward(_t(clean), _t(clean)).item() == 0.0


# ---------------- (d) the triplet trainer in a mode ----------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Seeded PCM16 WAVs of unequal lengths under OPUS/MP3/NOISE and a
    triplet CSV of four rows over two db levels."""
    base = tmp_path_factory.mktemp("triplets")
    root = base / "degraded"
    rng = np.random.default_rng(31)
    for kind in ("OPUS", "MP3", "NOISE"):
        (root / kind).mkdir(parents=True)
        for i in range(4):
            write_wav(str(root / kind / f"f{i}.wav"),
                      (0.2 * rng.standard_normal(1100 + 97 * i)).astype(np.float32), 16000,
                      bits=16)
    lines = ["db,Anchor,Positive,Negative,anc_pos_dist,anc_neg_dist"]
    lines += [f"{1 + i % 2},OPUS/f{i}.wav,MP3/f{i}.wav,NOISE/f{(i + 1) % 4}.wav,0.1,0.3"
              for i in range(4)]
    (base / "train.csv").write_text("\n".join(lines) + "\n")
    return {"root": str(root) + "/", "csv": str(base / "train.csv")}


def train_config(tree, **over):
    cfg = {
        "experiment_name": "Training", "root": tree["root"],
        "train_df": tree["csv"], "valid_df": tree["csv"],
        "train_bs": 2, "val_bs": 2, "lr": 1e-3, "lr_decay_factor": 0.5,
        "lr_decay_step": 2, "num_epochs": 1, "num_workers": 2, "emb_dim": EMB,
        "patience": 5, "margin": 0.2, "freeze_convnet": True, "freeze_all": False,
        "current_level": [1, 2], "trim": True, "masked_pool": True,
        "checkpoint_path": None, "checkpoint_backend": "npz", "model_size": "tiny",
    }
    cfg.update(over)
    return cfg


RESOLVED = ("frontend_prec", "encoder_prec", "attn_score_prec", "ffn1_prec", "posconv_prec")


@pytest.mark.parametrize("size", ["tiny", "base"])
@pytest.mark.parametrize("prec", ["exact", "balanced", "fast"])
def test_training_precision_resolves_as_jax(size, prec):
    """``precision:`` picks the islands the JAX trainer picks, at each
    size: "balanced" leaves ``tiny`` as it is (the JAX trainer's rule)."""
    cfg = {"experiment_name": "quality_nmr", "model_size": size, "precision": prec}
    theirs = JaxTraining(dict(cfg), params={}).model_config
    ours = triplet.resolve_model_config(cfg)
    for prop in RESOLVED:
        assert getattr(ours, prop) == getattr(theirs, prop), prop
    assert (ours.hidden_size, ours.num_layers) == (theirs.hidden_size, theirs.num_layers)
    want = {"exact": {}, "fast": PRECISION_ISLANDS["fast"],
            "balanced": PRECISION_ISLANDS["balanced"] if size == "base" else {}}[prec]
    base = Wav2Vec2Config.tiny() if size == "tiny" else Wav2Vec2Config.base()
    assert ours == dataclasses.replace(base, **want)


def test_training_precision_refusals_and_explicit_config():
    # fast_bf16 resolves now (tests/test_torch_fast_bf16.py); its bf16 stack
    # with the fused path is refused, naming ROADMAP
    fast_bf16 = triplet.resolve_model_config({"precision": "fast_bf16"})
    assert fast_bf16.block_dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dataclasses.replace(fast_bf16, attention_impl="fused_qkv")
    with pytest.raises(ValueError, match="unknown training precision"):
        Training({"experiment_name": "quality_nmr", "model_size": "tiny",
                  "precision": "quantum"}, device="cpu")
    with pytest.raises(ValueError, match="unknown training precision"):
        JaxTraining({"experiment_name": "quality_nmr", "model_size": "tiny",
                     "precision": "quantum"}, params={})
    # an explicit model_config wins, as in the JAX trainer
    tr = Training({"experiment_name": "quality_nmr", "precision": "fast", "emb_dim": EMB},
                  device="cpu", model_config=Wav2Vec2Config.tiny())
    assert tr.model_config == Wav2Vec2Config.tiny()


@pytest.fixture(scope="module")
def jax_params():
    params = JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB).init(
        jax.random.key(3), jnp.zeros((1, 800)), method=JaxNomadModel.init_all)
    return jax.tree_util.tree_map(np.asarray, params)


# measured in one "fast" step with the rates at 0: loss 1.35e-3 relative
# to the JAX trainer's (f32 on the CPU); after Adam's first step (each
# entry moves ~lr sign(g)) max |d| 2.0e-3 (entries with g near 0 moving
# the other way) and mean |d| 8.0e-8 over all parameters; ~3x
TOL_STEP_LOSS, TOL_STEP_MEAN = 3.5e-3, 2.5e-7


def test_one_fast_train_step_matches_jax(tree, jax_params):
    """One train step at "fast" with the rates at 0 against the JAX
    trainer's ``_get_step`` on the same islands and weights: the loss, and
    the parameters after Adam within its step-1 bounds (|d| <= 2 lr + an
    ulp; a small mean |d|); frozen parameters untouched."""
    fast = PRECISION_ISLANDS["fast"]
    cfg = train_config(tree)
    jtr = JaxTraining(cfg, params=jax_params, model_config=JaxConfig.tiny(**fast, **ZERO_RATES))
    tr = Training(cfg, device="cpu", params=jax_to_state_dict(jax_params),
                  model_config=Wav2Vec2Config.tiny(**fast, **ZERO_RATES))
    batch = data.collate_triplets([tr.train_set.load_item(i) for i in (0, 1)])
    step = jtr._get_step(batch.anchor.shape, True)
    jparams, _, jloss = step(
        jtr.params, jtr.opt_state, *(jnp.asarray(getattr(batch, f.name))
                                     for f in dataclasses.fields(batch)),
        jnp.float32(jtr.lr_backbone), jnp.float32(jtr.lr_head), jax.random.key(0))
    before = state_dict_to_jax(tr.model.state_dict())
    loss = tr.train_step(batch, torch.Generator().manual_seed(0)).item()
    assert abs(loss - float(jloss)) <= TOL_STEP_LOSS * abs(float(jloss))
    ours = state_dict_to_jax(tr.model.state_dict())
    theirs = _flatten(jax.device_get(jparams["params"]))
    total, count = 0.0, 0
    for key, want in theirs.items():
        d = np.abs(ours[key] - want)
        assert d.max() <= 2 * 1e-3 * (1 + 1e-5), (key, d.max())
        total, count = total + d.sum(), count + d.size
        if key.startswith("lossnet_embedding") or "feature_encoder" in key:
            np.testing.assert_array_equal(ours[key], before[key])
    assert total / count < TOL_STEP_MEAN, total / count


@pytest.mark.parametrize("prec", MODES)
def test_training_mixed_precision_trajectory(tree, prec):
    """Mirror of the JAX package's ``test_training_mixed_precision_trajectory``
    (``tests/test_training.py``): an epoch with dropout in the mode lands
    within 0.05 of "exact"'s loss, and the eval step runs in the mode."""
    cfg = train_config(tree)
    exact = Training(dict(cfg, precision="exact"), device="cpu")
    mixed = Training(dict(cfg, precision=prec), device="cpu")
    if prec == "fast":
        assert mixed.model_config.encoder_prec == "default"
    else:  # "balanced" leaves tiny as it is, as the JAX trainer does
        assert mixed.model_config == exact.model_config
    l_exact = exact.train(rng_seed=0)
    l_mixed = mixed.train(rng_seed=0)
    assert np.isfinite(l_mixed)
    assert abs(l_mixed - l_exact) < 0.05
    assert np.isfinite(mixed.eval())


def test_dispatcher_passes_the_training_precision(tree, tmp_path, monkeypatch):
    """``python -m nomad_tpu_torch.main --config_file`` with ``precision:
    fast``: the Training it builds trains in the mode."""
    seen = []
    monkeypatch.setattr(triplet.Training, "training_loop",
                        lambda self: seen.append(self.model_config))
    path = str(tmp_path / "c.yaml")
    config_io.dump(train_config(tree, precision="fast"), path)
    dispatch.main(["--config_file", path, "--device", "cpu"])
    assert seen == [dataclasses.replace(Wav2Vec2Config.tiny(**PRECISION_ISLANDS["fast"]),
                                        frontend_stop_gradient=True, remat=True)]


def test_dropout_under_a_bf16_island_trains(bridged):
    """Dropout under "balanced" (formerly refused): a forward with
    ``deterministic=False`` differs from the deterministic one, is
    reproducible for a generator seed, and has gradients."""
    _, sd, est, _ = bridged
    model = NomadModel(Wav2Vec2Config.tiny(**PRECISION_ISLANDS["balanced"]), emb_dim=EMB)
    model.load_state_dict(sd)
    wave = _t(est[:, :800])
    a = model(wave, deterministic=False, generator=torch.Generator().manual_seed(1))
    b = model(wave, deterministic=False, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert (a - model(wave)).abs().max() > 1e-4
    a.sum().backward()
    block = model.backbone.encoder.layers[0]
    for p in (block.fc1.weight, block.q_proj.weight, model.backbone.encoder.pos_conv.conv.weight):
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0


# ---------------- (d) the SE demo with a lossnet in a mode ----------------


def se_dirs(base, rng):
    """Two noisy/clean PCM16 pairs per split, 20,000 and 12,000 samples."""
    dirs = {}
    for split in ("train", "valid", "test"):
        for kind in ("noisy", "clean"):
            (base / f"{kind}_{split}").mkdir()
        for i, n in enumerate((20000, 12000)):
            clean = (0.2 * rng.standard_normal(n)).astype(np.float32)
            write_wav(str(base / f"clean_{split}" / f"p{i}.wav"), clean, 16000, bits=16)
            write_wav(str(base / f"noisy_{split}" / f"p{i}.wav"),
                      clean + (0.05 * rng.standard_normal(n)).astype(np.float32), 16000, bits=16)
        dirs |= {f"noisy_{split}_dir": str(base / f"noisy_{split}"),
                 f"clean_{split}_dir": str(base / f"clean_{split}")}
    return dirs


# measured in one SE step at nomad_weight 10 through a "balanced" lossnet
# against the JAX SE's (f32 on the CPU): loss 5.8e-5 relative, U-Net
# gradients 2.1e-2 of max |g| (L1 signs that flip included); ~2.5x
TOL_SE_LOSS, TOL_SE_GRAD = 1.5e-4, 0.05


def test_se_step_through_a_balanced_lossnet(tmp_path, bridged):
    """One SE train step with the lossnet at "balanced" (the JAX SE's own
    default lossnet): the loss and the U-Net's gradients against the JAX
    SE's step on the same weights and islands, the lossnet unchanged."""
    from nomad_tpu.training import se as jse_module
    from nomad_tpu_torch.convert import waveunet_to_jax

    params, sd, _, _ = bridged
    cfg = se_dirs(tmp_path, np.random.default_rng(17)) | {
        "train_bs": 2, "valid_bs": 2, "test_bs": 2, "lr": 1e-3, "nomad_weight": 10.0,
        "target_sr": 16000, "n_layers": 3, "loss_dropout": False}
    jse = jse_module.SpeechEnhancement(dict(cfg), nomad=jax_nomad(params, "balanced"))
    init = _flatten(jax.device_get({"params": jse.params, "batch_stats": jse.batch_stats}))
    nomad = port_nomad(sd, "balanced")
    ours = SpeechEnhancement(cfg, device="cpu", nomad=nomad)
    ours.load_flat(init)
    noisy, clean = next(ours.train_set.batches(2, shuffle=False))
    jse.nomad_weight = 10.0
    jgrads = jax.grad(jse._loss, has_aux=True)(
        jse.params, jse.batch_stats, jse._nomad_params_dev(), noisy, clean, jax.random.key(0))
    jloss = float(jse._loss(jse.params, jse.batch_stats, jse._nomad_params_dev(), noisy, clean,
                            jax.random.key(0))[0])
    lossnet = {k: v.clone() for k, v in nomad.model.state_dict().items()}
    loss = ours.train_step(noisy, clean).item()
    assert abs(loss - jloss) <= TOL_SE_LOSS * abs(jloss)
    grads = waveunet_to_jax({n: p.grad for n, p in ours.unet.named_parameters()})
    want = _flatten({"params": jax.device_get(jgrads[0])})
    gmax = max(np.abs(g).max() for g in want.values())
    worst = max(np.abs(grads[k] - g).max() for k, g in want.items()) / gmax
    assert worst <= TOL_SE_GRAD, worst
    assert all(torch.equal(v, lossnet[k]) for k, v in nomad.model.state_dict().items())
