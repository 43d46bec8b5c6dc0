"""The port's differentiable NOMAD loss against the JAX package's.

Seeded numpy inputs go through both sides. On the JAX side the flash
attention backward runs its Pallas kernels K2 and K3 in interpret mode on
the CPU; on the port's side the autograd Functions take their plain
versions, because the tensors lie on the CPU. The kernel-vs-plain checks
on the card are in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.api import Nomad as JaxNomad
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
from nomad_tpu.models.heads import nomad_loss as jax_nomad_loss
from nomad_tpu.models.wav2vec2 import MaskedGroupNorm as JaxMaskedGroupNorm
from nomad_tpu.ops.flash_attention import mha_pallas
from nomad_tpu.ops.layernorm import layer_norm_xla
from nomad_tpu_torch.api import Nomad
from nomad_tpu_torch.convert import jax_to_state_dict
from nomad_tpu_torch.models import MaskedGroupNorm, Wav2Vec2Config, nomad_loss
from nomad_tpu_torch.ops import FlashAttention, flash_attention, layer_norm, layernorm

torch.set_num_threads(2)

EMB = 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_attention_grads(q, k, v, lengths, do):
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    o = FlashAttention.apply(qt, kt, vt, torch.tensor(lengths, dtype=torch.int32))
    o.backward(_t(do))
    return o.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()


# ---------------- flash attention backward (K2 + K3's plain version) ----------------


@pytest.mark.parametrize("lengths", [[256, 131], [200, 1]])
def test_flash_backward_matches_pallas_vjp(lengths):
    """dQ, dK, dV of the autograd Function on the CPU against jax.vjp of
    mha_pallas, whose backward runs K2 and K3 in interpret mode."""
    rng = np.random.default_rng(sum(lengths))
    b, t, h, d = 2, 256, 2, 64
    q, k, v, do = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4))
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    before = (flash_attention.launches, flash_attention.launches_bwd_dq,
              flash_attention.launches_bwd_dkv)
    o, dq, dk, dv = _port_attention_grads(q, k, v, lengths, do)
    assert (flash_attention.launches, flash_attention.launches_bwd_dq,
            flash_attention.launches_bwd_dkv) == before  # no kernel on the CPU
    ref_o, vjp = jax.vjp(
        lambda q_, k_, v_: mha_pallas(q_, k_, v_, jnp.asarray(mask), block_q=128,
                                      block_k=128, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    # 2e-5: f32 sums over up to 256 keys or queries of unit-scale terms, in
    # another order than Pallas' blocked dots; plus 2e-6 relative, since a
    # row with one valid key has P = 1 for every query and its dV sums 256
    # rows of dO (|dV| ~ 20, where an f32 ulp is 2e-6)
    np.testing.assert_allclose(o, np.asarray(ref_o), atol=2e-5, rtol=0)
    for ours, theirs in zip((dq, dk, dv), ref):
        np.testing.assert_allclose(ours, theirs, atol=2e-5, rtol=2e-6)
    for i, n in enumerate(lengths):
        assert np.all(dk[i, n:] == 0) and np.all(dv[i, n:] == 0)


def test_flash_backward_zero_length_row_and_nan_past_the_bound():
    """A row with no valid key gets zero gradients (its LSE of -1e30 never
    enters exp), and a NaN in a padded key or value row reaches no
    gradient, while padded query rows still feed dK and dV."""
    rng = np.random.default_rng(9)
    b, t, h, d = 2, 70, 2, 64
    q, k, v, do = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4))
    k[0, 40:] = np.nan
    v[0, 40:] = np.nan
    _, dq, dk, dv = _port_attention_grads(q, k, v, [40, 0], do)
    assert np.isfinite(dq).all() and np.isfinite(dk).all() and np.isfinite(dv).all()
    assert np.all(dq[1] == 0) and np.all(dk[1] == 0) and np.all(dv[1] == 0)
    assert np.all(dk[0, 40:] == 0) and np.all(dv[0, 40:] == 0)
    # dO of the padded query rows alone moves dV of the valid keys
    do_pad = np.zeros_like(do)
    do_pad[0, 40:] = do[0, 40:]
    _, _, _, dv_pad = _port_attention_grads(q, k, v, [40, 0], do_pad)
    assert np.abs(dv_pad[0, :40]).max() > 1e-3


# ---------------- LayerNorm backward ----------------


@pytest.mark.parametrize("width", [512, 768])
def test_layer_norm_backward_matches_jax_vjp(width):
    rng = np.random.default_rng(width + 1)
    x = (3.0 * rng.standard_normal((5, 37, width)) + 1.5).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(width)).astype(np.float32)
    bias = rng.standard_normal(width).astype(np.float32)
    g = rng.standard_normal((5, 37, width)).astype(np.float32)
    xt, st, bt = (_t(a).requires_grad_() for a in (x, scale, bias))
    before = layernorm.launches
    y = layer_norm(xt, st, bt)
    y.backward(_t(g))
    assert layernorm.launches == before
    ref_y, vjp = jax.vjp(lambda a, s, c: layer_norm_xla(a, s, c), jnp.asarray(x),
                         jnp.asarray(scale), jnp.asarray(bias))
    dx, ds, db = (np.asarray(r) for r in vjp(jnp.asarray(g)))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y), atol=1e-6, rtol=1e-6)
    # dx ~ rstd * g with rstd ~ 1/3: 1e-6 covers the closed form against
    # XLA's chain rule; dscale and dbias sum 185 rows of |g * x_hat| ~ 1,
    # so one f32 ulp of the sum is ~1e-6 and the orders differ
    np.testing.assert_allclose(xt.grad.numpy(), dx, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(st.grad.numpy(), ds, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), db, atol=1e-5, rtol=1e-5)


# ---------------- MaskedGroupNorm ----------------


@pytest.mark.parametrize("lengths", [None, [120, 77, 5]])
def test_masked_group_norm_grad_matches_jax(lengths):
    """Output and gradients w.r.t. x, scale and bias against jax.vjp of the
    JAX module ([B, T, C] there, [B, C, T] here)."""
    rng = np.random.default_rng(11)
    b, c, t = 3, 8, 120
    x = (2.0 * rng.standard_normal((b, c, t)) + 0.5).astype(np.float32)
    w = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    g = rng.standard_normal((b, c, t)).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    gn = MaskedGroupNorm(c)
    with torch.no_grad():
        gn.weight.copy_(_t(w))
        gn.bias.copy_(_t(bias))
    xt = _t(x).requires_grad_()
    y = gn(xt, None if lens is None else _t(lens).long())
    y.backward(_t(g))
    assert np.array_equal(xt.detach().numpy(), x)  # out of place under autograd

    jmod = JaxMaskedGroupNorm(c)
    params = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(bias)}}

    def f(xx, p):
        return jmod.apply(p, xx, None if lens is None else jnp.asarray(lens))

    ref_y, vjp = jax.vjp(f, jnp.asarray(x.transpose(0, 2, 1)), params)
    dx, dp = vjp(jnp.asarray(g.transpose(0, 2, 1)))
    # 2e-6: per-channel statistics over <= 120 frames of |x| ~ 2, then
    # x_hat ~ 1; the masked sums are batched mat-vec products here
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y).transpose(0, 2, 1),
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx).transpose(0, 2, 1),
                               atol=2e-6, rtol=0)
    # parameter gradients sum up to 360 products of unit scale
    np.testing.assert_allclose(gn.weight.grad.numpy(), np.asarray(dp["params"]["scale"]),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(gn.bias.grad.numpy(), np.asarray(dp["params"]["bias"]),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("lengths", [None, [50, 31]])
def test_masked_group_norm_in_place_without_autograd(lengths):
    """Under inference_mode (and with nothing requiring a gradient) the
    input buffer is normalised in place; the out-of-place path taken under
    autograd gives the same bits."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 6, 50)).astype(np.float32)
    lens = None if lengths is None else torch.tensor(lengths)
    gn = MaskedGroupNorm(6)
    with torch.no_grad():
        gn.weight.copy_(_t(1 + 0.1 * rng.standard_normal(6).astype(np.float32)))
    gn.requires_grad_(False)
    grad_out = gn(_t(x).requires_grad_(), lens)
    for mode in (torch.inference_mode, torch.no_grad):
        with mode():
            buf = _t(x)
            out = gn(buf, lens)
        assert out.data_ptr() == buf.data_ptr()
        assert torch.equal(out, grad_out.detach())
    buf = _t(x)  # grad mode on, nothing requires a gradient: in place too
    assert gn(buf, lens).data_ptr() == buf.data_ptr()


# ---------------- the loss ----------------


@pytest.mark.parametrize("with_lengths", [False, True])
def test_nomad_loss_matches_jax(with_lengths):
    rng = np.random.default_rng(13)
    ref = [rng.standard_normal((2, 9, 4)).astype(np.float32) for _ in range(3)]
    ref.append(rng.standard_normal((2, 5)).astype(np.float32))  # the embedding
    test = [r + 0.1 * rng.standard_normal(r.shape).astype(np.float32) for r in ref]
    fl = np.array([9, 4]) if with_lengths else None
    ours = nomad_loss([_t(r) for r in ref], [_t(x) for x in test],
                      None if fl is None else _t(fl))
    theirs = jax_nomad_loss([jnp.asarray(r) for r in ref], [jnp.asarray(x) for x in test],
                            None if fl is None else jnp.asarray(fl))
    assert ours.dtype == torch.float32 and ours.ndim == 0
    np.testing.assert_allclose(ours.item(), float(theirs), rtol=1e-6)


@pytest.fixture(scope="module")
def loss_pair():
    """The JAX Nomad on its Pallas path (K1/K2/K3/K5 in interpret mode) and
    the port's Nomad on the CPU, on the same bridged tiny weights, plus a
    seeded [2, 1, 1600] clean/estimate pair."""
    rng = np.random.default_rng(14)
    clean = (0.3 * rng.standard_normal((2, 1, 1600))).astype(np.float32)
    est = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    jcfg = JaxConfig.tiny(attention_impl="pallas", layernorm_impl="pallas")
    params = JaxNomadModel(jcfg, emb_dim=EMB).init(
        jax.random.key(1), jnp.asarray(clean[:1, 0, :800]), method=JaxNomadModel.init_all)
    params = jax.tree_util.tree_map(np.asarray, params)
    jnomad = JaxNomad(device="cpu", config=jcfg, emb_dim=EMB, params=params)
    nomad = Nomad(device="cpu", config=Wav2Vec2Config.tiny(), emb_dim=EMB,
                  params=jax_to_state_dict(params))
    return jnomad, nomad, clean, est


def test_loss_fn_value_and_gradient_match_jax(loss_pair):
    jnomad, nomad, clean, est = loss_pair
    j_loss, j_grad = jax.value_and_grad(lambda e: jnomad.loss_fn(e, jnp.asarray(clean)))(
        jnp.asarray(est))
    e = _t(est).requires_grad_()
    loss = nomad.loss_fn(e, _t(clean))
    loss.backward()
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert not any(p.requires_grad for p in nomad.model.parameters())  # frozen
    # 1e-5 relative: 13 means of f32 layer differences, each ~1e-7 apart
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    g, jg = e.grad.numpy(), np.asarray(j_grad)
    assert g.shape == est.shape and np.isfinite(g).all()
    # 1e-4 of max|g|: back through two blocks and the conv frontend in f32;
    # an L1 element within rounding of zero could flip its subgradient
    assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max()


def test_forward_shapes_and_identity(loss_pair):
    _, nomad, clean, est = loss_pair
    flat = nomad.forward(est[:, 0], clean[:, 0])  # [B, T] numpy in
    assert flat.item() == nomad.forward(_t(est), _t(clean)).item()
    assert nomad.forward(_t(clean), _t(clean)).item() == 0.0
    # the estimate's branch runs out of place under autograd, the clean
    # one in place: the same bits all the same
    x = _t(clean).requires_grad_()
    assert nomad.forward(x, _t(clean)).item() == 0.0
    with pytest.raises(NotImplementedError, match="dropout loss.*not supported"):
        nomad.loss_fn(_t(est), _t(clean), deterministic=False)
    with pytest.raises(ValueError, match="waveforms"):
        nomad.forward(_t(est[0, 0]), _t(clean[0, 0]))
