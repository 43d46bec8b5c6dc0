"""The fused path at "high" against the JAX package's "high3" mode.

The JAX package's fused kernel runs "high3" at its default matmul
precision "high" (``nomad_tpu/models/wav2vec2.py:481``): each of its five
products is three DEFAULT bf16 passes on hi/lo splits of the operands
(``_dot``, ``nomad_tpu/ops/fused_attention.py:65-90``). The port computes
the same at "high" inside the fused kernel (K4h on the card; here, on CPU
tensors, the plain version). Seeded numpy inputs go through both sides;
the JAX side runs its Pallas kernels in interpret mode. The card's checks
of K4h against this plain version are in ``test_torch_cuda.py``.
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
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config, feature_frame_lengths
from nomad_tpu_torch.ops import fused_attention
from nomad_tpu_torch.ops import precision as prec_ops

torch.set_num_threads(2)

H, HD = 2, 64
DM = H * HD
EMB = 16
LENGTHS = [1900, 1333, 800]
MM = (((1,), (0,)), ((), ()))  # jax.lax.dot_general's plain [M, K] x [K, N]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------- one product ----------------


@pytest.mark.parametrize("m,k,n,seed", [(64, 128, 64, 0), (50, 768, 64, 1), (130, 64, 130, 2)])
def test_high3_product_matches_jax_dot(m, k, n, seed):
    """``precision.matmul_high3`` against ``_dot(a, b, mm, "high3")``: its
    splits bit-equal to JAX's, and the product at most a tenth as far from
    JAX's as the f32 product is (the same three bf16 passes summed in f32
    in another order, against the dropped lo.lo term of every product)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / k**0.5).astype(np.float32)
    hi, lo = prec_ops.split_bf16(_t(a))
    a_hi = jnp.asarray(a).astype(jnp.bfloat16)
    a_lo = (jnp.asarray(a) - a_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(a_hi.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(a_lo.astype(jnp.float32)))
    theirs = np.asarray(jfa._dot(a, b, MM, "high3"))
    ours = prec_ops.matmul_high3(_t(a), _t(b)).numpy()
    d_ours = np.abs(ours - theirs).max()
    d_f32 = np.abs(a @ b - theirs).max()
    assert d_f32 > 0 and d_ours <= 0.1 * d_f32, (d_ours, d_f32)


# ---------------- the kernel's plain version ----------------


def _weights(rng):
    """(w [out, in], bias) of q, k and v at the seeded init's scale."""
    return [((rng.standard_normal((DM, DM)) / DM**0.5).astype(np.float32),
             (0.1 * rng.standard_normal(DM)).astype(np.float32)) for _ in range(3)]


def _jax_heads(x, wb, lengths, mode):
    """``_fused_call`` in interpret mode as ``_fused_fwd_impl`` calls it: O
    head-major [B, H, T, hd] in x's dtype."""
    b, t, dm = x.shape
    t_pad = jfa._round_up(t, 128)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, t_pad - t), (0, 0)))
    hw = [jnp.asarray(w.T).reshape(dm, H, HD).transpose(1, 0, 2) for w, _ in wb]
    hb = [jnp.asarray(bias).reshape(H, 1, HD) for _, bias in wb]
    return np.asarray(jfa._fused_call(xp, *hw, *hb, jnp.asarray(lengths, jnp.int32), H,
                                      jfa._block_q_for(t_pad), mode, True)[:, :, :t])


@pytest.mark.parametrize("io", ["f32", "bf16"])
@pytest.mark.parametrize("t,lengths", [(50, [50, 50]), (130, [130, 113]), (256, [256, 256])])
def test_plain_high_matches_jax_high3(t, lengths, io):
    """``fused_qkv_mha`` at "high" on CPU tensors against ``_fused_kernel``
    at mode "high3" (every row t < T, padded rows included) within
    ``test_torch_fused.py``'s 2e-5 + 1e-5 relative (f32 sums in another
    order, and the bf16 splits that order flips), and at an RMS distance at
    most half the f32 "highest" plain version's (measured: 0.19-0.29 of
    it; the largest element of either may be a flip). "bf16": x rounded to bf16, so
    that x's lo plane is 0 on both sides; the bf16-I/O flavour's O is the
    f32 flavour's on the upcast x rounded once, bit for bit, and within
    one bf16 step of the JAX kernel's bf16 O beyond the two f32 results'
    distance."""
    rng = np.random.default_rng(t)
    x = (rng.standard_normal((len(lengths), t, DM))).astype(np.float32)
    if io == "bf16":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    wb = _weights(rng)
    params = [_t(a) for pair in wb for a in pair]
    lens = torch.tensor(lengths, dtype=torch.int32)
    before = (fused_attention.launches_high3, fused_attention.launches)
    ours = fused_attention.fused_qkv_mha(_t(x), *params, lens, H, "high")
    assert (fused_attention.launches_high3, fused_attention.launches) == before  # the CPU
    assert ours.shape == (len(lengths), H, t, HD) and torch.isfinite(ours).all()
    theirs = _jax_heads(x, wb, lengths, "high3")
    np.testing.assert_allclose(ours.numpy(), theirs, atol=2e-5, rtol=1e-5)
    f32 = fused_attention.fused_qkv_mha(_t(x), *params, lens, H, "highest").numpy()
    rms = [np.sqrt(np.mean(np.square(a - theirs))) for a in (ours.numpy(), f32)]
    assert rms[0] <= 0.5 * rms[1], rms
    if io == "bf16":
        xb = _t(x).to(torch.bfloat16)
        ours_b = fused_attention.fused_qkv_mha(xb, *params, lens, H, "high")
        assert ours_b.dtype == torch.bfloat16 and torch.equal(ours_b, ours.to(torch.bfloat16))
        theirs_b = _jax_heads(jnp.asarray(x).astype(jnp.bfloat16), wb, lengths,
                              "high3").astype(np.float32)
        gap = np.abs(ours.numpy() - theirs).astype(np.float64)
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(theirs_b), 1e-30))) - 7)
        assert (np.abs(ours_b.float().numpy() - theirs_b) <= gap + step).all()


@pytest.mark.parametrize("t,lengths", [(200, [200, 137]), (600, [600])])
def test_sublayer_at_high_matches_jax_high3(t, lengths):
    """The whole sublayer, ``fused_qkv_attention`` at "high" (the
    out-projection an f32 product: XLA's HIGH off the TPU) against
    ``fused_qkv_attention(mode="high3")``; its 0-key and padded rows
    included."""
    rng = np.random.default_rng(t + 1)
    x = (0.3 * rng.standard_normal((len(lengths), t, DM))).astype(np.float32)
    ws = [(0.1 * rng.standard_normal((DM, DM))).astype(np.float32) for _ in range(4)]
    bs = [(0.05 * rng.standard_normal(DM)).astype(np.float32) for _ in range(4)]
    key_mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    theirs = np.asarray(jfa.fused_qkv_attention(
        x, *(a for w, b in zip(ws, bs) for a in (w, b)), key_mask=key_mask, heads=H,
        mode="high3", interpret=True))
    ours = fused_attention.fused_qkv_attention(
        _t(x), *(a for w, b in zip(ws, bs) for a in (_t(w.T), _t(b))), key_mask=_t(key_mask),
        heads=H, precision="high").numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-5, rtol=1e-5)


def test_gradients_at_high_match_jax():
    """d/dx and d/dWq through ``FusedQKVAttention``'s backward at "high"
    (the unfused recompute in f32) against jax.grad through the custom_vjp
    at "high3", whose backward is ``_unfused_ref``'s vjp at HIGH."""
    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal((2, 200, DM))).astype(np.float32)
    ws = [(0.1 * rng.standard_normal((DM, DM))).astype(np.float32) for _ in range(4)]
    bs = [(0.05 * rng.standard_normal(DM)).astype(np.float32) for _ in range(4)]
    key_mask = np.arange(200)[None, :] < np.array([200, 137])[:, None]

    def loss(x_, wq):
        return jnp.sum(jfa.fused_qkv_attention(
            x_, wq, bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3], key_mask=key_mask,
            heads=H, mode="high3", interpret=True) ** 2)

    jx, jw = jax.grad(loss, argnums=(0, 1))(x, ws[0])
    params = [a for w, b in zip(ws, bs) for a in (_t(w.T), _t(b))]
    xt, wq = _t(x).requires_grad_(), params[0].requires_grad_()
    out = fused_attention.fused_qkv_attention(xt, wq, *params[1:], key_mask=_t(key_mask),
                                              heads=H, precision="high")
    (out**2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jx), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(wq.grad.numpy(), np.asarray(jw).T, atol=1e-4, rtol=1e-4)


# ---------------- the model and the loss at the default "high" ----------------


@pytest.fixture(scope="module")
def bridged():
    """The JAX tiny model on its fused path at its default precision
    ("high": the fused kernel at "high3", the other products f32 on the
    CPU; K4 and K5 in interpret mode) and the port's, on the same weights
    through the bridge."""
    jcfg = JaxConfig.tiny(attention_impl="fused_qkv", layernorm_impl="pallas")
    assert jcfg.matmul_precision == "high"
    rng = np.random.default_rng(19)
    wav = np.zeros((len(LENGTHS), max(LENGTHS)), np.float32)
    for i, n in enumerate(LENGTHS):
        wav[i, :n] = 0.3 * rng.standard_normal(n)
    params = JaxNomadModel(jcfg, emb_dim=EMB).init(
        jax.random.key(3), jnp.asarray(wav[:1, :800]), method=JaxNomadModel.init_all)
    params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, jax_to_state_dict(params), wav


def test_model_at_high_matches_jax_high3(bridged):
    """``Wav2Vec2Config.tiny(attention_impl="fused_qkv")`` at its default
    "high": every layer and the embeddings against the JAX model within
    2e-5 (``test_torch_fused.py``'s tolerance), and nearer the JAX model's
    embeddings than the same model at "highest" in the fused kernel."""
    jcfg, params, sd, wav = bridged
    jmodel = JaxNomadModel(jcfg, emb_dim=EMB)
    lengths = np.asarray(LENGTHS, np.int32)
    j_layers = jmodel.apply(params, jnp.asarray(wav), jnp.asarray(lengths),
                            method=JaxNomadModel.forward_layers)
    j_emb = np.asarray(jmodel.apply(params, jnp.asarray(wav), jnp.asarray(lengths)))
    config = Wav2Vec2Config.tiny(attention_impl="fused_qkv")
    assert config.encoder_prec == "high"
    model = NomadModel(config, emb_dim=EMB)
    model.load_state_dict(sd, strict=True)
    t_wav, t_len = _t(wav), _t(lengths).long()
    with torch.inference_mode():
        layers = model.forward_layers(t_wav, t_len)
        emb = model(t_wav, t_len).numpy()
    frames = feature_frame_lengths(lengths, model.config)
    for i in range(model.config.num_layers):
        ours, ref = layers[i].numpy(), np.asarray(j_layers[i])
        for b, n in enumerate(frames):
            np.testing.assert_allclose(ours[b, :n], ref[b, :n], atol=2e-5, rtol=0)
    np.testing.assert_allclose(emb, j_emb, atol=2e-5, rtol=0)
    highest = NomadModel(Wav2Vec2Config.tiny(attention_impl="fused_qkv",
                                             encoder_precision="highest"), emb_dim=EMB)
    highest.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        emb_f32 = highest(t_wav, t_len).numpy()
    assert np.abs(emb - j_emb).max() <= np.abs(emb_f32 - j_emb).max()


def test_loss_at_high_matches_jax_high3(bridged):
    """The loss and its input gradient through the fused path at "high"
    against the JAX model's at its default, within ``test_torch_fused.py``'s
    tolerances (1e-5 relative on the loss, 1e-4 of max |g|)."""
    jcfg, params, sd, _ = bridged
    rng = np.random.default_rng(20)
    clean = (0.3 * rng.standard_normal((2, 1, 1600))).astype(np.float32)
    est = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    jnomad = JaxNomad(device="cpu", config=jcfg, emb_dim=EMB, params=params)
    j_loss, j_grad = jax.value_and_grad(lambda e: jnomad.loss_fn(e, jnp.asarray(clean)))(
        jnp.asarray(est))
    nomad = Nomad(device="cpu", config=Wav2Vec2Config.tiny(attention_impl="fused_qkv"),
                  emb_dim=EMB, params=sd)
    e = _t(est).requires_grad_()
    loss = nomad.forward(e, _t(clean))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    g, jg = e.grad.numpy(), np.asarray(j_grad)
    assert g.shape == est.shape and np.isfinite(g).all()
    assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max()
