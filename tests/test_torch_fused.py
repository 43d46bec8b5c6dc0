"""The port's projection-fused attention path against the JAX package's.

Seeded numpy inputs go through both sides. On the JAX side the fused
kernel K4 runs in interpret mode on the CPU at mode "highest" (f32); on the
port's side the wrappers take their plain versions, because the tensors
lie on the CPU. The port takes JAX's [in, out] weights transposed to
``nn.Linear``'s [out, in]. The kernel-vs-plain checks on the card are in
``test_torch_cuda.py``.
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

torch.set_num_threads(2)

H, DM = 4, 64  # head width 16
EMB = 16
LENGTHS = [1900, 1333, 800]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _inputs(seed, b, t):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, DM)).astype(np.float32) * 0.3
    ws = [rng.standard_normal((DM, DM)).astype(np.float32) * 0.1 for _ in range(4)]
    bs = [rng.standard_normal((DM,)).astype(np.float32) * 0.05 for _ in range(4)]
    return x, ws, bs


def _port_params(ws, bs):
    """JAX's (w [in, out], b) pairs -> the port's wq, bq, ..., wo, bo."""
    return [a for w, b in zip(ws, bs) for a in (_t(w.T), _t(b))]


def _jax(x, ws, bs, key_mask):
    return np.asarray(jfa.fused_qkv_attention(
        x, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3],
        key_mask=key_mask, heads=H, mode="highest", interpret=True))


def _port(x, ws, bs, key_mask):
    return fused_attention.fused_qkv_attention(
        _t(x), *_port_params(ws, bs), key_mask=None if key_mask is None else _t(key_mask),
        heads=H).numpy()


# ---------------- the sublayer and K4's plain version ----------------


@pytest.mark.parametrize("t,lengths", [(200, [200, 137]), (600, [600]), (770, [770])])
def test_fused_attention_matches_jax(t, lengths):
    """The sublayer, and the head-major output of the plain version against
    the Pallas K4's (``_fused_call``, every row t < T, padded rows
    included); T = 600 and 770 are the ragged q-block cases that once left
    rows uncomputed on the JAX side."""
    x, ws, bs = _inputs(t, len(lengths), t)
    key_mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    before = fused_attention.launches
    out = _port(x, ws, bs, key_mask)
    assert fused_attention.launches == before  # no kernel on the CPU
    assert np.isfinite(out).all()
    # 2e-5: f32 products of 64-wide rows and a softmax over <= 770 keys, in
    # another order than the interpreted Pallas dots
    np.testing.assert_allclose(out, _jax(x, ws, bs, key_mask), atol=2e-5, rtol=1e-5)

    hd, t_pad = DM // H, -(-t // 128) * 128
    per_head = [w.reshape(DM, H, hd).transpose(1, 0, 2) for w in ws[:3]]
    j_heads = np.asarray(jfa._fused_call(
        jnp.pad(x, ((0, 0), (0, t_pad - t), (0, 0))), *per_head,
        *(b.reshape(H, 1, hd) for b in bs[:3]), jnp.asarray(lengths, jnp.int32), H,
        jfa._block_q_for(t_pad), "highest", True))[:, :, :t]
    heads = fused_attention.fused_qkv_mha(
        _t(x), *_port_params(ws[:3], bs[:3]), torch.tensor(lengths, dtype=torch.int32), H)
    assert heads.shape == (len(lengths), H, t, hd)
    np.testing.assert_allclose(heads.numpy(), j_heads, atol=2e-5, rtol=1e-5)


def test_garbage_past_the_bound_changes_no_valid_row():
    x, ws, bs = _inputs(3, 2, 200)
    key_mask = np.arange(200)[None, :] < np.array([200, 137])[:, None]
    out1 = _port(x, ws, bs, key_mask)
    x2 = x.copy()
    x2[1, 137:] = 123.0
    out2 = _port(x2, ws, bs, key_mask)
    np.testing.assert_allclose(out2[1, :137], out1[1, :137], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out2[0], out1[0])


def test_long_input_takes_the_unfused_route(monkeypatch):
    """T = 1100 > MAX_FUSED_T: the unfused composition (attention through
    ``mha(impl="kernel")``), against JAX's ``_unfused_ref``."""
    assert fused_attention.fused_supported(1024) and not fused_attention.fused_supported(1025)

    def refuse(*args):
        raise AssertionError("the fused route ran past MAX_FUSED_T")

    monkeypatch.setattr(fused_attention.FusedQKVAttention, "apply", refuse)
    x, ws, bs = _inputs(11, 1, 1100)
    key_mask = np.arange(1100)[None, :] < 1000
    ref = np.asarray(jfa._unfused_ref(x, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3],
                                      bs[3], key_mask, heads=H, mode="highest"))
    np.testing.assert_allclose(_port(x, ws, bs, key_mask), ref, atol=2e-5, rtol=1e-5)


def test_gradients_match_jax():
    """d/dx and d/dWq of sum(out^2) through ``FusedQKVAttention``'s backward
    (the unfused recompute) against jax.grad through the custom_vjp."""
    x, ws, bs = _inputs(3, 2, 200)
    key_mask = np.arange(200)[None, :] < np.array([200, 137])[:, None]

    def loss(x_, wq):
        return jnp.sum(jfa.fused_qkv_attention(
            x_, wq, bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3],
            key_mask=key_mask, heads=H, mode="highest", interpret=True) ** 2)

    jx, jw = jax.grad(loss, argnums=(0, 1))(x, ws[0])
    params = _port_params(ws, bs)
    xt, wq = _t(x).requires_grad_(), params[0].requires_grad_()
    out = fused_attention.fused_qkv_attention(xt, wq, *params[1:], key_mask=_t(key_mask),
                                              heads=H)
    (out**2).sum().backward()
    assert params[2].grad is None  # only what requires a gradient gets one
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jx), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(wq.grad.numpy(), np.asarray(jw).T, atol=1e-4, rtol=1e-4)


# ---------------- the model and the loss ----------------


@pytest.fixture(scope="module")
def bridged():
    """The JAX tiny model on its fused path (K4 and K5 in interpret mode,
    f32 products) and the port's, on the same weights through the
    bridge. The port's fused kernel runs at "highest" too (its default
    "high" is the TPU kernel's "high3": ``test_torch_fused_high3.py``)."""
    jcfg = JaxConfig.tiny(attention_impl="fused_qkv", matmul_precision="highest",
                          layernorm_impl="pallas")
    rng = np.random.default_rng(15)
    wav = np.zeros((len(LENGTHS), max(LENGTHS)), np.float32)
    for i, n in enumerate(LENGTHS):
        wav[i, :n] = 0.3 * rng.standard_normal(n)
    params = JaxNomadModel(jcfg, emb_dim=EMB).init(
        jax.random.key(2), jnp.asarray(wav[:1, :800]), method=JaxNomadModel.init_all)
    params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, jax_to_state_dict(params), wav


def test_model_layers_and_embedding_match_jax(bridged):
    jcfg, params, sd, wav = bridged
    jmodel = JaxNomadModel(jcfg, emb_dim=EMB)
    lengths = np.asarray(LENGTHS, np.int32)
    j_layers = jmodel.apply(params, jnp.asarray(wav), jnp.asarray(lengths),
                            method=JaxNomadModel.forward_layers)
    j_emb = np.asarray(jmodel.apply(params, jnp.asarray(wav), jnp.asarray(lengths)))
    model = NomadModel(Wav2Vec2Config.tiny(attention_impl="fused_qkv",
                                           encoder_precision="highest"), emb_dim=EMB)
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        t_wav, t_len = _t(wav), _t(lengths).long()
        layers = model.forward_layers(t_wav, t_len)
        emb = model(t_wav, t_len).numpy()
    frames = feature_frame_lengths(lengths, model.config)
    for i in range(model.config.num_layers):
        ours, ref = layers[i].numpy(), np.asarray(j_layers[i])
        assert ours.shape == ref.shape
        for b, n in enumerate(frames):
            np.testing.assert_allclose(ours[b, :n], ref[b, :n], atol=2e-5, rtol=0)
            assert np.all(ours[b, n:] == 0)  # padded frames re-zeroed
    np.testing.assert_allclose(emb, j_emb, atol=2e-5, rtol=0)


def test_loss_value_and_gradient_match_jax(bridged):
    jcfg, params, sd, _ = bridged
    rng = np.random.default_rng(16)
    clean = (0.3 * rng.standard_normal((2, 1, 1600))).astype(np.float32)
    est = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    jnomad = JaxNomad(device="cpu", config=jcfg, emb_dim=EMB, params=params)
    j_loss, j_grad = jax.value_and_grad(lambda e: jnomad.loss_fn(e, jnp.asarray(clean)))(
        jnp.asarray(est))
    nomad = Nomad(device="cpu", config=Wav2Vec2Config.tiny(attention_impl="fused_qkv",
                                                           encoder_precision="highest"),
                  emb_dim=EMB, params=sd)
    e = _t(est).requires_grad_()
    loss = nomad.forward(e, _t(clean))
    loss.backward()
    # the tolerances of test_torch_loss.py: 1e-5 relative on 13 means of f32
    # layer differences; 1e-4 of max|g| back through two blocks and the
    # conv frontend
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    g, jg = e.grad.numpy(), np.asarray(j_grad)
    assert g.shape == est.shape and np.isfinite(g).all()
    assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max()
    assert nomad.forward(_t(clean).requires_grad_(), _t(clean)).item() == 0.0
