"""The JAX package's whole ``Wav2Vec2Config`` in the port, on the CPU.

(a) Every field of the JAX config is a field of the port's, with the same
default where the two packages share its values. (b) Every island a config
resolves (``matmul_precision`` the root, the attention, FFN and
feature-projection islands, the tail split) equals the JAX config's. (c)
The JAX package's refusals, with its exception types. (d) Islands at f32
values and a tail split at "high" leave the embeddings bit-equal to the
base model's, and a tail-split model loads the bridged weights strictly
(the port of ``tests/test_model.py::test_precision_islands_structurally_inert``).
(e) The tail split at "default", ``matmul_precision="default"`` and the
finer islands together against the JAX model, which XLA on the CPU runs in
f32. (f) ``dtype=bfloat16`` (the whole backbone on bf16 activations):
embeddings, the loss and its input gradient against the JAX model's.
(g) The fused path's mode follows the attention island.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.api import Nomad as JaxNomad
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
from nomad_tpu.ops import fused_attention as jax_fused
from nomad_tpu_torch.api import Nomad
from nomad_tpu_torch.convert import jax_to_state_dict
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config
from nomad_tpu_torch.models import wav2vec2
from nomad_tpu_torch.models.wav2vec2 import ISLAND_FIELDS

torch.set_num_threads(2)
EMB = 16
LENGTHS = [1900, 1333, 800]
F64 = np.float64
BF16 = torch.bfloat16
RESOLVED = ("frontend_prec", "encoder_prec", "attn_prec", "ffn_prec", "attn_score_prec",
            "ffn1_prec", "ffn2_prec", "posconv_prec", "featproj_prec", "tail_split")
PRECISIONS = ("default", "high", "highest")
# the port's embeddings at "default" islands against the JAX package's
# (f32 on the CPU): the tolerance of tests/test_torch_precision.py's modes
# (measured 1.38e-3 and 2.16e-3 there); here measured 1.10e-3 (tail4),
# 1.88e-3 (matmul_default) and 1.34e-3 (finer_islands), 2.7x under it
TOL_MODE_VS_JAX = 5e-3
# the port's dtype=bfloat16 model (its flash attention, "kernel") against
# the jitted JAX model's (its flash attention, "pallas"), both on bf16
# activations, on these weights and inputs: measured max |d| of the
# embeddings 2.09e-3, the loss's relative distance 3.92e-3 and the input
# gradient's max |d| / max |g| 1.13e-2; each tolerance 2.4x-2.7x its
# measurement. Two bf16 realizations differ by that much: the JAX model's
# eager run (each bf16 op of its GELU rounded apart) lies 2.7e-3 from its
# jitted one in the embeddings, and the port's plain attention ("ref")
# moves the waveform gradient by 9.5e-2 of max |g| from the flash path's,
# because the bf16 lossnet head's backward is ill-conditioned (a 0.87e-2
# change in the last block's output moves the head's input gradient by
# 49 %, 0.32 % through the f32 head), so that pairing is not held to
# these tolerances (scripts/config_fields_probe.py)
TOL_BF16_EMB = 5e-3
TOL_BF16_LOSS_REL = 1e-2
TOL_BF16_GRAD_REL = 3e-2
# the configurations of chip_smoke.py's phase 17 that round on the CPU
ROUNDING_CONFIGS = {
    "tail4": dict(encoder_tail_start=1, encoder_tail_precision="default"),
    "matmul_default": dict(matmul_precision="default"),
    "finer_islands": dict(attn_precision="default", ffn2_precision="default",
                          featproj_precision="default"),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def f64(a):
    return np.asarray(a.float() if torch.is_tensor(a) else jnp.asarray(a, jnp.float32), F64)


@pytest.fixture(scope="module")
def bridged():
    rng = np.random.default_rng(23)
    wav = np.zeros((len(LENGTHS), max(LENGTHS)), np.float32)
    for i, n in enumerate(LENGTHS):
        wav[i, :n] = 0.3 * rng.standard_normal(n)
    params = JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB).init(
        jax.random.key(5), jnp.asarray(wav[:1, :800]), method=JaxNomadModel.init_all)
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, jax_to_state_dict(params), wav, np.asarray(LENGTHS, np.int32)


def port_model(sd, cfg):
    model = NomadModel(cfg, emb_dim=EMB)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def port_embed(sd, cfg, wav, lengths):
    with torch.inference_mode():
        return port_model(sd, cfg)(_t(wav), _t(lengths).long())


def jax_embed(params, cfg, wav, lengths):
    return JaxNomadModel(cfg, emb_dim=EMB).apply(params, jnp.asarray(wav), jnp.asarray(lengths))


# ---------------- (a) the fields ----------------


def test_jax_fields_are_a_subset_of_the_port_s():
    ours = {f.name: f for f in dataclasses.fields(Wav2Vec2Config)}
    theirs = {f.name: f for f in dataclasses.fields(JaxConfig)}
    assert set(theirs) <= set(ours), sorted(set(theirs) - set(ours))
    for name in ("matmul_precision", "layerdrop", "encoder_tail_start",
                 "encoder_tail_precision") + ISLAND_FIELDS:
        assert ours[name].default == theirs[name].default, name
    assert Wav2Vec2Config().dtype == torch.float32 and JaxConfig().dtype == jnp.float32


# ---------------- (b) the islands resolve as the JAX package's ----------------


RESOLVE_CASES = (
    [(f"{f}_{p}", {f: p}) for f in ISLAND_FIELDS for p in ("default", "highest")]
    + [(f"matmul_{p}", {"matmul_precision": p}) for p in PRECISIONS]
    + [(f"matmul_default_{f}_highest", {"matmul_precision": "default", f: "highest"})
       for f in ISLAND_FIELDS]
    + [(f"tail_{p}", {"encoder_tail_start": 1, "encoder_tail_precision": p})
       for p in PRECISIONS]
    + [("tail_start_only", {"encoder_tail_start": 0}),
       ("tail_precision_only", {"encoder_tail_precision": "default"})])


@pytest.mark.parametrize("name,kw", RESOLVE_CASES, ids=[c[0] for c in RESOLVE_CASES])
def test_properties_resolve_as_in_jax(name, kw):
    ours, theirs = Wav2Vec2Config.tiny(**kw), JaxConfig.tiny(**kw)
    for prop in RESOLVED:
        assert getattr(ours, prop) == getattr(theirs, prop), (name, prop)
    for dtype, jdtype in ((torch.float32, jnp.float32), (BF16, jnp.bfloat16)):
        for enc, jenc in ((None, None), (torch.float32, jnp.float32), (BF16, jnp.bfloat16)):
            got = Wav2Vec2Config.tiny(dtype=dtype, encoder_dtype=enc, **kw).block_dtype
            want = JaxConfig.tiny(dtype=jdtype, encoder_dtype=jenc, **kw).block_dtype
            assert str(got).split(".")[-1] == jnp.dtype(want).name


def test_each_layer_takes_the_tail_s_islands():
    """``layer_islands``: the head's blocks keep the four islands, the
    tail's take ``encoder_tail_precision`` for all four (JAX's
    ``prec_override``)."""
    cfg = Wav2Vec2Config.base(attn_score_precision="default", ffn1_precision="highest",
                              encoder_tail_start=8, encoder_tail_precision="default")
    head = {"attn": "high", "score": "default", "ffn1": "highest", "ffn2": "high"}
    assert [cfg.layer_islands(i) for i in range(12)] == (
        [head] * 8 + [dict.fromkeys(head, "default")] * 4)
    model = wav2vec2.TransformerEncoder(Wav2Vec2Config.tiny(encoder_tail_start=1,
                                                            encoder_tail_precision="highest"))
    assert [layer.islands["ffn2"] for layer in model.layers] == ["high", "highest"]


# ---------------- (c) the refusals ----------------


@pytest.mark.parametrize("kw,exc,match", [
    (dict(layerdrop=0.05), NotImplementedError, "layerdrop"),
    (dict(encoder_tail_start=1, encoder_tail_precision="default", remat=True),
     NotImplementedError, "remat"),
    (dict(encoder_tail_start=2, encoder_tail_precision="default"), ValueError,
     "encoder_tail_start"),
], ids=["layerdrop", "tail_remat", "tail_start"])
def test_jax_refusals(kw, exc, match):
    with pytest.raises(exc, match=match):
        JaxConfig.tiny(**kw)
    with pytest.raises(exc, match=match):
        Wav2Vec2Config.tiny(**kw)


@pytest.mark.parametrize("kw,match", [
    (dict(matmul_precision=None), "matmul_precision"),
    (dict(matmul_precision="bf16"), "matmul_precision"),
    (dict(encoder_tail_start=1, encoder_tail_precision="low"), "encoder_tail_precision"),
    (dict(dtype=torch.float16), "dtype"),
    (dict(dtype=jnp.bfloat16), "dtype"),
    (dict(encoder_dtype=torch.float16), "encoder_dtype"),
], ids=["matmul_none", "matmul_bad", "tail_bad", "dtype_f16", "dtype_jnp", "encoder_dtype_f16"])
def test_values_are_checked(kw, match):
    with pytest.raises(ValueError, match=match):
        Wav2Vec2Config.tiny(**kw)


def test_no_split_without_both_fields():
    """As in the JAX package, a tail start without a tail precision (or the
    reverse) splits nothing and refuses nothing, remat included."""
    for kw in (dict(encoder_tail_start=5), dict(encoder_tail_precision="default")):
        assert not Wav2Vec2Config.tiny(remat=True, **kw).tail_split
        assert not JaxConfig.tiny(remat=True, **kw).tail_split


# ---------------- (d) structurally inert at f32 values ----------------


def test_precision_islands_structurally_inert(bridged):
    """The finest islands at f32 values, ``matmul_precision="highest"``
    and a tail split at "high" are precision annotations only: bit-equal
    embeddings to the base model's, and the same state_dict keys (the
    bridged JAX weights load strictly into each)."""
    _, sd, wav, lengths = bridged
    # the first forward pass of a process can take other CPU library code
    # (measured 1.1e-6 from every later one): the reference is a later one
    port_embed(sd, Wav2Vec2Config.tiny(), wav, lengths)
    base = port_embed(sd, Wav2Vec2Config.tiny(), wav, lengths)
    for kw in (dict(attn_precision="highest", ffn_precision="high",
                    attn_score_precision="highest", ffn1_precision="highest",
                    ffn2_precision="high", posconv_precision="highest",
                    featproj_precision="highest"),
               dict(matmul_precision="highest"),
               dict(encoder_tail_start=1, encoder_tail_precision="high"),
               dict(encoder_tail_start=0, encoder_tail_precision="highest")):
        cfg = Wav2Vec2Config.tiny(**kw)
        assert torch.equal(port_embed(sd, cfg, wav, lengths), base), kw
        assert NomadModel(cfg, emb_dim=EMB).state_dict().keys() == sd.keys()


# ---------------- (e) the rounding configs against the JAX model ----------------


@pytest.mark.parametrize("name", list(ROUNDING_CONFIGS))
def test_rounding_configs_against_jax(bridged, name):
    params, sd, wav, lengths = bridged
    kw = ROUNDING_CONFIGS[name]
    theirs = f64(jax_embed(params, JaxConfig.tiny(**kw), wav, lengths))
    exact = f64(port_embed(sd, Wav2Vec2Config.tiny(), wav, lengths))
    ours = f64(port_embed(sd, Wav2Vec2Config.tiny(**kw), wav, lengths))
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(exact, theirs, atol=1e-5, rtol=0)  # XLA's CPU: f32
    assert np.abs(ours - exact).max() > 1e-5  # the port rounds
    d = np.abs(ours - theirs).max()
    print(f"{name}: max|d| vs JAX {d:.3g}")
    assert d <= TOL_MODE_VS_JAX, d


# ---------------- (f) dtype=bfloat16 against the JAX model ----------------

def _signed_loss(layers_fn, est, clean, signs):
    """The sum over layers of mean(sign o (layer(est) - layer(clean))) in
    f32: one L1 sign pattern for both packages (an element of a layer
    difference within rounding of 0 takes either sign)."""
    def f32(a):
        return a.float() if torch.is_tensor(a) else a.astype(jnp.float32)

    ref = [f32(c) for c in layers_fn(clean)]
    return sum((s * (f32(a) - c)).mean() for s, a, c in zip(signs, layers_fn(est), ref))


def test_dtype_bf16_against_jax(bridged):
    """``dtype=torch.bfloat16`` against the JAX config's ``dtype=bfloat16``
    on the same weights: the embeddings (f32, finite), ``Nomad.forward``'s
    loss against ``loss_fn``, and the loss's input gradient under the
    port's L1 sign pattern against ``jax.grad`` of the same signed loss,
    within the measured tolerances (TOL_BF16_*). The JAX side runs jitted,
    as the JAX package runs its model, with its flash attention, the
    port's "kernel" ("pallas"; its plain attention rounds the normalised
    weights, the flash kernels do not)."""
    params, sd, wav, lengths = bridged
    cfg = Wav2Vec2Config.tiny(dtype=BF16)
    jcfg = JaxConfig.tiny(dtype=jnp.bfloat16, attention_impl="pallas")
    model = port_model(sd, cfg)
    assert model.backbone.feature_encoder(_t(wav[:1]))[0].dtype == BF16
    ours = port_embed(sd, cfg, wav, lengths)
    assert ours.dtype == torch.float32 and torch.isfinite(ours).all()
    jm = JaxNomadModel(jcfg, emb_dim=EMB)
    theirs = jax.jit(jm.apply)(params, jnp.asarray(wav), jnp.asarray(lengths))
    d_emb = np.abs(f64(ours) - f64(theirs)).max()
    d_f32 = np.abs(f64(ours) - f64(port_embed(sd, Wav2Vec2Config.tiny(), wav, lengths))).max()

    rng = np.random.default_rng(24)
    clean = (0.3 * rng.standard_normal((2, 1600))).astype(np.float32)
    est = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    nomad = Nomad(device="cpu", config=cfg, emb_dim=EMB, params=sd)
    loss = nomad.forward(_t(est), _t(clean)).item()
    jloss = float(jax.jit(JaxNomad(device="cpu", config=jcfg, emb_dim=EMB, params=params)
                          .loss_fn_p)(params, jnp.asarray(est), jnp.asarray(clean)))
    assert np.isfinite(loss) and nomad.forward(_t(clean), _t(clean)).item() == 0.0
    d_loss = abs(loss - jloss) / abs(jloss)
    with torch.no_grad():
        signs = [torch.sign(a.float() - c.float()) for a, c in zip(
            model.forward_layers(_t(est)), model.forward_layers(_t(clean)))]
    e = _t(est).requires_grad_()
    _signed_loss(model.forward_layers, e, _t(clean), signs).backward()
    j_signs = [jnp.asarray(s.numpy()) for s in signs]
    jgrad = f64(jax.jit(jax.grad(lambda x: _signed_loss(
        lambda w: jm.apply(params, w, method=JaxNomadModel.forward_layers), x,
        jnp.asarray(clean), j_signs)))(jnp.asarray(est)))
    assert np.isfinite(e.grad.numpy()).all()
    d_grad = np.abs(e.grad.numpy() - jgrad).max() / np.abs(jgrad).max()
    print(f"dtype bf16: emb {d_emb:.3g} (vs the f32 model {d_f32:.3g}), "
          f"loss rel {d_loss:.3g}, grad {d_grad:.3g}")
    assert d_f32 > 1e-4  # the backbone really ran on bf16
    assert d_emb <= TOL_BF16_EMB and d_loss <= TOL_BF16_LOSS_REL and d_grad <= TOL_BF16_GRAD_REL


def test_dtype_bf16_rounds_where_jax_rounds(bridged):
    """The frontend on bf16: every convolution's output, the GroupNorm's
    and the heads' products are bf16 values, as the JAX package's."""
    _, sd, wav, lengths = bridged
    model = port_model(sd, Wav2Vec2Config.tiny(dtype=BF16))
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append((type(m).__name__, o.dtype)))
             for m in model.modules() if isinstance(m, wav2vec2.MaskedGroupNorm)]
    with torch.inference_mode():
        res = model.backbone(_t(wav), _t(lengths).long())
    for h in hooks:
        h.remove()
    assert seen == [("MaskedGroupNorm", BF16)]
    assert all(x.dtype == BF16 for x in res["layers"])


# ---------------- (g) the fused path's mode follows the attention island ----------------


@pytest.mark.parametrize("kw,want", [
    (dict(attn_precision="default", encoder_precision="high"), ["default"] * 2),
    (dict(attn_precision="high", encoder_precision="default"), ["high"] * 2),
    (dict(encoder_tail_start=1, encoder_tail_precision="default"), ["high", "default"]),
], ids=["attn_default", "attn_high", "tail"])
def test_fused_mode_follows_attn_prec(bridged, monkeypatch, kw, want):
    """The port's ``fused_qkv_attention`` takes each block's attention
    island; the JAX model's fused call takes the mode of the same island
    ("high" is its "high3")."""
    params, sd, wav, lengths = bridged
    got, jax_modes = [], []
    real = wav2vec2.fused_qkv_attention

    def spy(*args, precision, **kwargs):
        got.append(precision)
        return real(*args, precision=precision, **kwargs)

    monkeypatch.setattr(wav2vec2, "fused_qkv_attention", spy)
    port_embed(sd, Wav2Vec2Config.tiny(attention_impl="fused_qkv", **kw), wav, lengths)
    assert got == want

    def jax_spy(x, *args, mode, **kwargs):
        jax_modes.append(mode)
        return jnp.zeros_like(x)

    monkeypatch.setattr(jax_fused, "fused_qkv_attention", jax_spy)
    jax.eval_shape(lambda p: jax_embed(p, JaxConfig.tiny(attention_impl="fused_qkv", **kw),
                                       wav, lengths), params)
    to_port = {"high3": "high", "default": "default", "highest": "highest"}
    assert {to_port[m] for m in jax_modes} == set(want)
