"""The trainer's ``fast_bf16`` (bf16 activations in the block stack) in the
port against the JAX package, on the CPU.

(1) The plain versions of the kernels' bf16-I/O flavours (K5, K1b, K2b +
K3b) against the JAX package's Pallas kernels on the same bf16 inputs, in
interpret mode (XLA on the CPU computes their DEFAULT products in f32):
the output dtype, and a distance of one bf16 ulp of the output plus what
the port's DEFAULT roundings (of P and dS) can move, bounded in float64
as ``tests/test_torch_grad_modes.py`` bounds them; (2) each plain bf16-I/O
flavour equals its f32 flavour on the upcast inputs, rounded once, bit
for bit; (3) the bf16-I/O product against flax's ``nn.Dense(dtype=
bfloat16)`` and its ``jax.vjp``; (4) the model on bf16 activations against
the JAX model with the same weights, within twice the JAX package's own
distance between its "fast" and "fast_bf16" embeddings; (5) the
``precision: fast_bf16`` rule; (6) one rates-at-0 step's loss and
gradients against the JAX trainer's, within twice the JAX package's own
distance between "fast_bf16" and "exact" (the rule of chip_smoke.py's
phase 10: two bf16 realizations of one mode, each about that far from
"exact"); (7) an epoch's trajectory; (8) the former refusals; and the dropout
mask, the attention's output dtype and the evals' engine on bf16
activations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from test_torch_grad_modes import (
    REL_F32,
    SUM_TOL,
    attention_bwd_emulation,
    bf16_np,
    rounded_einsum,
)

from nomad_tpu.api import _flatten
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
from nomad_tpu.ops.flash_attention import mha_pallas
from nomad_tpu.ops.layernorm import layer_norm as jax_layer_norm
from nomad_tpu.training import Training as JaxTraining
from nomad_tpu.training.losses import triplet_margin_loss as jax_triplet_margin_loss
from nomad_tpu_torch.convert import jax_to_state_dict, state_dict_to_jax
from nomad_tpu_torch.io import write_wav
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config
from nomad_tpu_torch.models.wav2vec2 import FAST_ISLANDS
from nomad_tpu_torch.ops import attention, flash_attention, layernorm, precision
from nomad_tpu_torch.training import Training, data, triplet

torch.set_num_threads(2)
EMB = 16
BF16 = torch.bfloat16
F64 = np.float64
ZERO_RATES = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
LENGTHS = [1900, 1333, 800]


def bf16_ulp(x):
    """One bf16 step at |x| (8 significant bits), as float64."""
    x = np.maximum(np.abs(np.asarray(x, F64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def as_bf16(rng, shape, scale=1.0):
    """Seeded normal values, rounded to bf16: (torch bf16, jax bf16, their
    float32 values)."""
    x = torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(BF16)
    f32 = x.float().numpy()
    return x, jnp.asarray(f32).astype(jnp.bfloat16), f32


def f64(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32),
                      F64)


# ---------------- (1, 2) the plain bf16-I/O flavours ----------------


def test_layer_norm_bf16_io_against_pallas_and_f32_flavour():
    """K5's bf16-I/O plain version: bf16 out, within one bf16 ulp of the
    Pallas kernel's (interpret mode) plus 1e-5 (two f32 orders of the
    statistics: an output near 0 is a sum that cancelled, whose f32 error
    is that of its terms), and its f32 flavour on the upcast rows rounded
    once, bit for bit; its backward gives a bf16 dx."""
    rng = np.random.default_rng(0)
    x, xj, _ = as_bf16(rng, (37, 96), 3.0)
    scale = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(96)).astype(np.float32)
    ours = layernorm.layer_norm(x, torch.from_numpy(scale), torch.from_numpy(bias))
    theirs = jax_layer_norm(xj, jnp.asarray(scale), jnp.asarray(bias), impl="pallas",
                            interpret=True)
    assert ours.dtype == BF16 and theirs.dtype == jnp.bfloat16
    d = np.abs(f64(ours) - f64(theirs))
    assert np.all(d <= bf16_ulp(np.maximum(np.abs(f64(ours)), np.abs(f64(theirs)))) + 1e-5)
    f32 = layernorm.layer_norm(x.float(), torch.from_numpy(scale), torch.from_numpy(bias))
    assert torch.equal(ours, f32.to(BF16))
    xg = x.clone().requires_grad_()
    layernorm.layer_norm(xg, torch.from_numpy(scale), torch.from_numpy(bias)).sum().backward()
    assert xg.grad.dtype == BF16


def _qkv(seed, b, t, lengths, h=2):
    rng = np.random.default_rng(seed)
    q, k, v, do = (as_bf16(rng, (b, t, h, 64)) for _ in range(4))
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, do, mask


def test_flash_bf16_io_against_pallas_and_f32_flavour():
    """K1b's bf16-I/O plain version: O bf16, LSE f32; O within the
    rounding of P (the port's DEFAULT flavour; XLA on the CPU runs the
    Pallas kernel's DEFAULT products in f32) plus one bf16 ulp of the
    Pallas kernel's O; equal to the f32 flavour on the upcast inputs,
    rounded once, and the same LSE, bit for bit."""
    lengths = [50, 31, 1]
    (q, qj, qf), (k, kj, kf), (v, vj, vf), _, mask = _qkv(1, 3, 50, lengths)
    lens = torch.tensor(lengths, dtype=torch.int32)
    o, lse = flash_attention.mha_flash(q, k, v, lens, "default")
    assert o.dtype == BF16 and lse.dtype == torch.float32
    theirs = mha_pallas(qj, kj, vj, jnp.asarray(mask), interpret=True,
                        precision=jax.lax.Precision.DEFAULT)
    assert theirs.dtype == jnp.bfloat16
    # float64: exact attention and the same with P rounded to bf16, with the
    # bound on what a P computed in f32 can flip
    s = np.einsum("bqhd,bkhd->bhqk", qf.astype(F64) / 8, kf.astype(F64))
    s = np.where(mask[:, None, None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    l = p.sum(-1)[..., None]
    exact = np.einsum("bhqk,bkhd->bqhd", p, vf) / np.moveaxis(l, 1, 2)
    emu, flips = rounded_einsum("bhqk,bkhd->bqhd", p, REL_F32 * p, vf)
    emu, flips = (x / np.moveaxis(l, 1, 2) for x in (emu, flips))
    tol = (np.abs(emu - exact) + flips + SUM_TOL * np.abs(exact).max()
           + bf16_ulp(np.maximum(np.abs(f64(o)), np.abs(f64(theirs)))))
    assert np.all(np.abs(f64(o) - f64(theirs)) <= tol)
    o32, lse32 = flash_attention.mha_flash(q.float(), k.float(), v.float(), lens, "default")
    assert torch.equal(o, o32.to(BF16)) and torch.equal(lse, lse32)


def test_flash_bwd_bf16_io_against_pallas_vjp_and_f32_flavour():
    """K2b's and K3b's bf16-I/O plain version (through ``FlashAttention``):
    dQ, dK and dV bf16; within the float64 emulation's flip bound (the
    rounding of P and dS), the emulation's own distance from the unrounded
    gradient and one bf16 ulp of ``jax.vjp`` of the Pallas kernels
    (interpret mode); equal to the f32 flavour on the upcast inputs,
    rounded once, bit for bit."""
    lengths = [50, 31, 1]
    (q, qj, qf), (k, kj, kf), (v, vj, vf), (do, doj, dof), mask = _qkv(2, 3, 50, lengths)
    lens = torch.tensor(lengths, dtype=torch.int32)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    o = flash_attention.FlashAttention.apply(*xs, lens, "default")
    o.backward(do)
    ours = [x.grad for x in xs]
    assert all(g.dtype == BF16 for g in ours)
    o_jax, vjp = jax.vjp(lambda a, b, c: mha_pallas(a, b, c, jnp.asarray(mask), interpret=True,
                                                    precision=jax.lax.Precision.DEFAULT),
                         qj, kj, vj)
    theirs = vjp(doj)
    assert all(g.dtype == jnp.bfloat16 for g in theirs)
    _, lse = flash_attention.flash_attention_ref(q, k, v, lens, "default")
    o_np = o.detach().float().numpy()
    emu, flips = attention_bwd_emulation(qf, kf, vf, dof, o_np, lse.numpy(), lengths)
    # the unrounded gradients (no rounding of P and dS, the Pallas kernels'
    # arithmetic on the CPU) from the port's O and from the JAX kernel's: Di
    # reads O, which the port's DEFAULT forward rounds otherwise
    exact = _bwd_unrounded(qf, kf, vf, dof, o_np, lse.numpy(), lengths)
    exact_jax = _bwd_unrounded(qf, kf, vf, dof, f64(o_jax), lse.numpy(), lengths)
    for name, g, t, e, bd, x, xj in zip(("dq", "dk", "dv"), ours, theirs, emu, flips, exact,
                                        exact_jax):
        tol = (bd + np.abs(e - x) + np.abs(x - xj) + SUM_TOL * np.abs(x).max()
               + 2 * bf16_ulp(np.maximum(np.abs(f64(g)), np.abs(f64(t)))))
        assert np.all(np.abs(f64(g) - f64(t)) <= tol), name
    xs32 = [x.float().requires_grad_() for x in (q, k, v)]
    o32 = flash_attention.FlashAttention.apply(*xs32, lens, "default")
    assert torch.equal(o.detach(), o32.detach().to(BF16))
    # the f32 flavour's backward from the same (bf16-valued) O and dO
    g32 = flash_attention.flash_attention_bwd(q.float(), k.float(), v.float(), o.detach().float(),
                                              lse, do.float(), lens, "default")
    for g, w in zip(ours, g32):
        assert torch.equal(g, w.to(BF16))


def _bwd_unrounded(q, k, v, do, o, lse, lengths):
    """dQ, dK, dV in float64 from O and LSE with no bf16 rounding of P or
    dS (the Pallas kernels' arithmetic on the CPU)."""
    b, t, h, d = q.shape
    outs = [np.zeros((b, t, h, d)) for _ in range(3)]
    for i, n in enumerate(lengths):
        if n == 0:
            continue
        qi, ki, vi, doi = (x.astype(F64) for x in (q[i], k[i, :n], v[i, :n], do[i]))
        p = np.exp(np.einsum("qhd,khd->hqk", qi, ki) / 8.0 - lse[i][:, :, None])
        dp = np.einsum("qhd,khd->hqk", doi, vi)
        di = (doi * o[i].astype(F64)).sum(-1).T[:, :, None]
        ds = p * (dp - di)
        outs[0][i] = np.einsum("hqk,khd->qhd", ds, ki) / 8
        outs[1][i, :n] = np.einsum("hqk,qhd->khd", ds, qi) / 8
        outs[2][i, :n] = np.einsum("hqk,qhd->khd", p, doi)
    return outs


def test_bwd_args_upcasts_before_it_multiplies():
    """The card's ``_bwd_args`` (run here on CPU tensors) takes bf16 dO and
    O for the bf16-I/O flavours and computes Di = rowsum(dO O) [B, H, T] in f32 from the
    upcast operands, as the JAX package's ``_mha_pallas_bwd``: a bf16
    product would round each term."""
    rng = np.random.default_rng(4)
    q, k, v, o, do = (as_bf16(rng, (2, 9, 2, 64)) for _ in range(5))
    lens = torch.tensor([9, 4], dtype=torch.int32)
    lse = torch.zeros(2, 2, 9)
    _, di, _ = flash_attention._bwd_args(q[0], k[0], v[0], o[0], lse, do[0], lens)
    assert di.dtype == torch.float32 and di.shape == (2, 2, 9)
    want = (do[2].astype(F64) * o[2].astype(F64)).sum(-1).transpose(0, 2, 1)
    assert np.abs(di.numpy() - want).max() < 1e-5 * np.abs(want).max()
    bf16_product = (do[0] * o[0]).float().sum(-1).transpose(1, 2)
    assert np.abs(bf16_product.numpy() - want).max() > 1e-4 * np.abs(want).max()
    with pytest.raises(TypeError, match="bfloat16"):  # one dtype for q, k and v
        flash_attention._bwd_args(q[0], k[0].float(), v[0], o[0], lse, do[0], lens)


# ---------------- (3) the bf16-I/O product ----------------


def test_linear_bf16_io_matches_flax_dense_and_its_vjp():
    """``precision.linear`` on a bf16 x against flax ``nn.Dense(dtype=
    bfloat16)`` at each island: y bit-equal (the f32 sum rounded, then the
    bf16 bias add rounded); dX and dW bit-equal (f32 sums rounded once; dW
    comes back to the f32 parameter as a bf16 value); db within what XLA's
    bf16 summation of the cotangent can differ from the port's rounded f32
    sum: (n - 1) 2^-8 sum |g| (recursive summation in 8-bit arithmetic)."""
    rng = np.random.default_rng(5)
    n, d_in, d_out = 64, 96, 80
    x, xj, _ = as_bf16(rng, (n, d_in))
    w = (0.1 * rng.standard_normal((d_in, d_out))).astype(np.float32)
    b = rng.standard_normal(d_out).astype(np.float32)
    g, gj, gf = as_bf16(rng, (n, d_out))
    dense = fnn.Dense(d_out, dtype=jnp.bfloat16, param_dtype=jnp.float32)
    params = {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}

    def apply(p, xx):
        with jax.default_matmul_precision("default"):
            return dense.apply(p, xx)

    want, vjp = jax.vjp(apply, params, xj)
    dparams, dx_want = vjp(gj)
    for prec in ("default", "high"):
        xt = x.clone().requires_grad_()
        wt = torch.from_numpy(w.T.copy()).requires_grad_()
        bt = torch.from_numpy(b).requires_grad_()
        y = precision.linear(xt, wt, bt, prec)
        assert y.dtype == BF16
        np.testing.assert_array_equal(f64(y), f64(want))
        y.backward(g)
        assert xt.grad.dtype == BF16 and wt.grad.dtype == torch.float32
        np.testing.assert_array_equal(f64(xt.grad), f64(dx_want))
        np.testing.assert_array_equal(wt.grad.numpy().T, np.asarray(dparams["params"]["kernel"]))
        db_jax = np.asarray(dparams["params"]["bias"], F64)
        bound = (n - 1) * 2.0 ** -8 * np.abs(gf.astype(F64)).sum(0) + bf16_ulp(db_jax)
        assert np.all(np.abs(bt.grad.numpy() - db_jax) <= bound)
        assert np.array_equal(bt.grad.numpy(), bf16_np(bt.grad.numpy().astype(np.float32)))


# ---------------- the attention and dropout on bf16 ----------------


def test_plain_attention_returns_v_dtype():
    """``mha_ref`` and ``mha_dropout`` on bf16 q, k, v return bf16, as
    ``mha_xla``'s ``.astype(v.dtype)``: the f32 product of the bf16 weights
    and v, rounded once."""
    rng = np.random.default_rng(6)
    q, k, v = (as_bf16(rng, (2, 7, 3, 64))[0] for _ in range(3))
    mask = torch.tensor([[True] * 7, [True] * 4 + [False] * 3])
    o = attention.mha_ref(q, k, v, mask, "default")
    od = attention.mha_dropout(q, k, v, mask, 0.0, torch.Generator().manual_seed(0), "default")
    assert o.dtype == od.dtype == BF16 and torch.equal(o, od)
    w = torch.softmax(precision.matmul_bf16(q.permute(0, 2, 1, 3) / 8, k.permute(0, 2, 3, 1))
                      + torch.where(mask, 0.0, -1e9)[:, None, None, :], dim=-1).to(BF16)
    want = (w.float() @ v.float().permute(0, 2, 1, 3)).permute(0, 2, 1, 3).to(BF16)
    assert torch.equal(o, want)


def test_dropout_on_bf16_keeps_one_minus_rate():
    """The keep mask of a bf16 x comes from a float32 uniform: the keep
    share lies within five binomial standard deviations of 1 - rate (a
    bf16 uniform keeps 230/256 = 0.898 at rate 0.1, 22 deviations off at
    this count), the kept values are x / (1 - rate) in bf16, and the mask
    is the f32 one's bit for bit."""
    n, rate = 400_000, 0.1
    x = torch.full((n,), 2.0, dtype=BF16)
    y = attention.dropout(x, rate, torch.Generator().manual_seed(2))
    assert y.dtype == BF16
    kept = y != 0
    assert abs(kept.sum().item() - n * (1 - rate)) < 5 * (n * rate * (1 - rate)) ** 0.5
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0 / (1 - rate)))
    y32 = attention.dropout(x.float(), rate, torch.Generator().manual_seed(2))
    assert torch.equal(kept, y32 != 0)


# ---------------- (4, 5, 8) the model, the precision rule, the refusals ----------------


@pytest.fixture(scope="module")
def bridged():
    jmodel = JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB)
    rng = np.random.default_rng(11)
    wav = np.zeros((len(LENGTHS), max(LENGTHS)), np.float32)
    for i, n in enumerate(LENGTHS):
        wav[i, :n] = 0.3 * rng.standard_normal(n)
    params = jmodel.init(jax.random.key(0), jnp.asarray(wav[:1, :800]),
                         method=JaxNomadModel.init_all)
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, jax_to_state_dict(params), wav, np.asarray(LENGTHS, np.int32)


def _jax_fast(bf16: bool, **kw):
    return JaxConfig.tiny(frontend_precision="high", encoder_precision="default",
                          encoder_dtype=jnp.bfloat16 if bf16 else None, **kw)


def test_model_on_bf16_activations_against_jax(bridged):
    """``NomadModel`` with ``encoder_dtype=bfloat16`` against the JAX model
    with the same weights: every block output bf16, the embeddings and the
    pooled features f32; each within twice the JAX package's own distance
    between its "fast" and "fast_bf16" outputs (the port's attention
    rounds P where ``mha_xla`` rounds the normalised weights: another
    bf16 realization of the mode)."""
    params, sd, wav, lengths = bridged
    model = NomadModel(Wav2Vec2Config.tiny(**FAST_ISLANDS, encoder_dtype=BF16), emb_dim=EMB)
    model.load_state_dict(sd, strict=True)
    assert model.config.block_dtype == BF16
    w, lens = torch.from_numpy(wav), torch.from_numpy(lengths).long()
    with torch.inference_mode():
        layers = model.forward_layers(w, lens)
        emb = model(w, lens)
        feats = model.forward_features(w, lens)
    assert all(x.dtype == BF16 for x in layers[:-1]) and layers[-1].dtype == torch.float32
    assert emb.dtype == feats.dtype == torch.float32
    out = {}
    for bf16 in (False, True):
        jm = JaxNomadModel(_jax_fast(bf16), emb_dim=EMB)
        args = (jnp.asarray(wav), jnp.asarray(lengths))
        out[bf16] = [np.asarray(jm.apply(params, *args), F64),
                     np.asarray(jm.apply(params, *args, method=JaxNomadModel.forward_features)
                                .astype(jnp.float32), F64),
                     np.asarray(jm.apply(params, *args, method=JaxNomadModel.forward_layers)[-2]
                                .astype(jnp.float32), F64)]
    assert out[True][2].dtype == F64
    for name, ours, theirs, fast in zip(("emb", "features", "last block"),
                                        (emb, feats, layers[-2]), out[True], out[False]):
        d_jax = np.abs(theirs - fast).max()
        d = np.abs(f64(ours) - theirs).max()
        assert 0 < d_jax and d <= 2 * d_jax, (name, d, d_jax)


@pytest.mark.parametrize("size", ["tiny", "base"])
def test_fast_bf16_resolves_as_jax(size):
    """``precision: fast_bf16`` gives the JAX trainer's config: "fast"'s
    islands and a bf16 block stack, at any size."""
    cfg = {"experiment_name": "quality_nmr", "model_size": size, "precision": "fast_bf16"}
    theirs = JaxTraining(dict(cfg), params={}).model_config
    ours = triplet.resolve_model_config(cfg)
    for prop in ("frontend_prec", "encoder_prec", "attn_score_prec", "ffn1_prec",
                 "posconv_prec"):
        assert getattr(ours, prop) == getattr(theirs, prop), prop
    assert theirs.block_dtype == jnp.bfloat16 and ours.block_dtype == BF16
    base = Wav2Vec2Config.tiny() if size == "tiny" else Wav2Vec2Config.base()
    assert ours == dataclasses.replace(base, **FAST_ISLANDS, encoder_dtype=BF16)


def test_the_refusals_name_roadmap():
    """The two former refusals construct now: bf16 activations with
    ``fused_qkv`` (K4's and K4b's bf16-I/O flavours) and with an attention
    island other than "default" (K1's, K2's and K3's), on every impl; any
    dtype other than bf16 still raises ValueError."""
    for islands in ({}, FAST_ISLANDS, {**FAST_ISLANDS, "attn_score_precision": "highest"}):
        for impl in ("kernel", "fused_qkv", "ref"):
            cfg = Wav2Vec2Config.tiny(**islands, encoder_dtype=BF16, attention_impl=impl)
            assert cfg.block_dtype == BF16 and cfg.attention_impl == impl
    for dtype in (torch.float16, torch.float32):
        with pytest.raises(ValueError, match="encoder_dtype"):
            Wav2Vec2Config.tiny(**FAST_ISLANDS, encoder_dtype=dtype)


# ---------------- (6, 7) the trainer ----------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Seeded PCM16 WAVs of unequal lengths under OPUS/MP3/NOISE and a
    triplet CSV of four rows over two db levels."""
    base = tmp_path_factory.mktemp("triplets_bf16")
    root = base / "degraded"
    rng = np.random.default_rng(41)
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


def _jax_loss_and_grads(config, params, batch):
    """The JAX trainer's loss over [A; P; N] and its gradient."""
    model = JaxNomadModel(config, emb_dim=EMB)
    wav = jnp.concatenate([jnp.asarray(batch.anchor), jnp.asarray(batch.positive),
                           jnp.asarray(batch.negative)]).astype(jnp.float32) / 32768.0
    lengths = jnp.concatenate([jnp.asarray(batch.lengths_a), jnp.asarray(batch.lengths_p),
                               jnp.asarray(batch.lengths_n)])
    b = len(batch.lengths_a)

    def loss_fn(p):
        emb = model.apply(p, wav, lengths=lengths, deterministic=True)
        return jax_triplet_margin_loss(emb[:b], emb[b:2 * b], emb[2 * b:], 0.2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), _flatten(jax.device_get(grads["params"]))


def _port_loss_and_grads(tree, params, precision_mode, batch=None):
    """A rates-at-0 ``Training`` step's loss and trainable gradients (flat
    JAX keys), without the optimizer; and the batch."""
    config = triplet.resolve_model_config({"model_size": "tiny", "precision": precision_mode})
    tr = Training(train_config(tree, precision=precision_mode), device="cpu",
                  params=jax_to_state_dict(params),
                  model_config=dataclasses.replace(config, **ZERO_RATES))
    if batch is None:
        batch = data.collate_triplets([tr.train_set.load_item(i) for i in (0, 1)])
    loss = tr.triplet_loss(batch, False, torch.Generator().manual_seed(0))
    loss.backward()
    grads = state_dict_to_jax({n: p.grad for n, p in tr.model.named_parameters()
                               if p.grad is not None})
    return loss.item(), grads, batch


def test_one_fast_bf16_step_against_jax(tree, bridged):
    """A rates-at-0 ``fast_bf16`` step of ``Training`` (conv frozen) against
    the JAX trainer's loss and gradient on the same weights and batch,
    under chip_smoke.py's phase 10 rule: the two are two bf16 realizations
    of one mode, each about D from "exact", so they may lie 2 D apart
    (plus f32 noise). XLA on the CPU computes DEFAULT products in f32, so
    the JAX package's "fast_bf16" holds only the activations' rounding: D
    is its distance to its "exact" plus the port's "fast" distance to the
    JAX package's "fast" (the DEFAULT roundings on f32 activations, held to
    JAX by ``tests/test_torch_grad_modes.py``), both from code that is not
    under test here. The loss and every trainable gradient (relative to
    the largest) within that; frozen parameters get no gradient."""
    params = bridged[0]
    loss, grads, batch = _port_loss_and_grads(tree, params, "fast_bf16")
    assert not any(k.startswith("lossnet_embedding") or "feature_encoder" in k for k in grads)
    l_fast, g_fast, _ = _port_loss_and_grads(tree, params, "fast", batch)
    frozen = dict(frontend_stop_gradient=True, **ZERO_RATES)
    jax_runs = {name: _jax_loss_and_grads(config, params, batch) for name, config in (
        ("fast_bf16", _jax_fast(True, **frozen)), ("fast", _jax_fast(False, **frozen)),
        ("exact", JaxConfig.tiny(**frozen)))}
    (l_bf16, g_bf16), (lj_fast, gj_fast), (l_exact, g_exact) = jax_runs.values()
    gmax = max(np.abs(g_bf16[k]).max() for k in grads)

    def dist(a, b):
        return max(np.abs(a[k] - b[k]).max() for k in grads) / gmax

    d_plain = dist(g_bf16, g_exact) + dist(g_fast, gj_fast)
    d = dist(grads, g_bf16)
    assert 0 < d <= 1e-4 + 2 * d_plain, (d, d_plain)
    d_loss = abs(l_bf16 - l_exact) + abs(l_fast - lj_fast)
    assert abs(loss - l_bf16) <= 1e-5 * abs(l_bf16) + 2 * d_loss, (loss, l_bf16, d_loss)


def test_fast_bf16_trajectory(tree):
    """The port's copy of the JAX package's
    ``test_training_mixed_precision_trajectory[fast_bf16]``: an epoch with
    dropout on bf16 activations lands within 0.05 of "exact"'s loss, and
    the eval step runs there too."""
    cfg = train_config(tree)
    exact = Training(dict(cfg, precision="exact"), device="cpu")
    mixed = Training(dict(cfg, precision="fast_bf16"), device="cpu")
    assert mixed.model_config.encoder_prec == "default"
    assert mixed.model_config.block_dtype == BF16
    l_exact = exact.train(rng_seed=0)
    l_mixed = mixed.train(rng_seed=0)
    assert np.isfinite(l_mixed)
    assert abs(l_mixed - l_exact) < 0.05
    assert np.isfinite(mixed.eval())


def test_evals_engine_embeds_through_a_bf16_stack(bridged):
    """The evals' engine on a ``fast_bf16`` Training's model: f32
    embeddings (and raw features under ``eval_w2v``), each file's within
    twice the bf16 stack's own distance from the f32 one of the model run
    on that file alone: the engine pads the file into a bucket, and f32
    sums in another order flip some bf16 roundings, so the two are two
    bf16 realizations of one computation."""
    _, sd, wav, lengths = bridged
    cfg = {"experiment_name": "quality_nmr", "model_size": "tiny", "emb_dim": EMB}
    waves = [wav[i, :n] for i, n in enumerate(lengths)]
    for eval_w2v in (False, True):
        tr, tr32 = (Training(dict(cfg, eval_w2v=eval_w2v, precision=p), device="cpu", params=sd)
                    for p in ("fast_bf16", "fast"))
        got = tr._engine().embed_waves(waves)
        assert got.dtype == np.float32 and np.isfinite(got).all()
        for i, w in enumerate(waves):
            args = (torch.from_numpy(w)[None], torch.tensor([len(w)]))
            with torch.inference_mode():
                one, one32 = ((m.forward_features if eval_w2v else m.forward)(*args)[0].numpy()
                              for m in (tr.model, tr32.model))
            d_act = np.abs(one - one32).max()
            assert 0 < d_act and np.abs(got[i] - one).max() <= 2 * d_act
