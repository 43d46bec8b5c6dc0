"""The precision modes of the port ("exact", "balanced", "fast") against the
JAX package's on the CPU.

(a) every island a config resolves equals the JAX ``Wav2Vec2Config``'s,
and every product and convolution of a forward pass runs at the
precision the JAX package's trace gives the same product; (b) islands at "high"/"highest" leave the
embeddings bit-equal to "exact"; (c) ``ops.precision`` and the "default"
flavour of the flash attention's plain version against a numpy float64
emulation of one bf16 pass (operands rounded to nearest even by bit
manipulation, products and sums in float64); (d) the port's "balanced"
and "fast" embeddings against the JAX package's, which XLA on the CPU
computes in f32 (it ignores dot precision); (e) the former refusals,
which build now, and ``fused_qkv`` at a bf16 island; and the API and
the service in a mode.
"""

import dataclasses
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.api import Nomad as JaxNomad
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
import nomad_tpu_torch.api as tapi
from nomad_tpu_torch import serve
from nomad_tpu_torch.convert import jax_to_state_dict
from nomad_tpu_torch.io import write_wav
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config
from nomad_tpu_torch.models.wav2vec2 import ISLAND_FIELDS, PRECISION_ISLANDS
from nomad_tpu_torch.ops import flash_attention, precision
from nomad_tpu_torch.training import Training

torch.set_num_threads(2)
EMB = 16
LENGTHS = [1900, 1333, 800]
RESOLVED = ("frontend_prec", "encoder_prec", "attn_prec", "ffn_prec", "attn_score_prec",
            "ffn1_prec", "ffn2_prec", "posconv_prec", "featproj_prec", "tail_split")
JAX_PRECISION = {"DEFAULT": "default", "HIGH": "high", "HIGHEST": "highest"}
# the port's "balanced"/"fast" embeddings vs the JAX package's (f32 on the
# CPU) on the tiny config: measured 1.38e-3 (balanced) and 2.16e-3 (fast)
# on these weights and inputs; 5e-3 is 2.3x the larger
TOL_MODE_VS_JAX = 5e-3


def bf16_np(x):
    """x (float32) rounded to the nearest bfloat16, ties to even, by bit
    manipulation, returned as float64."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def unit_class(rng, shape):
    """Magnitudes in [0.5, 1) with random signs: after rounding to bf16 every
    value is a multiple of 2^-8, so the f32 sums of their products below
    (< 2^23 steps) are exact, and an f32 op and its float64 emulation can
    differ only where an f32 function (exp) rounds."""
    x = rng.uniform(0.5, 1.0, shape) * rng.choice([-1.0, 1.0], shape)
    return x.astype(np.float32)


# ---------------- (a) islands and validation, as the JAX package's ----------------


CASES = [("base", {})] + [(f"{f}_{p}", {f: p}) for p in ("default", "highest")
                          for f in ISLAND_FIELDS]


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_islands_resolve_as_in_jax(name, kw):
    ours, theirs = Wav2Vec2Config.tiny(**kw), JaxConfig.tiny(**kw)
    for prop in RESOLVED:
        assert getattr(ours, prop) == getattr(theirs, prop), (name, prop)


@pytest.mark.parametrize("mode", ["balanced", "fast"])
def test_recipes_match_jax(mode):
    ours, theirs = getattr(Wav2Vec2Config, mode)(), getattr(JaxConfig, mode)()
    for prop in RESOLVED:
        assert getattr(ours, prop) == getattr(theirs, prop), (mode, prop)
    base = JaxConfig.base()
    recipe = {f.name: getattr(theirs, f.name) for f in dataclasses.fields(theirs)
              if getattr(theirs, f.name) != getattr(base, f.name)}
    assert recipe == PRECISION_ISLANDS[mode]


def test_island_values_are_checked():
    for name in ISLAND_FIELDS:
        with pytest.raises(ValueError, match=name):
            Wav2Vec2Config.tiny(**{name: "bfloat16"})
    assert Wav2Vec2Config.tiny(**{name: None for name in ISLAND_FIELDS}) == Wav2Vec2Config.tiny()


# ---------------- shared tiny weights and batch ----------------


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


def port_embed(sd, cfg, wav, lengths):
    model = NomadModel(cfg, emb_dim=EMB)
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        return model.eval()(torch.from_numpy(wav), torch.from_numpy(lengths).long()).numpy()


def jax_products(jaxpr, tail_start=-1, step=None):
    """(site, precision) of every dot_general and convolution in a JAX
    trace, in order: ("conv", (k, in / groups, out)), ("dot", in, out),
    ("attn",) for a product of 4-D operands (the attention's two count as
    one and must agree). A scan is unrolled, its body walked once per
    step; inside it, the tail split's ``cond`` takes the branch the layer
    index selects: below ``tail_start`` the head's (``lax.cond``'s true
    branch, index 1 under its boolean predicate), else the tail's (index
    0). The head's products (2-D operands, pinned "high") are left out."""
    out = []
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in ("dot_general", "conv_general_dilated"):
            lhs, rhs = (v.aval.shape for v in eqn.invars)
            prec = {JAX_PRECISION[p.name] for p in eqn.params["precision"]}
            assert len(prec) == 1, eqn
            if len(lhs) == 4:
                site = ("attn",)
            elif name == "conv_general_dilated":
                site = ("conv", tuple(rhs))
            elif len(lhs) == 2:
                continue
            else:
                site = ("dot", rhs[0], rhs[1])
            if site == ("attn",) and out and out[-1][0] == site and out[-1][2] == 1:
                assert out[-1][1] == prec, eqn
                out[-1] = (site, prec, 2)
            else:
                out.append((site, prec, 1))
            continue
        if name == "scan":
            for i in range(eqn.params["length"]):
                out += jax_products(eqn.params["jaxpr"].jaxpr, tail_start, i)
            continue
        if name == "cond":
            branch = eqn.params["branches"][1 if step < tail_start else 0]
            out += jax_products(branch.jaxpr, tail_start, step)
            continue
        for value in eqn.params.values():
            sub = getattr(value, "jaxpr", value)
            if hasattr(sub, "eqns"):
                out += jax_products(sub, tail_start, step)
    return out


def port_products(monkeypatch, model, wav, lengths):
    """The same (site, precision) list for the port: every call of
    ``ops.precision.linear``/``conv1d`` and of the model's ``mha`` in one
    forward pass."""
    from nomad_tpu_torch.models import wav2vec2

    calls = []

    def spy(fn, site):
        def wrapped(*args, **kw):
            calls.append(site(*args, **kw) + (1,))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(precision, "linear", spy(
        precision.linear, lambda x, w, b, prec: (("dot", w.shape[1], w.shape[0]), {prec})))
    monkeypatch.setattr(precision, "conv1d", spy(
        precision.conv1d, lambda x, w, b, prec, **kw: (("conv", tuple(w.shape[::-1])), {prec})))
    monkeypatch.setattr(wav2vec2, "mha", spy(
        wav2vec2.mha, lambda *a, precision, **kw: (("attn",), {precision})))
    with torch.inference_mode():
        model(torch.from_numpy(wav), torch.from_numpy(lengths).long())
    return calls


# the tail split (the last block at "default"), its control (the head at
# "default", the tail at "high": scripts/precision_ladder.py's) and the root
TAIL_CASES = [("tail_default", dict(encoder_tail_start=1, encoder_tail_precision="default")),
              ("head_default_tail_high", dict(encoder_precision="default", encoder_tail_start=1,
                                              encoder_tail_precision="high"))]
PLACEMENT_CASES = (CASES + [(mode, PRECISION_ISLANDS[mode]) for mode in ("balanced", "fast")]
                   + TAIL_CASES + [(f"matmul_{p}", {"matmul_precision": p})
                                   for p in ("default", "highest")])


def jax_trace_products(params, kw, wav, lengths):
    """``jax_products`` of the JAX model's forward pass under config ``kw``."""
    jmodel = JaxNomadModel(JaxConfig.tiny(**kw), emb_dim=EMB)
    return jax_products(jax.make_jaxpr(lambda p: jmodel.apply(
        p, jnp.asarray(wav), jnp.asarray(lengths)))(params).jaxpr,
        kw.get("encoder_tail_start", -1))


def test_jax_products_takes_the_tail_branch(bridged):
    """The walk of the tail split's ``cond`` against precisions written out
    by hand: the frontend's 3 convs, the feature projection and the
    positional conv at "high"; block 0 (the head) q/k/v "high", the
    attention "highest", out, fc1 and fc2 "high"; block 1 (the tail) all 7
    at "default"."""
    params, _, wav, lengths = bridged
    kw = dict(attn_score_precision="highest", encoder_tail_start=1,
              encoder_tail_precision="default")
    got = [prec for _, prec, _ in jax_trace_products(params, kw, wav, lengths)]
    want = ["high"] * 5 + ["high"] * 3 + ["highest"] + ["high"] * 3 + ["default"] * 7
    assert got == [{p} for p in want]


@pytest.mark.parametrize("name,kw", PLACEMENT_CASES, ids=[c[0] for c in PLACEMENT_CASES])
def test_islands_placed_as_in_jax(bridged, monkeypatch, name, kw):
    """Each product and convolution of the port's forward pass, at the
    precision the JAX package's ``default_matmul_precision`` contexts give
    the same product in its trace (jaxpr precision of each dot_general and
    conv_general_dilated): the same sites, in the same order."""
    params, sd, wav, lengths = bridged
    theirs = jax_trace_products(params, kw, wav, lengths)
    model = NomadModel(Wav2Vec2Config.tiny(**kw), emb_dim=EMB)
    model.load_state_dict(sd)
    ours = port_products(monkeypatch, model.eval(), wav, lengths)
    assert [(site, prec) for site, prec, _ in theirs] == [(site, prec) for site, prec, _ in ours]
    assert all(n == 2 for site, _, n in theirs if site == ("attn",))
    assert len(ours) == 3 + 2 + 7 * 2  # frontend convs, projection + pos-conv, 7 per block


# ---------------- (b) f32 islands are today's "exact", bit for bit ----------------


@pytest.mark.parametrize("kw", [
    dict(attn_score_precision="highest", ffn1_precision="highest", posconv_precision="high"),
    dict(frontend_precision="highest", encoder_precision="high"),
], ids=["finest", "outer"])
def test_f32_islands_are_bit_equal_to_exact(bridged, kw):
    _, sd, wav, lengths = bridged
    base = port_embed(sd, Wav2Vec2Config.tiny(), wav, lengths)
    np.testing.assert_array_equal(port_embed(sd, Wav2Vec2Config.tiny(**kw), wav, lengths), base)


# ---------------- (c) one bf16 pass against its float64 emulation ----------------


def test_linear_default_matches_emulation():
    rng = np.random.default_rng(1)
    x, w, b = unit_class(rng, (3, 37, 96)), unit_class(rng, (80, 96)), unit_class(rng, (80,))
    ours = precision.linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                            "default").numpy()
    emu = bf16_np(x) @ bf16_np(w).T + b.astype(np.float64)
    np.testing.assert_allclose(ours, emu, rtol=1e-5, atol=1e-5 * np.abs(emu).max())
    assert np.abs(ours - x @ w.T - b).max() > 1e-3  # the operands were rounded
    exact = precision.linear(torch.from_numpy(x), torch.from_numpy(w), None, "high")
    assert torch.equal(exact, torch.nn.functional.linear(torch.from_numpy(x), torch.from_numpy(w)))


def test_conv1d_default_matches_emulation():
    """The grouped positional conv's shape class (k even, SamePad-style
    padding, groups): f32 operands rounded to bf16, f32 sums and output
    (the TPU's pass: the output is not rounded), then the f32 bias."""
    rng = np.random.default_rng(2)
    bsz, c, t, k, groups = 2, 32, 70, 16, 4
    x, w, b = unit_class(rng, (bsz, c, t)), unit_class(rng, (c, c // groups, k)), unit_class(rng, (c,))
    ours = precision.conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                            "default", padding=k // 2, groups=groups).numpy()
    xq = np.pad(bf16_np(x), ((0, 0), (0, 0), (k // 2, k // 2)))
    wq = bf16_np(w)
    t_out = t + 2 * (k // 2) - k + 1
    cg = c // groups
    conv = np.zeros((bsz, c, t_out))
    for o in range(c):
        grp = o // cg
        for j in range(k):
            conv[:, o] += np.einsum("bct,c->bt", xq[:, grp * cg:(grp + 1) * cg, j:j + t_out], wq[o, :, j])
    emu = conv + b.astype(np.float64)[:, None]
    np.testing.assert_allclose(ours, emu, rtol=1e-5, atol=1e-5 * np.abs(emu).max())


def test_flash_attention_default_matches_emulation():
    """flash_attention_ref(..., "default"): s = bf16(q/8) . bf16(k), p =
    exp(s - m), l the sum of the unrounded p, O = bf16(p) . bf16(v) / l,
    LSE = m + log l. The scores are exact in both (see unit_class); p is
    f32 exp against float64 exp, so the rows where some p lies within
    1e-6 of a bf16 rounding midpoint are left out (and must be few)."""
    rng = np.random.default_rng(3)
    b, t, h, d = 3, 50, 2, 64
    lengths = [50, 31, 1]
    q, k, v = (unit_class(rng, (b, t, h, d)) for _ in range(3))
    o, lse = flash_attention.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(lengths, dtype=torch.int32), "default")
    o, lse = o.numpy(), lse.numpy()
    checked = 0
    for i, n in enumerate(lengths):
        s = np.einsum("qhd,khd->hqk", bf16_np(q[i] / 8.0), bf16_np(k[i, :n]))
        m = s.max(axis=-1, keepdims=True)
        p = np.exp(s - m)
        l = p.sum(axis=-1, keepdims=True)
        emu = np.einsum("hqk,khd->qhd", bf16_np(p.astype(np.float32)), bf16_np(v[i, :n]))
        emu = emu / l.transpose(1, 0, 2)
        np.testing.assert_allclose(lse[i], (m + np.log(l))[..., 0], rtol=0, atol=5e-6)
        lo, hi = bf16_np((p * (1 - 1e-6)).astype(np.float32)), bf16_np((p * (1 + 1e-6)).astype(np.float32))
        clear = (lo == hi).all(axis=-1).T  # [T, H]: rows whose every p rounds one way
        scale = np.abs(emu).max()
        diff = np.abs(o[i] - emu).max(axis=-1)
        assert (diff[clear] <= 1e-5 * scale).all(), (i, diff[clear].max() / scale)
        checked += clear.sum()
    assert checked >= 0.9 * b * t * h, checked
    # the f32 flavour differs: the rounding really happens
    o32, _ = flash_attention.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(lengths, dtype=torch.int32))
    assert np.abs(o32.numpy() - o).max() > 1e-4


# ---------------- (d) the modes against the JAX package's ----------------


@pytest.mark.parametrize("mode", ["balanced", "fast"])
def test_modes_against_jax(bridged, mode):
    params, sd, wav, lengths = bridged
    jcfg = JaxConfig.tiny(**PRECISION_ISLANDS[mode])
    theirs = np.asarray(JaxNomadModel(jcfg, emb_dim=EMB).apply(
        params, jnp.asarray(wav), jnp.asarray(lengths)))
    exact = port_embed(sd, Wav2Vec2Config.tiny(), wav, lengths)
    ours = port_embed(sd, Wav2Vec2Config.tiny(**PRECISION_ISLANDS[mode]), wav, lengths)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(exact, theirs, atol=1e-5, rtol=0)  # XLA's CPU: f32
    assert np.abs(ours - exact).max() > 1e-5  # the port rounds
    assert np.abs(ours - theirs).max() <= TOL_MODE_VS_JAX, np.abs(ours - theirs).max()


# ---------------- (e) refusals ----------------


def test_refusals_name_roadmap(bridged):
    """The modes refuse nothing now: the trainer's ``fast_bf16`` (bf16
    activations) on the fused path builds (``tests/test_torch_bf16_paths.py``
    holds it to the JAX package). ``fused_qkv`` under a "default" encoder
    island (K4's bf16 mode, K4b) gives finite embeddings that round
    (``tests/test_torch_fused_modes.py`` holds it to the JAX package);
    "high" keeps the f32 K4 (the card's high3). The gradients and dropout
    under a bf16 island work too (``tests/test_torch_grad_modes.py``)."""
    _, sd, wav, lengths = bridged
    wave = torch.from_numpy(wav[:1, :800])
    tr = Training({"experiment_name": "quality_nmr", "model_size": "tiny",
                   "precision": "fast_bf16"}, device="cpu",
                  model_config=Wav2Vec2Config.tiny(**PRECISION_ISLANDS["fast"],
                                                   attention_impl="fused_qkv",
                                                   encoder_dtype=torch.bfloat16))
    assert tr.model_config.attention_impl == "fused_qkv"
    assert tr.model_config.block_dtype == torch.bfloat16
    embs = {}
    for prec in ("default", "high"):
        fused = NomadModel(Wav2Vec2Config.tiny(attention_impl="fused_qkv",
                                               encoder_precision=prec), emb_dim=EMB)
        fused.load_state_dict(sd)
        with torch.no_grad():
            embs[prec] = fused(wave)
        assert torch.isfinite(embs[prec]).all()
    assert (embs["default"] - embs["high"]).abs().max() > 1e-5


# ---------------- the API and the service in a mode ----------------


@pytest.fixture(scope="module")
def wav_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("modes")
    rng = np.random.default_rng(5)
    for sub, count in (("nmr", 2), ("deg", 3)):
        (root / sub).mkdir()
        for i in range(count):
            write_wav(str(root / sub / f"{sub}{i}.wav"),
                      (0.2 * rng.standard_normal(1600 + 200 * i)).astype(np.float32), 16000, bits=16)
    return root


def tiny_nomad(sd, mode):
    return tapi.Nomad(device="cpu", config=Wav2Vec2Config.tiny(**PRECISION_ISLANDS[mode]),
                      emb_dim=EMB, params=sd, precision=mode)


def test_api_scores_and_forward_only_loss_in_each_mode(bridged, wav_tree, tmp_path):
    """Nomad(precision=...).predict and the embeddings in each mode on the
    CPU; the modes' scores differ from "exact"'s by bf16 rounding; the loss
    runs forward-only, and with a gradient, which differs from "exact"'s by
    bf16 rounding (the modes' gradients against the JAX package's are in
    ``tests/test_torch_grad_modes.py``)."""
    _, sd, _, _ = bridged
    tables, embs, grads = {}, {}, {}
    for mode in PRECISION_ISLANDS:
        n = tiny_nomad(sd, mode)
        _, dm = n.predict("dir", str(wav_tree / "nmr"), str(wav_tree / "deg"), None)
        tables[mode] = dm.values
        embs[mode] = n.get_embeddings(str(wav_tree / "deg")).values
        est, clean = torch.zeros(2, 1600), 0.1 * torch.ones(2, 1600)
        with torch.no_grad():
            assert np.isfinite(n.forward(est, clean).item())
        noisy = np.random.default_rng(6).standard_normal((2, 1600)).astype(np.float32)
        est_g = torch.from_numpy(0.1 * noisy).requires_grad_()
        n.forward(est_g, clean).backward()
        grads[mode] = est_g.grad.numpy()
        assert np.isfinite(grads[mode]).all() and np.abs(grads[mode]).max() > 0
    for mode in ("balanced", "fast"):
        assert 0 < np.abs(embs[mode] - embs["exact"]).max() < 1e-2
        assert np.abs(tables[mode] - tables["exact"]).max() < 1e-2
        # measured 5.1e-2 (balanced) and 2.1e-2 (fast) of max |g|, L1 signs
        # that flip included; 0.15 is 3x the larger
        rel = np.abs(grads[mode] - grads["exact"]).max() / np.abs(grads["exact"]).max()
        assert 0 < rel < 0.15, (mode, rel)
    # the default stays "exact" (the JAX package's is "balanced")
    assert tapi.Nomad(device="cpu").config == Wav2Vec2Config.base()
    assert JaxNomad(device="cpu").config == JaxConfig.balanced()
    assert tapi.Nomad(device="cpu", precision="balanced").config == Wav2Vec2Config.balanced()


@pytest.mark.parametrize("mode", ["balanced", "fast"])
def test_serve_precision_flag(wav_tree, tmp_path, monkeypatch, capsys, mode):
    """``python -m nomad_tpu_torch.serve --model tiny --device cpu
    --precision <mode>``: the tiny model takes the mode's islands, scores,
    and ``stats`` reports the mode."""
    reqs = [{"op": "score", "nmr": str(wav_tree / "nmr"), "deg": str(wav_tree / "deg"),
             "results_path": None}, {"op": "stats"}, {"op": "shutdown"}]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(json.dumps(r) for r in reqs) + "\n"))
    built = []
    real = serve.NomadServer.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        built.append(self)

    monkeypatch.setattr(serve.NomadServer, "__init__", spy)
    monkeypatch.chdir(tmp_path)  # no weights there: the seeded init
    serve.main(["--model", "tiny", "--device", "cpu", "--precision", mode])
    resps = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert [r["ok"] for r in resps] == [True, True, True]
    assert resps[1]["precision"] == mode and len(resps[0]["avg"]) == 3
    assert built[0].nomad.config == Wav2Vec2Config.tiny(**PRECISION_ISLANDS[mode])
