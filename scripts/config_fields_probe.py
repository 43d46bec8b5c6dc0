"""Where the port's ``dtype=bfloat16`` path stands against the JAX package's
on the CPU: the numbers behind the tolerances of
``tests/test_torch_config_fields.py`` (its tiny weights and inputs).

    JAX_PLATFORMS=cpu python scripts/config_fields_probe.py

Prints one JSON object:
  * ``bf16_conv``: a flax ``nn.Conv(dtype=bfloat16)`` on a seeded [2, 400,
    32] input (kernel 3, stride 2): the share of output elements where the
    JAX package's differs from the f32 sum of the bf16 operands rounded
    once, and where the port's ``precision.conv1d`` on the bf16 input does;
  * ``bf16_gelu``: on 100,000 seeded bf16 values, the share where
    ``jax.nn.gelu`` in bf16 (op by op, and jitted) differs from torch's
    ``F.gelu`` on bf16 (one rounding);
  * ``embeddings``: max |d| of the tiny model's embeddings between the
    port's ``dtype=bfloat16`` and the JAX model's jitted and op by op
    (both flash attention), between JAX's two runs, and between the port's
    bf16 and f32 paths;
  * ``waveform_grad``: on ``dtype=bfloat16``, the port's plain attention
    ("ref") against its flash path ("kernel"): the L1 loss's gradient
    (one sign pattern) at the frontend's output and at the waveform, max
    |d| / max |g|;
  * ``head_grad``: the same two paths' gradient at the last block's
    output from the lossnet head's term alone (a seeded sign pattern on
    the embedding), max |d| / max |g|, with the bf16 head (``dtype``) and
    with the f32 one (``encoder_dtype``), beside the two paths' distance
    in the last block's output, max |d| / max |x|.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import flax.linen as nn  # noqa: E402

from nomad_tpu.models import NomadModel as JaxNomadModel  # noqa: E402
from nomad_tpu.models import Wav2Vec2Config as JaxConfig  # noqa: E402
from nomad_tpu_torch.convert import jax_to_state_dict  # noqa: E402
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config  # noqa: E402
from nomad_tpu_torch.ops import precision  # noqa: E402

EMB, LENGTHS = 16, [1900, 1333, 800]
BF16 = torch.bfloat16


def f64(a):
    return np.asarray(a.float() if torch.is_tensor(a) else jnp.asarray(a, jnp.float32),
                      np.float64)


def bf16_conv() -> dict:
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 400, 32)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 32, 32))).astype(np.float32)
    conv = nn.Conv(32, (3,), strides=(2,), padding="VALID", use_bias=False,
                   dtype=jnp.bfloat16, param_dtype=jnp.float32)
    theirs = f64(conv.apply({"params": {"kernel": w}}, jnp.asarray(x)))
    once = f64(jax.lax.conv_general_dilated(
        jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32),
        jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32), (2,), "VALID",
        dimension_numbers=("NWC", "WIO", "NWC"), precision="highest").astype(jnp.bfloat16))
    ours = f64(precision.conv1d(torch.from_numpy(x).to(BF16).transpose(1, 2),
                                torch.from_numpy(w).permute(2, 1, 0).contiguous(), None,
                                "high", stride=2).transpose(1, 2))
    return {"elements": once.size, "jax_differs_share": float((theirs != once).mean()),
            "port_differs_share": float((ours != once).mean())}


def bf16_gelu() -> dict:
    x = jnp.asarray(np.random.default_rng(0).standard_normal(100_000).astype(np.float32)
                    ).astype(jnp.bfloat16)
    ours = f64(F.gelu(torch.from_numpy(np.array(x.astype(jnp.float32))).to(BF16)))
    eager = f64(jax.nn.gelu(x, approximate=False))
    jitted = f64(jax.jit(lambda v: jax.nn.gelu(v, approximate=False))(x))
    return {"op_by_op_differs_share": float((eager != ours).mean()),
            "jitted_differs_share": float((jitted != ours).mean())}


def model_numbers() -> tuple:
    rng = np.random.default_rng(23)
    wav = np.zeros((len(LENGTHS), max(LENGTHS)), np.float32)
    for i, n in enumerate(LENGTHS):
        wav[i, :n] = 0.3 * rng.standard_normal(n)
    lengths = np.asarray(LENGTHS, np.int32)
    params = JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB).init(
        jax.random.key(5), jnp.asarray(wav[:1, :800]), method=JaxNomadModel.init_all)
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = jax_to_state_dict(params)

    def port(cfg):
        model = NomadModel(cfg, emb_dim=EMB)
        model.load_state_dict(sd, strict=True)
        return model.eval()

    with torch.inference_mode():
        ours = {dt: f64(port(Wav2Vec2Config.tiny(dtype=dt))(
            torch.from_numpy(wav), torch.from_numpy(lengths).long()))
            for dt in (BF16, torch.float32)}
    jm = JaxNomadModel(JaxConfig.tiny(dtype=jnp.bfloat16, attention_impl="pallas"), emb_dim=EMB)
    args = (params, jnp.asarray(wav), jnp.asarray(lengths))
    eager, jitted = f64(jm.apply(*args)), f64(jax.jit(jm.apply)(*args))
    emb = {"port_vs_jax_jitted": np.abs(ours[BF16] - jitted).max(),
           "port_vs_jax_op_by_op": np.abs(ours[BF16] - eager).max(),
           "jax_op_by_op_vs_jitted": np.abs(eager - jitted).max(),
           "port_bf16_vs_port_f32": np.abs(ours[BF16] - ours[torch.float32]).max()}

    rng = np.random.default_rng(24)
    clean = torch.from_numpy((0.3 * rng.standard_normal((2, 1600))).astype(np.float32))
    est = clean + torch.from_numpy((0.05 * rng.standard_normal((2, 1600))).astype(np.float32))
    grads, signs = {}, None
    for impl in ("kernel", "ref"):
        model = port(Wav2Vec2Config.tiny(dtype=BF16, attention_impl=impl))
        if signs is None:
            with torch.no_grad():
                signs = [torch.sign(a.float() - c.float()) for a, c in zip(
                    model.forward_layers(est), model.forward_layers(clean))]
        feats = []

        def keep(module, args, out, feats=feats):
            if out[0].requires_grad:  # the estimate's pass: its frontend output's gradient
                out[0].retain_grad()
                feats.append(out[0])

        model.backbone.feature_encoder.register_forward_hook(keep)
        e = est.clone().requires_grad_()
        with torch.no_grad():
            ref = [c.float() for c in model.forward_layers(clean)]
        sum((s * (a.float() - c)).mean() for s, a, c in zip(
            signs, model.forward_layers(e), ref)).backward()
        grads[impl] = (feats[0].grad.float(), e.grad)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    grad = {"frontend_output": rel(grads["ref"][0], grads["kernel"][0]),
            "waveform": rel(grads["ref"][1], grads["kernel"][1])}
    return {k: float(v) for k, v in emb.items()}, grad, head_grad(sd, est)


def head_grad(sd, est) -> dict:
    out = {}
    for field in ("dtype", "encoder_dtype"):
        got = {}
        for impl in ("kernel", "ref"):
            model = NomadModel(Wav2Vec2Config.tiny(attention_impl=impl, **{field: BF16}),
                               emb_dim=EMB)
            model.load_state_dict(sd, strict=True)
            model.eval().requires_grad_(False)
            with torch.no_grad():
                x = model.backbone(est)["x"]
            x = x.clone().requires_grad_()
            e = model._embed(model.lossnet_embedding, {"x": x, "frame_lengths": None})
            signs = torch.sign(torch.randn(e.shape, generator=torch.Generator().manual_seed(1)))
            (signs * e).mean().backward()
            got[impl] = (x.grad.float(), x.detach().float())
        (gk, xk), (gr, xr) = got["kernel"], got["ref"]
        out[field] = {"grad": ((gr - gk).abs().max() / gk.abs().max()).item(),
                      "last_block_output": ((xr - xk).abs().max() / xk.abs().max()).item()}
    return out


def main() -> None:
    torch.set_num_threads(2)
    emb, grad, head = model_numbers()
    print(json.dumps({"bf16_conv": bf16_conv(), "bf16_gelu": bf16_gelu(), "embeddings": emb,
                      "waveform_grad": grad, "head_grad": head}))


if __name__ == "__main__":
    main()
