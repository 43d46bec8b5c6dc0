"""Where the speech-enhancement step's f32 results stand against an f64 run,
for the JAX package and for the port, on the CPU: the numbers behind the
tolerances of ``tests/test_torch_waveunet.py`` and ``tests/test_torch_se.py``.

    JAX_PLATFORMS=cpu python scripts/se_precision_probe.py

Prints one JSON object:
  * ``unet_train_output``: the 3-level Wave-U-Net (interval 4) in train
    mode on a seeded [2, 256] wave, max |Δ| against the port in f64 of the
    JAX package jitted, the JAX package op by op, and the port;
  * ``se_step``: one SE step (3-level U-Net of interval 24, the tiny
    lossnet, 2 × 16,384 samples) at ``nomad_weight`` 0.001 and 10: the
    U-Net gradients' max |Δ| / max|g| against the JAX package's loss in
    f64 (``jax.enable_x64``; its attention still forms scores and softmax
    in f32) for the JAX package op by op and jitted and for the port, the
    largest |Δ| / max|g| of each against the port, the largest gradient
    of a conv bias ahead of a batch norm (0 analytically) over max|g|, and
    the L1 terms' sign differences between the port and the JAX package.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from nomad_tpu.api import Nomad as JaxNomad  # noqa: E402
from nomad_tpu.api import _flatten, _unflatten  # noqa: E402
from nomad_tpu.models import NomadModel as JaxNomadModel  # noqa: E402
from nomad_tpu.models import Wav2Vec2Config as JaxConfig  # noqa: E402
from nomad_tpu.models.waveunet import WaveUNet as JaxWaveUNet  # noqa: E402
from nomad_tpu.training.se import SpeechEnhancement as JaxSE  # noqa: E402
from nomad_tpu_torch.api import Nomad  # noqa: E402
from nomad_tpu_torch.convert import jax_to_state_dict  # noqa: E402
from nomad_tpu_torch.convert import jax_to_waveunet, waveunet_to_jax  # noqa: E402
from nomad_tpu_torch.io import write_wav  # noqa: E402
from nomad_tpu_torch.models import Wav2Vec2Config, WaveUNet  # noqa: E402
from nomad_tpu_torch.training import SpeechEnhancement  # noqa: E402

SR, EMB = 16000, 16


def to64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def unet_train_output() -> dict:
    net = JaxWaveUNet(n_layers=3, channels_interval=4)
    variables = jax.device_get(jax.jit(lambda k, x: net.init(k, x, train=False))(
        jax.random.key(0), jnp.zeros((1, 256), jnp.float32)))
    x = (0.3 * np.random.default_rng(2).standard_normal((2, 256))).astype(np.float32)
    jitted = jax.jit(lambda v, x: net.apply(v, x, train=True, mutable=["batch_stats"])[0])
    outs = {"jax_jit": np.asarray(jitted(variables, x)),
            "jax_op_by_op": np.asarray(net.apply(variables, x, train=True,
                                                 mutable=["batch_stats"])[0])}
    port = WaveUNet(n_layers=3, channels_interval=4)
    port.load_state_dict(jax_to_waveunet(_flatten(variables)))
    port.train()
    with torch.no_grad():
        outs["port"] = port(torch.from_numpy(x)).numpy()
        truth = port.double()(torch.from_numpy(x).double()).numpy()
    return {k: float(np.abs(v - truth).max()) for k, v in outs.items()}


def write_pairs(root: Path) -> dict:
    rng = np.random.default_rng(5)
    cfg = {}
    for split in ("train", "valid", "test"):
        for kind in ("noisy", "clean"):
            (root / f"{kind}_{split}").mkdir()
            cfg[f"{kind}_{split}_dir"] = str(root / f"{kind}_{split}")
        for i in range(2):
            t = np.arange(20000) / SR
            clean = (0.2 * np.sin(2 * np.pi * rng.uniform(100, 220) * t)
                     * np.clip(np.sin(2 * np.pi * 1.3 * t), 0, 1)).astype(np.float32)
            noisy = clean + (0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
            write_wav(str(root / f"clean_{split}" / f"p{i}.wav"), clean, SR, bits=16)
            write_wav(str(root / f"noisy_{split}" / f"p{i}.wav"), noisy, SR, bits=16)
    return cfg | {"train_bs": 2, "valid_bs": 2, "test_bs": 2, "lr": 1e-3, "n_layers": 3}


def se_step(root: Path) -> dict:
    cfg = write_pairs(root)
    nomad_params = jax.device_get(JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB).init(
        jax.random.key(0), jnp.zeros((1, 800), jnp.float32), method=JaxNomadModel.init_all))
    jse = JaxSE(cfg, nomad=JaxNomad(config=JaxConfig.tiny(), emb_dim=EMB, params=nomad_params))
    port_nomad = Nomad(device="cpu", config=Wav2Vec2Config.tiny(), emb_dim=EMB,
                       params=jax_to_state_dict(nomad_params))
    init = _flatten(jax.device_get({"params": jse.params, "batch_stats": jse.batch_stats}))
    tree = _unflatten(init)
    noisy, clean = next(jse.train_set.batches(2, shuffle=False))
    pre_bn = [k for k in _flatten({"params": tree["params"]})
              if k.endswith("/conv/bias") and "out_conv" not in k]
    out = {}
    for weight in (0.001, 10.0):
        jse.nomad_weight = weight
        grad = jax.grad(jse._loss, has_aux=True)
        args = (tree["params"], tree["batch_stats"], nomad_params, noisy, clean,
                jax.random.key(0))
        grads = {"jax_op_by_op": grad(*args)[0], "jax_jit": jax.jit(grad)(*args)[0]}
        with jax.enable_x64(True):
            truth = _flatten({"params": jax.device_get(grad(*to64(args[:5]), args[5])[0])})
        port = SpeechEnhancement(dict(cfg, nomad_weight=weight), device="cpu", nomad=port_nomad)
        port.load_flat(init)
        port.train_step(noisy, clean)
        flat = {k: _flatten({"params": jax.device_get(g)}) for k, g in grads.items()}
        flat["port"] = waveunet_to_jax({n: p.grad for n, p in port.unet.named_parameters()})
        gmax = max(np.abs(g).max() for g in truth.values())
        res = {}
        for name, g in flat.items():
            res[name] = {
                "vs_f64": max(float(np.abs(g[k] - truth[k]).max() / gmax) for k in truth),
                "vs_port": max(float(np.abs(g[k] - flat["port"][k]).max() / gmax) for k in truth),
                "pre_bn_bias": max(float(np.abs(g[k]).max() / gmax) for k in pre_bn),
            }
        est = jse.unet.apply(tree, noisy, train=True, mutable=["batch_stats"])[0]
        layers = [jse.nomad.model.apply(nomad_params, x, method=JaxNomadModel.forward_layers)
                  for x in (est, jnp.asarray(clean))]
        port.unet.load_state_dict(jax_to_waveunet(init))
        port.unet.train()
        with torch.no_grad():
            p_est = port.unet(torch.from_numpy(noisy))
            p_layers = [port_nomad.model.forward_layers(x)
                        for x in (p_est, torch.from_numpy(clean))]
        res["l1_sign_differences"] = sum(
            int((np.sign(np.asarray(a) - np.asarray(c)) != torch.sign(pa - pc).numpy()).sum())
            for a, c, pa, pc in zip(*layers, *p_layers))
        out[f"weight_{weight}"] = res
    return out


def main() -> None:
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        result = {"unet_train_output": unet_train_output(), "se_step": se_step(Path(tmp))}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
