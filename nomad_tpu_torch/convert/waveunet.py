"""Weight bridge of the Wave-U-Net, both ways: the JAX package's SE
checkpoint (``SpeechEnhancement.save``: the flat
``_flatten({"params": …, "batch_stats": …})`` dict) <-> the port's
``WaveUNet.state_dict()``.

  * ``params/down_0/conv/kernel`` [k, in, out] <-> ``down_0.conv.weight``
    [out, in, k]; ``…/conv/bias`` <-> ``….conv.bias``;
  * ``params/…/bn/scale|bias`` <-> ``….bn.weight|bias``;
  * ``batch_stats/…/bn/mean|var`` <-> the buffers ``….bn.mean|var``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .from_jax import _leaf
from .to_jax import _kernel, jax_name

STATS = ("mean", "var")


def waveunet_to_jax(sd: Mapping) -> dict[str, np.ndarray]:
    """Port WaveUNet state_dict -> the JAX package's flat SE checkpoint
    dict (f32 numpy copies)."""
    flat = {}
    for name, value in sd.items():
        arr = np.array(value.detach().cpu() if hasattr(value, "detach") else value,
                       dtype=np.float32)
        parts = name.split(".")
        if parts[-1] in STATS:
            flat["batch_stats/" + "/".join(parts)] = arr
        else:
            flat["params/" + jax_name(name, arr.ndim)[0]] = np.ascontiguousarray(_kernel(arr))
    return flat


def jax_to_waveunet(flat: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's flat SE checkpoint dict -> port WaveUNet
    state_dict."""
    sd = {}
    for key, value in flat.items():
        group, *parts = key.split("/")
        arr = np.asarray(value)
        if group == "batch_stats" and parts[-1] in STATS:
            name, val = parts[-1], arr
        elif group == "params":
            name, val = _leaf(parts[-1], arr)
        else:
            raise KeyError(f"unknown Wave-U-Net checkpoint key {key!r}")
        sd[".".join(parts[:-1] + [name])] = torch.tensor(np.asarray(val, dtype=np.float32))
    return sd
