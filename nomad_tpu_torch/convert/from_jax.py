"""Weight bridge: the JAX package's flax parameter tree -> this port's
``state_dict``.

Takes the nested tree (``NomadModel.init_all`` params, with or without the
top-level ``"params"``) or the flat ``"backbone/feature_encoder/conv_0/
kernel"`` dict that ``nomad_tpu.api`` caches as ``nomad_tpu_params.npz``.
It inverts ``nomad_tpu.convert.torch_to_jax.to_flax_params``:

  * Dense kernels [in, out] -> Linear weights [out, in];
  * conv kernels [k, in/groups, out] -> Conv1d weights [out, in/groups, k];
  * LayerNorm/GroupNorm ``scale`` -> ``weight``;
  * the scan-stacked ``encoder/layers/layer/*`` leaves [L, ...] -> L layers.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

STACKED = ("backbone", "encoder", "layers", "layer")


def flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": array}; flat input passes through."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _leaf(name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 3:
            return "weight", np.transpose(arr, (2, 1, 0))
        raise ValueError(f"kernel of rank {arr.ndim} has no torch layout here")
    if name == "scale":
        return "weight", arr
    if name == "bias":
        return "bias", arr
    raise KeyError(f"unknown parameter leaf {name!r}")


def jax_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX NomadModel params (nested or npz-flat) -> port state_dict."""
    flat = flatten(params)
    if all(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()}
    sd: dict[str, np.ndarray] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if tuple(parts[:4]) == STACKED:
            module, leaf = parts[4], parts[5]
            for i in range(arr.shape[0]):
                name, val = _leaf(leaf, arr[i])
                sd[f"backbone.encoder.layers.{i}.{module}.{name}"] = val
        else:
            name, val = _leaf(parts[-1], arr)
            sd[".".join(parts[:-1] + [name])] = val
    return {k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in sd.items()}
