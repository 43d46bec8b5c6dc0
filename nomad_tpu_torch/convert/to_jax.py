"""Weight bridge back: this port's ``state_dict`` -> the JAX package's
flat parameter dict (the inverse of ``from_jax.jax_to_state_dict``).

The result is the ``{"backbone/encoder/layers/layer/fc1/kernel": array}``
dict that ``np.savez`` writes as the JAX package's ``best_model.npz`` and
``nomad_tpu_params.npz`` (its ``_flatten`` of the flax params), so a
checkpoint the port trains loads into the JAX package:

  * Linear weights [out, in] -> Dense kernels [in, out];
  * Conv1d weights [out, in/groups, k] -> conv kernels [k, in/groups, out];
  * norm ``weight`` (1-D) -> ``scale``;
  * ``backbone.encoder.layers.<i>.*`` -> one ``[L, ...]`` stacked leaf.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .from_jax import STACKED

_LAYERS = ".".join(STACKED[:3]) + "."  # "backbone.encoder.layers."


def jax_name(name: str, ndim: int) -> tuple[str, int | None]:
    """Port parameter name (and its rank) -> (flat JAX key, layer index of
    a stacked leaf or None)."""
    parts = name.split(".")
    leaf = parts[-1]
    if leaf == "weight":
        leaf = "scale" if ndim == 1 else "kernel"
    elif leaf != "bias":
        raise KeyError(f"unknown parameter leaf in {name!r}")
    if name.startswith(_LAYERS):
        return "/".join(STACKED + tuple(parts[4:-1]) + (leaf,)), int(parts[3])
    return "/".join(parts[:-1] + [leaf]), None


def _kernel(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 3:
        return np.transpose(arr, (2, 1, 0))
    return arr


def state_dict_to_jax(sd: Mapping) -> dict[str, np.ndarray]:
    """Port state_dict (tensors or arrays) -> flat JAX params (f32 numpy)."""
    flat: dict[str, np.ndarray] = {}
    stacked: dict[str, dict[int, np.ndarray]] = {}
    for name, value in sd.items():
        # a copy: never a view of the caller's (CPU) tensors
        arr = np.array(value.detach().cpu() if hasattr(value, "detach") else value,
                       dtype=np.float32)
        key, layer = jax_name(name, arr.ndim)
        arr = np.ascontiguousarray(_kernel(arr))
        if layer is None:
            flat[key] = arr
        else:
            stacked.setdefault(key, {})[layer] = arr
    for key, layers in stacked.items():
        flat[key] = np.stack([layers[i] for i in range(len(layers))])
    return flat
