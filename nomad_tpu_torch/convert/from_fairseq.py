"""torch checkpoints of the NOMAD ecosystem -> this port's ``state_dict``
(counterpart of ``nomad_tpu.convert.torch_to_jax``).

Reads the three checkpoint families the JAX package reads:

  * **fairseq** ``wav2vec_small.pt``: its state under ``ckpt["model"]``,
    keys like ``feature_extractor.conv_layers.0.0.weight``;
  * **NOMAD** ``nomad_best_model.pt``: a TripletModel state_dict, the
    backbone under ``ssl_model.`` plus ``embedding_layer.1.{weight,bias}``
    (the Linear of ``Sequential(ReLU, Linear)``);
  * **HuggingFace** ``Wav2Vec2Model``: the same architecture under other
    names.

``canonicalize`` is a copy of the JAX package's (names and skip list).
``fairseq_to_state_dict`` goes straight to the port's ``NomadModel``
names; Linear and Conv1d weights keep torch's layout. The weight-normed
positional conv is composed as g * v / ||v|| with the norm over dims
(0, 1) (torch ``weight_norm(dim=2)``), in float64 as the JAX package
composes it, so both packages hold the same bits. ``merge_into`` overlays
the converted tensors on a model's own state_dict with shape checks; the
lossnet head (quirk Q7), which no checkpoint holds, keeps its init.

A genuine fairseq checkpoint pickles fairseq's config classes, which
``torch.load`` cannot unpickle without fairseq installed; the JAX package
has the same limit.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def _compose_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """torch weight_norm with dim=2 on a [out, in/groups, k] conv weight."""
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=(0, 1), keepdims=True))
    return (g.astype(np.float64) * v.astype(np.float64) / norm).astype(np.float32)


_HF_LAYER = re.compile(r"encoder\.layers\.(\d+)\.(.+)")

_HF_ATTN = {
    "attention.q_proj": "q_proj",
    "attention.k_proj": "k_proj",
    "attention.v_proj": "v_proj",
    "attention.out_proj": "out_proj",
    "layer_norm": "self_attn_layer_norm",
    "feed_forward.intermediate_dense": "fc1",
    "feed_forward.output_dense": "fc2",
    "final_layer_norm": "final_layer_norm",
}

_FS_ATTN = {
    "self_attn.q_proj": "q_proj",
    "self_attn.k_proj": "k_proj",
    "self_attn.v_proj": "v_proj",
    "self_attn.out_proj": "out_proj",
    "self_attn_layer_norm": "self_attn_layer_norm",
    "fc1": "fc1",
    "fc2": "fc2",
    "final_layer_norm": "final_layer_norm",
}

_SKIP_PATTERNS = (
    "quantizer",
    "project_q",
    "final_proj",
    "mask_emb",
    "masked_spec_embed",
    "spec_embed",
    "adapter",
)

# canonical name -> port name, for the names that do not depend on an index
_TOP = {
    "group_norm": "backbone.feature_encoder.group_norm",
    "feature_layer_norm": "backbone.feature_layer_norm",
    "post_extract_proj": "backbone.post_extract_proj",
    "encoder_layer_norm": "backbone.encoder.layer_norm",
}
_LAYER_MODULES = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2",
                  "self_attn_layer_norm", "final_layer_norm")


def canonicalize(sd: Mapping) -> dict[str, np.ndarray]:
    """Normalize fairseq/HF/NOMAD names to one canonical flat dict:

      conv.{i}.weight, group_norm.{weight,bias},
      feature_layer_norm.{weight,bias}, post_extract_proj.{weight,bias},
      pos_conv.{weight_g,weight_v,bias} (or pos_conv.weight already composed),
      encoder_layer_norm.{weight,bias},
      layer.{i}.{q_proj,k_proj,v_proj,out_proj,self_attn_layer_norm,fc1,fc2,
                 final_layer_norm}.{weight,bias},
      embedding.{weight,bias}            (NOMAD scoring head)
    """
    out: dict[str, np.ndarray] = {}
    for key, val in sd.items():
        k = key
        for prefix in ("wav2vec2.", "ssl_model.", "model.", "w2v_encoder.w2v_model."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if any(p in k for p in _SKIP_PATTERNS):
            continue
        v = _np(val)

        if k.startswith("embedding_layer.1."):
            out["embedding." + k.split(".")[-1]] = v
            continue

        m = re.match(r"feature_extractor\.conv_layers\.(\d+)\.(.+)", k)
        if m:
            i, rest = int(m.group(1)), m.group(2)
            if rest in ("0.weight", "conv.weight"):
                out[f"conv.{i}.weight"] = v
            elif rest in ("2.weight", "2.2.weight", "layer_norm.weight"):
                out["group_norm.weight"] = v
            elif rest in ("2.bias", "2.2.bias", "layer_norm.bias"):
                out["group_norm.bias"] = v
            continue

        if k.startswith("layer_norm."):  # fairseq post-extractor LN
            out["feature_layer_norm." + k.split(".")[-1]] = v
            continue
        if k.startswith("feature_projection.layer_norm."):
            out["feature_layer_norm." + k.split(".")[-1]] = v
            continue
        if k.startswith("post_extract_proj."):
            out["post_extract_proj." + k.split(".")[-1]] = v
            continue
        if k.startswith("feature_projection.projection."):
            out["post_extract_proj." + k.split(".")[-1]] = v
            continue

        if "pos_conv" in k:
            leaf = k.split(".")[-1]
            if "original0" in k or leaf == "weight_g":
                out["pos_conv.weight_g"] = v
            elif "original1" in k or leaf == "weight_v":
                out["pos_conv.weight_v"] = v
            elif leaf == "bias":
                out["pos_conv.bias"] = v
            elif leaf == "weight":
                out["pos_conv.weight"] = v
            continue

        if k.startswith("encoder.layer_norm."):
            out["encoder_layer_norm." + k.split(".")[-1]] = v
            continue

        m = _HF_LAYER.match(k)
        if m:
            i, rest = int(m.group(1)), m.group(2)
            for table in (_FS_ATTN, _HF_ATTN):
                hit = None
                for src, dst in table.items():
                    if rest.startswith(src + "."):
                        hit = (dst, rest[len(src) + 1:])
                        break
                if hit:
                    out[f"layer.{i}.{hit[0]}.{hit[1]}"] = v
                    break
            continue
        # anything else (dropout has no parameters; unknown heads) is ignored
    return out


def fairseq_to_state_dict(canon: Mapping[str, np.ndarray], num_layers: int = 12,
                          num_conv_layers: int = 7) -> dict[str, torch.Tensor]:
    """Canonical flat dict -> port ``NomadModel`` state_dict entries (the
    scoring head only when the checkpoint holds it)."""
    sd: dict[str, np.ndarray] = {}
    for i in range(num_conv_layers):
        sd[f"backbone.feature_encoder.conv_{i}.weight"] = canon[f"conv.{i}.weight"]
    for name, port in _TOP.items():
        for leaf in ("weight", "bias"):
            sd[f"{port}.{leaf}"] = canon[f"{name}.{leaf}"]
    if "embedding.weight" in canon:
        sd["embedding.weight"] = canon["embedding.weight"]
        sd["embedding.bias"] = canon["embedding.bias"]
    if "pos_conv.weight" in canon:
        pos_w = canon["pos_conv.weight"]
    else:
        pos_w = _compose_weight_norm(canon["pos_conv.weight_g"], canon["pos_conv.weight_v"])
    sd["backbone.encoder.pos_conv.conv.weight"] = pos_w
    sd["backbone.encoder.pos_conv.conv.bias"] = canon["pos_conv.bias"]
    for i in range(num_layers):
        for module in _LAYER_MODULES:
            for leaf in ("weight", "bias"):
                sd[f"backbone.encoder.layers.{i}.{module}.{leaf}"] = \
                    canon[f"layer.{i}.{module}.{leaf}"]
    return {k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in sd.items()}


def load_torch_checkpoint(path: str) -> dict[str, np.ndarray]:
    """A .pt file (fairseq checkpoint dict or raw state_dict) -> numpy dict."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]  # fairseq checkpoint wrapper
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: _np(v) for k, v in obj.items()
            if hasattr(v, "detach") or isinstance(v, np.ndarray)}


def convert_checkpoint(path: str, num_layers: int = 12,
                       num_conv_layers: int = 7) -> dict[str, torch.Tensor]:
    """One call: a .pt path -> port state_dict entries (backbone, plus the
    scoring head when present)."""
    return fairseq_to_state_dict(canonicalize(load_torch_checkpoint(path)), num_layers,
                                 num_conv_layers)


def merge_into(state_dict: Mapping[str, torch.Tensor],
               converted: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A copy of ``state_dict`` with the converted tensors overlaid; every
    converted name must exist there with the same shape."""
    out = dict(state_dict)
    for name, value in converted.items():
        if name not in out:
            raise KeyError(f"converted parameter {name} not in the model's state_dict")
        if tuple(out[name].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {name}: model {tuple(out[name].shape)} vs "
                             f"checkpoint {tuple(value.shape)}")
        out[name] = value.to(torch.float32)
    return out
