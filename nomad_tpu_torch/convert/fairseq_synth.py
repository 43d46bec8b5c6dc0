"""Write fairseq-*named* checkpoints from the port's ``NomadModel``
(counterpart of ``nomad_tpu.convert.fairseq_synth``, which writes them from
an HF torch oracle).

No real ``wav2vec_small.pt`` or ``nomad_best_model.pt`` is in the
repository, so the loading path (``Nomad`` -> ``from_fairseq``) is
exercised on files written in their exact key layout from seeded weights:

  * fairseq checkpoint: ``{"model": {"feature_extractor.conv_layers.{i}.0.weight",
    "feature_extractor.conv_layers.0.2.{weight,bias}" (GroupNorm),
    "post_extract_proj.*", "layer_norm.*" (post-extract LN),
    "encoder.pos_conv.0.{weight_g,weight_v,bias}", "encoder.layer_norm.*",
    "encoder.layers.{i}.self_attn.{q,k,v,out}_proj.*",
    "encoder.layers.{i}.{self_attn_layer_norm,fc1,fc2,final_layer_norm}.*"},
    "args": None, "cfg": None}``;
  * NOMAD TripletModel state_dict: the same keys under ``ssl_model.`` plus
    ``embedding_layer.1.{weight,bias}`` (the Linear of
    ``Sequential(ReLU, Linear)``).

The positional conv is written weight-normed as torch ``weight_norm(dim=2)``
stores it: ``weight_g`` = ||w|| over dims (0, 1) (summed in float64),
``weight_v`` = w, so the loader's composition g * v / ||v|| gives w back to
within f32 rounding.
"""

from __future__ import annotations

import torch

from ..models.heads import NomadModel

_BLOCK = ("self_attn_layer_norm", "fc1", "fc2", "final_layer_norm")


def fairseq_names(model: NomadModel) -> dict[str, torch.Tensor]:
    """The backbone of ``model`` under fairseq's wav2vec 2.0 names."""
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    cfg = model.config
    out = {}
    for i in range(len(cfg.conv_dim)):
        out[f"feature_extractor.conv_layers.{i}.0.weight"] = \
            sd[f"backbone.feature_encoder.conv_{i}.weight"]
    for leaf in ("weight", "bias"):
        out[f"feature_extractor.conv_layers.0.2.{leaf}"] = \
            sd[f"backbone.feature_encoder.group_norm.{leaf}"]
        out[f"layer_norm.{leaf}"] = sd[f"backbone.feature_layer_norm.{leaf}"]
        out[f"post_extract_proj.{leaf}"] = sd[f"backbone.post_extract_proj.{leaf}"]
        out[f"encoder.layer_norm.{leaf}"] = sd[f"backbone.encoder.layer_norm.{leaf}"]
    w = sd["backbone.encoder.pos_conv.conv.weight"]
    # the norm in float64: an f32 sum over 36,864 taps at BASE rounds to ~5e-6
    out["encoder.pos_conv.0.weight_g"] = torch.linalg.vector_norm(
        w.double(), dim=(0, 1), keepdim=True).float()
    out["encoder.pos_conv.0.weight_v"] = w
    out["encoder.pos_conv.0.bias"] = sd["backbone.encoder.pos_conv.conv.bias"]
    for i in range(cfg.num_layers):
        src, dst = f"backbone.encoder.layers.{i}", f"encoder.layers.{i}"
        for leaf in ("weight", "bias"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                out[f"{dst}.self_attn.{proj}.{leaf}"] = sd[f"{src}.{proj}.{leaf}"]
            for module in _BLOCK:
                out[f"{dst}.{module}.{leaf}"] = sd[f"{src}.{module}.{leaf}"]
    return out


def write_fairseq_checkpoint(model: NomadModel, path: str) -> None:
    """Save the backbone as a ``wav2vec_small.pt``-shaped file."""
    torch.save({"model": fairseq_names(model), "args": None, "cfg": None}, path)


def write_nomad_checkpoint(model: NomadModel, path: str) -> None:
    """Save backbone and scoring head as a ``nomad_best_model.pt``-shaped
    TripletModel state_dict."""
    sd = {f"ssl_model.{k}": v for k, v in fairseq_names(model).items()}
    head = model.embedding
    sd["embedding_layer.1.weight"] = head.weight.detach().cpu().clone()
    sd["embedding_layer.1.bias"] = head.bias.detach().cpu().clone()
    torch.save(sd, path)
