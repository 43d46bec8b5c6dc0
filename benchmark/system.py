"""The system under test, built from a configuration file: the port's
``Nomad`` on seeded weights, and the weights themselves."""

from __future__ import annotations

from . import weights
from .reference import wav2vec2 as ref_w2v


def nomad_weights(run, config: dict) -> dict:
    """The seeded weights of a wav2vec 2.0 + NOMAD configuration."""
    shapes = ref_w2v.param_shapes(config["wav2vec2"], config["emb_dim"])
    return weights.seeded(shapes, run.seed, run.device)


def make_nomad(run, config: dict, sd: dict):
    """``nomad_tpu_torch.api.Nomad`` at the configuration's widths and
    precision on the seeded weights ``sd``, its model loaded."""
    from nomad_tpu_torch.api import Nomad
    from nomad_tpu_torch.models.wav2vec2 import PRECISION_ISLANDS, Wav2Vec2Config

    w = config["wav2vec2"]
    cfg = Wav2Vec2Config(
        conv_dim=tuple(w["conv_dim"]), conv_kernel=tuple(w["conv_kernel"]),
        conv_stride=tuple(w["conv_stride"]), hidden_size=w["hidden_size"],
        num_layers=w["num_layers"], num_heads=w["num_heads"], ffn_dim=w["ffn_dim"],
        pos_conv_kernel=w["pos_conv_kernel"], pos_conv_groups=w["pos_conv_groups"],
        layer_norm_eps=w["layer_norm_eps"], attention_impl=config["attention_impl"],
        **PRECISION_ISLANDS[config["precision"]])
    nomad = Nomad(device=run.device, config=cfg, emb_dim=config["emb_dim"], params=sd,
                  precision=config["precision"])
    nomad.model  # noqa: B018 - loads the weights onto the device
    return nomad

