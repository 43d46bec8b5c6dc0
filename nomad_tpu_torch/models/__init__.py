"""Models of the port: the wav2vec2 backbone, the NOMAD heads and the SE
demo's Wave-U-Net."""

from .heads import NomadModel, init_weights, l2_normalize, nomad_loss
from .waveunet import WaveUNet, interpolate_linear_x2
from .wav2vec2 import (
    ConvFeatureEncoder,
    EncoderLayer,
    MaskedGroupNorm,
    PositionalConvEmbedding,
    TransformerEncoder,
    Wav2Vec2Config,
    Wav2Vec2Model,
    feature_frame_lengths,
    masked_mean,
)

__all__ = [
    "ConvFeatureEncoder",
    "EncoderLayer",
    "MaskedGroupNorm",
    "NomadModel",
    "PositionalConvEmbedding",
    "TransformerEncoder",
    "Wav2Vec2Config",
    "Wav2Vec2Model",
    "WaveUNet",
    "feature_frame_lengths",
    "init_weights",
    "interpolate_linear_x2",
    "l2_normalize",
    "masked_mean",
    "nomad_loss",
]
