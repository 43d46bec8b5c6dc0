"""Models of the port: the wav2vec2 backbone and the NOMAD heads."""

from .heads import NomadModel, init_weights, l2_normalize, nomad_loss
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
    "feature_frame_lengths",
    "init_weights",
    "l2_normalize",
    "masked_mean",
    "nomad_loss",
]
