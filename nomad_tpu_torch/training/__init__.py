"""Triplet training and its four evals, and the speech-enhancement demo
(counterpart of ``nomad_tpu.training``): ``Training``,
``SpeechEnhancement``, their data, losses and checkpoints."""

from .data import PairedAudioDataset
from .se import SpeechEnhancement
from .triplet import Training, param_labels

__all__ = ["PairedAudioDataset", "SpeechEnhancement", "Training", "param_labels"]
