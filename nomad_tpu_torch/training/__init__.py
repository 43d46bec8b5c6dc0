"""Triplet training and its four evals (counterpart of
``nomad_tpu.training``): ``Training``, its data, losses and checkpoints."""

from .triplet import Training, param_labels

__all__ = ["Training", "param_labels"]
