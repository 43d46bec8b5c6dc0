"""nomad_tpu_torch: NOMAD scoring in PyTorch, with hand-written CUDA
kernels for an NVIDIA H100.

The port of ``nomad_tpu`` (JAX on a TPU), kept beside it; it imports
nothing of JAX or of the JAX package. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``, and raise when CUDA is missing rather
than fall back to the CPU. Use ``nomad_tpu_torch.api.Nomad`` or
``python -m nomad_tpu_torch --mode dir --nmr ... --deg ...`` to score,
``nomad_tpu_torch.training.Training`` or
``python -m nomad_tpu_torch.main --config_file ...`` to train and evaluate.
"""

__all__ = ["api", "convert", "io", "main", "models", "ops", "scoring", "training", "utils"]
