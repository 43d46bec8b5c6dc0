"""nomad_tpu_torch: NOMAD scoring in PyTorch, with hand-written CUDA
kernels for an NVIDIA H100.

The port of ``nomad_tpu`` (JAX on a TPU), kept beside it; it imports
nothing of JAX or of the JAX package. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``, and raise when CUDA is missing rather
than fall back to the CPU. Use ``nomad_tpu_torch.api.Nomad`` or
``python -m nomad_tpu_torch --mode dir --nmr ... --deg ...`` to score,
``nomad_tpu_torch.training.Training`` or
``python -m nomad_tpu_torch.main --config_file ...`` to train and evaluate,
``nomad_tpu_torch.parallel`` and ``scoring.make_large_scale_scorer`` for
data-parallel and large-scale work. As in the JAX package,
``from nomad_tpu_torch import nomad`` is a lazy ``Nomad()``.
"""

from . import io, models, ops

__version__ = "0.1.0"


def __getattr__(name):
    if name == "nomad":
        from .api import get_nomad

        return get_nomad()
    raise AttributeError(f"module 'nomad_tpu_torch' has no attribute {name!r}")


__all__ = ["api", "convert", "io", "main", "models", "nomad", "ops", "parallel", "scoring",
           "training", "utils"]
