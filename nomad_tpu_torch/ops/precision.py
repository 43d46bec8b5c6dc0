"""What a precision island of ``Wav2Vec2Config`` means on the card and on
the CPU: products and convolutions at ``"highest"``, ``"high"`` or
``"default"``.

The JAX package sets a TPU matrix-unit precision per island
(``jax.default_matmul_precision``). The port maps each value once, here:

  * ``"highest"`` and ``"high"`` (f32; bf16 x 3 on the TPU, ~1e-5): f32
    FMA with TF32 off, on either device. The card has no cheap counterpart
    of bf16 x 3, so "high" is f32, bit for bit today's "exact".
  * ``"default"`` (one bf16 pass: operands rounded to bf16, products
    exact, f32 accumulation, f32 out). A product: on the card ``torch.mm``
    of bf16 operands with an f32 output (``aten::mm.dtype``, cuBLAS) plus
    the bias in f32; the plain version, for CPU tensors, rounds the
    operands to bf16 (round to nearest even) and runs the f32 product. A
    convolution, on either device: the f32 convolution of the operands
    rounded to bf16. The product of two bf16 values is exact in f32, so
    this is the TPU's pass, f32 output included; cuDNN's convolution of
    bf16 tensors would round its output to bf16, and on the card it is
    slower than the f32 one at the positional conv's shape.

A product's route follows the tensor's device, as ``ops/layernorm.py``
chooses: the card's library route for a CUDA tensor, the plain version
for a CPU one. TF32 stays off in every mode (``api.set_exact_precision``). A bf16
island is forward-only: a call that would need its gradient raises
(training in a mode is ROADMAP Queue 2 work).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PRECISIONS = ("default", "high", "highest")


def check(prec, name: str = "precision", allow_none: bool = False) -> None:
    """Raise ValueError unless prec is one of PRECISIONS (or None)."""
    if prec is None and allow_none:
        return
    if prec not in PRECISIONS:
        allowed = PRECISIONS + ((None,) if allow_none else ())
        raise ValueError(f"{name} must be one of {allowed}, got {prec!r}")


def is_bf16(prec) -> bool:
    """True for the single-pass bf16 island ("default")."""
    check(prec)
    return prec == "default"


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bf16 (ties to even), in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _refuse_gradient(what: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} at precision 'default' (bf16) is forward-only: its gradient, "
            "training in a precision mode, is not ported yet (ROADMAP Queue 2, "
            "'the DEFAULT flavours of K2/K3'); use precision 'exact'"
        )


def _device_route(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"precision ops run on CUDA or CPU tensors, got {x.device}")


def linear(x, weight, bias, prec):
    """``F.linear`` at island precision ``prec``: x [..., in], weight
    [out, in], bias [out] or None."""
    if not is_bf16(prec):
        return F.linear(x, weight, bias)
    _refuse_gradient("a product", x, weight, bias)
    if not _device_route(x):
        return F.linear(round_bf16(x), round_bf16(weight), bias)
    y = torch.mm(x.reshape(-1, x.shape[-1]).to(torch.bfloat16), weight.to(torch.bfloat16).t(),
                 out_dtype=torch.float32)
    if bias is not None:
        y.add_(bias)
    return y.view(*x.shape[:-1], weight.shape[0])


def conv1d(x, weight, bias, prec, **conv_kw):
    """``F.conv1d`` at island precision ``prec``: x [B, C, T]; conv_kw are
    F.conv1d's stride, padding, groups."""
    if not is_bf16(prec):
        return F.conv1d(x, weight, bias, **conv_kw)
    _refuse_gradient("a convolution", x, weight, bias)
    return F.conv1d(round_bf16(x), round_bf16(weight), bias, **conv_kw)
