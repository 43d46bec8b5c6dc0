"""What a precision island of ``Wav2Vec2Config`` means on the card and on
the CPU: products and convolutions at ``"highest"``, ``"high"`` or
``"default"``.

The JAX package sets a TPU matrix-unit precision per island
(``jax.default_matmul_precision``). The port maps each value once, here:

  * ``"highest"`` and ``"high"`` (f32; bf16 x 3 on the TPU, ~1e-5): f32
    FMA with TF32 off, on either device, for cuBLAS's products, the
    convolutions and K1: cuBLAS has no bf16 x 3, JAX's flash kernel never
    lowers HIGH (``nomad_tpu/ops/flash_attention.py:56``), and XLA's HIGH
    is f32 off the TPU. Inside the projection-fused kernel, "high" is the
    TPU kernel's own "high3", as in the JAX package
    (``nomad_tpu/ops/fused_attention.py:65-90``): three bf16 passes on
    hi/lo splits of the operands (``matmul_high3``; K4h on the card).
  * ``"default"`` (one bf16 pass: operands rounded to bf16, products
    exact, f32 accumulation, f32 out). A product (``matmul_bf16``: a
    linear layer's, and the plain and dropout attention's two einsums): on
    the card ``torch.mm``/``torch.bmm`` of bf16 operands with an f32
    output (``aten::mm.dtype``/``bmm.dtype``, cuBLAS), a linear layer's
    bias added in f32; the plain version, for CPU tensors, rounds the
    operands to bf16 (round to nearest even) and runs the f32 product. A
    convolution, on either device: the f32 convolution of the operands
    rounded to bf16. The product of two bf16 values is exact in f32, so
    this is the TPU's pass, f32 output included; cuDNN's convolution of
    bf16 tensors would round its output to bf16, and on the card it is
    slower than the f32 one at the positional conv's shape.

A product's route follows the tensor's device, as ``ops/layernorm.py``
chooses: the card's library route for a CUDA tensor, the plain version
for a CPU one. TF32 stays off in every mode (``api.set_exact_precision``).

Gradients through a "default" island follow JAX's transposes: JAX turns
a DEFAULT product into DEFAULT products and a DEFAULT convolution into
DEFAULT convolutions, so the backward rounds the operands of each of its
products, the cotangent included: dX = bf16(dY) . bf16(W) and dW =
bf16(dY)^T . bf16(X), f32 out; db = the f32 sum of dY (autograd's, of
the f32 bias add). A convolution's input and weight gradients are the
f32 convolutions of the rounded operands, as its forward is. Autograd
through ``round_bf16`` would round the gradients the backward products
hand back instead, so the product and the convolution are each a
``torch.autograd.Function`` with that backward written out, on the card
and in the plain version alike; each keeps the bf16 copies of its
operands for the backward.

A bf16 activation (the trainer's ``fast_bf16`` block stack) makes a
product bf16 in and out, as flax's ``nn.Dense(dtype=bfloat16)`` is
(``linear``, ``_LinearBF16IO``): the operands are bf16 (the f32 weight
rounded once), the product is summed in f32 and rounded to bf16, then the
bf16 bias is added in bf16, a second rounding, as XLA computes flax's
``dot_general`` and bias add on the CPU. The product of two bf16 values
is exact in f32, so every island's precision gives this product. Its
gradients are JAX's transposes: dX = bf16(dY . W) (bf16), dW = bf16(X^T .
dY) and db = bf16(sum dY), the f32 sums rounded once and returned to the
f32 parameters as those bf16 values (the transpose of flax's cast of the
parameters to bf16). XLA on the CPU sums db's bf16 cotangent in bf16, in
its own order; the port rounds the f32 sum once. On the card the products
are cuBLAS ``mm`` with a bf16 output (f32 accumulation, split-K reduced in
f32: ``api.set_exact_precision``); the plain version is the f32 product of
the exactly converted operands, rounded once.

A bf16 activation makes a convolution bf16 in and out too, as flax's
``nn.Conv(dtype=bfloat16)`` is (``conv1d``, ``_Conv1dBF16IO``, the
JAX package's ``dtype``): the f32 convolution of the upcast bf16
operands, rounded once, the bias added in bf16; its gradients are the
transposes of that, each rounded once to bf16. The JAX package computes
its convolutions outside any Pallas kernel; the port's are cuDNN's.

The projection-fused attention on a bf16 x computes another product
(``linear_raw_weights``, ``_LinearRawWeights``): the JAX package hands the
fused path the raw f32 parameters, so x is promoted to f32 and multiplied
with the f32 weight at the island's precision (the weight rounded to bf16
at "default" only), the f32 bias is added, and the result is rounded once
to bf16.
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


def split_bf16(a: torch.Tensor) -> tuple:
    """(hi, lo) of an f32 a as high3 splits an operand: hi = bf16(a), lo =
    bf16(a - hi), both returned as f32 tensors holding bf16 values."""
    hi = round_bf16(a)
    return hi, round_bf16(a - hi)


# K2-bf16 and K3-bf16 (csrc/flash_attention_bwd_bf16.cu) split dS and P
# scaled by this power of two: every f32 value below 2^112 in magnitude,
# subnormals included, then splits exactly
SPLIT3_SCALE = 2.0 ** 16


def split3_bf16(x: torch.Tensor) -> tuple:
    """(hi, mid, lo) of an f32 x as the backward kernels' register split
    (``csrc/hopper.cuh::split3_bf16``): hi = bf16(x), mid = bf16(x - hi),
    lo = bf16(x - hi - mid), each returned as an f32 tensor holding bf16
    values. Both differences are exact in f32, and hi + mid + lo == x
    exactly wherever x's last bit lies on bf16's grid, |x| >= 2^-110 or
    x = 0: 24 significant bits in three planes of 8. The kernels split x
    times SPLIT3_SCALE, which puts every f32 value there."""
    hi = round_bf16(x)
    r = x - hi
    mid = round_bf16(r)
    return hi, mid, round_bf16(r - mid)


def matmul_high3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of f32 tensors as the TPU kernel's ``_dot`` at "high3"
    (``nomad_tpu/ops/fused_attention.py:79-90``): three DEFAULT passes on
    the split operands, hi.hi + hi.lo + lo.hi in that order, each an f32
    product of bf16 values (exact products, f32 sums); lo.lo is dropped, so
    the result is ~1e-5 relative from the f32 product."""
    a_hi, a_lo = split_bf16(a)
    b_hi, b_lo = split_bf16(b)
    return torch.matmul(a_hi, b_hi) + torch.matmul(a_hi, b_lo) + torch.matmul(a_lo, b_hi)


def _device_route(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"precision ops run on CUDA or CPU tensors, got {x.device}")


def _matmul(a, b):
    """a [..., m, k] . b [..., k, n] of bf16 operands with the same leading
    dims, f32 accumulation and an f32 result: cuBLAS ``mm.dtype`` or
    ``bmm.dtype`` on the card, the f32 product of the (exactly converted)
    operands on the CPU."""
    if not _device_route(a):
        return torch.matmul(a.float(), b.float())
    if a.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    lead, (m, k), n = a.shape[:-2], a.shape[-2:], b.shape[-1]
    y = torch.bmm(a.reshape(-1, m, k), b.reshape(-1, k, n), out_dtype=torch.float32)
    return y.view(*lead, m, n)


class _MatmulBF16(torch.autograd.Function):
    """``a @ b`` in one bf16 pass (a [..., m, k], b [..., k, n], the same
    leading dims), differentiable as JAX transposes a DEFAULT product:
    da = bf16(g) . bf16(b)^T and db = bf16(a)^T . bf16(g), f32 out."""

    @staticmethod
    def forward(ctx, a, b):
        ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(ab if ctx.needs_input_grad[1] else None,
                              bb if ctx.needs_input_grad[0] else None)
        return _matmul(ab, bb)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ab, bb = ctx.saved_tensors
        gb = g.to(torch.bfloat16)
        da = _matmul(gb, bb.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        db = _matmul(ab.transpose(-1, -2), gb) if ctx.needs_input_grad[1] else None
        return da, db


def matmul_bf16(a, b):
    """``a @ b`` at precision "default": a [..., m, k], b [..., k, n] with
    the same leading dims, f32 out."""
    return _MatmulBF16.apply(a, b)


class _Conv1dBF16(torch.autograd.Function):
    """``F.conv1d`` of the bf16-rounded operands, f32 sums and output; its
    input and weight gradients the f32 convolutions of the rounded
    cotangent and operands."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, groups):
        xb, wb = x.to(torch.bfloat16), weight.to(torch.bfloat16)
        ctx.save_for_backward(xb if ctx.needs_input_grad[1] else None,
                              wb if ctx.needs_input_grad[0] else None)
        ctx.conv = (stride, padding, 1, groups)
        ctx.shapes = (x.shape, weight.shape)
        ctx.has_bias = bias is not None
        return F.conv1d(xb.float(), wb.float(), bias, stride, padding, 1, groups)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        xb, wb = ctx.saved_tensors
        dyq = round_bf16(dy)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv1d_input(ctx.shapes[0], wb.float(), dyq, *ctx.conv)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv1d_weight(xb.float(), ctx.shapes[1], dyq, *ctx.conv)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.sum(dim=(0, 2))
        return dx, dw, db, None, None, None


def _mm_bf16_out(a, b):
    """a [m, k] . b [k, n] of bf16 operands, f32 accumulation, rounded once
    to a bf16 result: cuBLAS ``mm`` with a bf16 output on the card, the f32
    product of the (exactly converted) operands rounded on the CPU."""
    if _device_route(a):
        return torch.mm(a, b)
    return torch.mm(a.float(), b.float()).to(torch.bfloat16)


class _LinearBF16IO(torch.autograd.Function):
    """flax ``nn.Dense(dtype=bfloat16)`` on a bf16 x [n, in] with f32
    weight [out, in] and bias [out] (or None): y = bf16(bf16(x . bf16(W)^T)
    + bf16(b)), bf16 [n, out]; the gradients as the module docstring
    gives them."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        wb = weight.to(torch.bfloat16)
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              wb if ctx.needs_input_grad[0] else None)
        ctx.has_bias = bias is not None
        y = _mm_bf16_out(x, wb.t())
        return y if bias is None else y + bias.to(torch.bfloat16)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, wb = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _mm_bf16_out(g, wb)
        if ctx.needs_input_grad[1]:
            dw = _mm_bf16_out(g.t(), x).float()
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.float().sum(dim=0).to(torch.bfloat16).float()
        return dx, dw, db


class _LinearRawWeights(torch.autograd.Function):
    """What the JAX package's projection-fused path computes on a bf16 x
    [n, in] with the raw f32 weight [out, in] and bias [out] (or None)
    (``_fused_kernel``'s projections, ``_out_proj``, ``_unfused_ref``):
    the f32 product of the upcast x with W, W rounded to bf16 only at
    "default", the f32 bias added, then one rounding to bf16. Its
    gradients are JAX's transposes of that promote-and-dot: with g the
    bf16 cotangent upcast, dX = bf16(g . W) and dW = g^T . X in f32, each
    product at the island's precision (at "default" of bf16 operands, f32
    sums), and db the f32 sum of g. On the card the products are cuBLAS:
    f32 ``mm`` with TF32 off, or at "default" ``mm`` of bf16 operands with
    an f32 output."""

    @staticmethod
    def forward(ctx, x, weight, bias, prec):
        bf16 = is_bf16(prec)
        w = weight.to(torch.bfloat16) if bf16 else weight
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              w if ctx.needs_input_grad[0] else None)
        ctx.bf16, ctx.has_bias = bf16, bias is not None
        y = _matmul(x, w.t()) if bf16 else torch.mm(x.float(), w.t())
        return (y if bias is None else y + bias).to(torch.bfloat16)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = db = None
        if ctx.bf16:
            g = g.to(torch.bfloat16)
            if ctx.needs_input_grad[0]:
                dx = _matmul(g, w).to(torch.bfloat16)
            if ctx.needs_input_grad[1]:
                dw = _matmul(g.t(), x)
        else:
            g = g.float()
            if ctx.needs_input_grad[0]:
                dx = torch.mm(g, w).to(torch.bfloat16)
            if ctx.needs_input_grad[1]:
                dw = torch.mm(g.t(), x.float())
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.float().sum(dim=0)
        return dx, dw, db, None


def linear_raw_weights(x, weight, bias, prec):
    """The projection-fused path's product on a bf16 x [..., in] with the
    f32 weight [out, in] and bias [out] (or None) at island ``prec``:
    bf16 [..., out] (``_LinearRawWeights``)."""
    y = _LinearRawWeights.apply(x.reshape(-1, x.shape[-1]), weight, bias, prec)
    return y.view(*x.shape[:-1], weight.shape[0])


def linear(x, weight, bias, prec):
    """``F.linear`` at island precision ``prec``: x [..., in], weight
    [out, in], bias [out] or None. A bf16 x gives a bf16 output at any
    island (``_LinearBF16IO``)."""
    if x.dtype == torch.bfloat16:
        y = _LinearBF16IO.apply(x.reshape(-1, x.shape[-1]), weight, bias)
        return y.view(*x.shape[:-1], weight.shape[0])
    if not is_bf16(prec):
        return F.linear(x, weight, bias)
    y = matmul_bf16(x.reshape(-1, x.shape[-1]), weight.t())
    y = y.view(*x.shape[:-1], weight.shape[0])
    return y if bias is None else y + bias


class _Conv1dBF16IO(torch.autograd.Function):
    """flax ``nn.Conv(dtype=bfloat16)`` on a bf16 x [B, C, T] with the f32
    weight and bias (or None): y = bf16(bf16(conv(x, bf16(W))) + bf16(b)),
    the convolution summed in f32 (cuDNN's f32 convolution of the upcast
    operands on the card, TF32 off) and rounded once. Its gradients are
    JAX's transposes: dX = bf16(conv^T(dY, bf16(W))), dW = bf16(conv_W(X,
    dY)) and db = bf16(sum dY), each summed in f32 and rounded once, and
    handed back to the f32 parameters as those bf16 values."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, groups):
        wf = weight.to(torch.bfloat16).float()
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              wf if ctx.needs_input_grad[0] else None)
        ctx.conv = (stride, padding, 1, groups)
        ctx.shapes = (x.shape, weight.shape)
        ctx.has_bias = bias is not None
        y = F.conv1d(x.float(), wf, None, stride, padding, 1, groups).to(torch.bfloat16)
        return y if bias is None else y + bias.to(torch.bfloat16)[:, None]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, wf = ctx.saved_tensors
        g = dy.to(torch.bfloat16).float()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv1d_input(ctx.shapes[0], wf, g, *ctx.conv).to(torch.bfloat16)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv1d_weight(x.float(), ctx.shapes[1], g, *ctx.conv)
            dw = round_bf16(dw)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = round_bf16(g.sum(dim=(0, 2)))
        return dx, dw, db, None, None, None


def conv1d(x, weight, bias, prec, stride=1, padding=0, groups=1):
    """``F.conv1d`` at island precision ``prec``: x [B, C, T]; stride,
    padding and groups as F.conv1d's. A bf16 x gives a bf16 output at any
    island (``_Conv1dBF16IO``: its operands are bf16 values, so one bf16
    pass, "high"'s three and "highest"'s f32 give the same sums)."""
    if x.dtype == torch.bfloat16:
        check(prec)
        return _Conv1dBF16IO.apply(x, weight, bias, stride, padding, groups)
    if not is_bf16(prec):
        return F.conv1d(x, weight, bias, stride=stride, padding=padding, groups=groups)
    return _Conv1dBF16.apply(x, weight, bias, stride, padding, groups)
