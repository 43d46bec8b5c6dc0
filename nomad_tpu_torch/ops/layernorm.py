"""LayerNorm over the last axis: plain PyTorch version and kernel K5.

Counterpart of ``nomad_tpu.ops.layernorm``. ``layer_norm`` is one
``torch.autograd.Function``: its forward launches the CUDA kernel
(``csrc/layernorm.cu``) on a CUDA tensor and computes the plain version on
a CPU tensor; its backward is ``layer_norm_bwd_ref``, plain PyTorch on
either device, as the JAX package hands its backward to XLA (``_ln_bwd``).
x is float32, or bfloat16 (the trainer's ``fast_bf16`` block stack: the
kernel's bf16-I/O flavour, f32 statistics, the output rounded once); the
scale and shift are float32 and the output takes x's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches of the kernel's f32 and bf16-I/O flavours since each count was
# last set to 0.
launches = 0
launches_bf16_io = 0


def layer_norm_ref(x, scale, bias, eps: float = 1e-5):
    """``layer_norm_xla``: f32 mean, biased variance as mean((x-mean)^2),
    rsqrt(var + eps), scale + shift, cast back to x's dtype."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def layer_norm_bwd_ref(x, scale, g, eps: float = 1e-5):
    """The vjp of ``layer_norm_ref`` (``layer_norm_xla``) for the cotangent
    g: (dx, dscale, dbias), with x_hat = (x - mean) * rstd,
    dx = rstd * (g*scale - mean(g*scale) - x_hat * mean(g*scale*x_hat))."""
    d = x.shape[-1]
    xf = x.to(torch.float32)
    gf = g.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    gs = gf * scale
    dx = rstd * (gs - gs.mean(dim=-1, keepdim=True)
                 - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
    dscale = (gf * xhat).reshape(-1, d).sum(dim=0)
    dbias = gf.reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype)


def _lib():
    lib = _build.load("layernorm")
    fn = lib.nomad_layernorm_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def _layer_norm_kernel(x, scale, bias, eps):
    d = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layer_norm kernel: x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"layer_norm kernel: {name} must be float32, got {t.dtype}")
    for name, t in (("x", x), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"layer_norm kernel: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"layer_norm kernel: {name} must be contiguous and 16-byte aligned")
    if scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"layer_norm kernel: scale/bias must be [{d}]")
    if d % 4 or d > 1024:
        raise ValueError(f"layer_norm kernel: width {d} must be a multiple of 4, <= 1024")
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    bf16_io = x.dtype == torch.bfloat16
    lib = _lib()
    err = lib.nomad_layernorm_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        rows, d, float(eps), int(bf16_io), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "layernorm kernel launch")
    global launches, launches_bf16_io
    if bf16_io:
        launches_bf16_io += 1
    else:
        launches += 1
    return y


class LayerNormFn(torch.autograd.Function):
    """Forward: K5 on a CUDA tensor, the plain version on a CPU tensor.
    Backward: ``layer_norm_bwd_ref``."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        if x.device.type == "cpu":
            y = layer_norm_ref(x, scale, bias, eps)
        elif x.device.type == "cuda":
            y = _layer_norm_kernel(x, scale, bias, eps)
        else:
            raise ValueError(f"layer_norm kernel runs on CUDA tensors, got {x.device}")
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd_ref(x, scale, g, ctx.eps)
        return dx, dscale, dbias, None


def layer_norm(x, scale, bias, eps: float = 1e-5, impl: str = "kernel"):
    """Differentiable LayerNorm over the last axis. impl: 'kernel'
    (``LayerNormFn``: K5 forward on a CUDA tensor, the plain version on a
    CPU tensor) | 'ref' (the plain version under plain autograd)."""
    if impl == "ref":
        return layer_norm_ref(x, scale, bias, eps)
    if impl != "kernel":
        raise ValueError(f"unknown layernorm impl {impl!r}: expected 'kernel' or 'ref'")
    return LayerNormFn.apply(x, scale, bias, eps)
