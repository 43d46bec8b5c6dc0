"""Projection-fused attention: kernel K4 beside its plain PyTorch version.

Counterpart of ``nomad_tpu.ops.fused_attention``. ``fused_qkv_mha``
launches K4 (``csrc/fused_attention.cu``) on CUDA tensors and computes the
plain version on CPU tensors: the q/k/v projections of every head and
masked softmax attention in one call, from the hidden states
x [B, T, D_model] and the projections' weights in ``nn.Linear``'s
[out, in] layout, returning O head-major [B, H, T, hd]. Every query row
is defined and finite, padded rows included; a row with no valid key
gives O = 0.

``FusedQKVAttention`` is the differentiable form. Its backward is the vjp
of the unfused composition, as the JAX package's is (``_fused_bwd``): the
projections are recomputed as products and the attention goes through
``flash_attention.FlashAttention`` (K1 forward, K2 + K3 backward on the
card). ``fused_qkv_attention`` is the whole sublayer, out-projection
included; beyond ``MAX_FUSED_T`` frames it takes the unfused composition
with K1, the JAX package's own shape rule.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .attention import mha
from .flash_attention import HEAD_DIM, NEG_INF, FlashAttention

# The JAX kernel's single pass over the padded sequence had to fit VMEM, so
# it takes round_up(T, 128) <= 1024 frames (~21 s of audio); K4 needs no
# padding to 128 and takes T <= 1024, the same set of lengths.
MAX_FUSED_T = 1024

# Launches of K4 since the count was last set to 0.
launches = 0


def fused_supported(t: int) -> bool:
    return t <= MAX_FUSED_T


def _qkv(x, wq, bq, wk, bk, wv, bv, heads):
    """The three projections as [B, T, H, hd] views of [B, T, D] products."""
    b, t, dm = x.shape
    return tuple(F.linear(x, w, bias).view(b, t, heads, dm // heads)
                 for w, bias in ((wq, bq), (wk, bk), (wv, bv)))


def fused_qkv_attention_ref(x, wq, bq, wk, bk, wv, bv, lengths, heads):
    """What ``_fused_kernel`` computes, unfolded: Q = (x.Wq^T + bq)/sqrt(hd),
    K and V likewise; scores against keys t < lengths[b] (the others set to
    -1e30, never added to), softmax in f32, O = P.V, returned head-major
    [B, H, T, hd]. Values past the bound are zeroed before the product, so
    a NaN there cannot reach O."""
    b, t, dm = x.shape
    hd = dm // heads
    q, k, v = (y.to(torch.float32).transpose(1, 2)
               for y in _qkv(x, wq, bq, wk, bk, wv, bv, heads))  # [B, H, T, hd]
    lengths = lengths.to(device=x.device, dtype=torch.int64).clamp(0, t)
    valid = torch.arange(t, device=x.device)[None, :] < lengths[:, None]  # [B, T]
    s = torch.matmul(q * (1.0 / hd**0.5), k.transpose(-1, -2))
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid[:, None, None, :], p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, torch.where(valid[:, None, :, None], v, 0.0))
    o = o * torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    return o.to(x.dtype)


def _lib():
    lib = _build.load("fused_attention")
    fn = lib.nomad_fused_qkv_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 10 + [i] * 4 + [ll] * 3 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _check_inputs(x, params, lengths, heads):
    if x.ndim != 3:
        raise ValueError(f"fused kernel: x must be [B, T, D], got shape {tuple(x.shape)}")
    b, t, dm = x.shape
    if heads <= 0 or dm % heads or dm // heads != HEAD_DIM:
        raise ValueError(
            f"fused kernel: head width {dm}/{heads} unsupported (only {HEAD_DIM})")
    if not fused_supported(t):
        raise ValueError(f"fused kernel: T = {t} frames > {MAX_FUSED_T}")
    if b > 65535:
        raise ValueError(f"fused kernel: grid limits exceeded (B={b})")
    for name, a in (("x", x), *params.items()):
        if a.dtype != torch.float32:
            raise TypeError(f"fused kernel: {name} must be float32, got {a.dtype}")
        if a.device != x.device:
            raise ValueError(f"fused kernel: {name} is on {a.device}, x on {x.device}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"fused kernel: {name} must be contiguous and 16-byte aligned")
        want = (b, t, dm) if name == "x" else (dm, dm) if name[0] == "w" else (dm,)
        if tuple(a.shape) != want:
            raise ValueError(f"fused kernel: {name} shape {tuple(a.shape)} != {want}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,) or lengths.device != x.device:
        raise ValueError(f"fused kernel: lengths must be int32 [{b}] on {x.device}")


def _fused_kernel(x, wq, bq, wk, bk, wv, bv, lengths, heads):
    params = {"wq": wq, "bq": bq, "wk": wk, "bk": bk, "wv": wv, "bv": bv}
    _check_inputs(x, params, lengths, heads)
    b, t, dm = x.shape
    # O is written [B, T, H, hd] and handed out head-major as a view: the
    # out-projection then reads it as [B, T, D] with no copy
    o = torch.empty((b, t, heads, HEAD_DIM), dtype=torch.float32, device=x.device)
    if o.numel() == 0:
        return o.transpose(1, 2)
    ws = torch.empty((3, b, heads, t, HEAD_DIM), dtype=torch.float32, device=x.device)
    lengths = lengths.contiguous()
    lib = _lib()
    err = lib.nomad_fused_qkv_attention_fwd(
        x.data_ptr(), *(a.data_ptr() for a in params.values()), lengths.data_ptr(),
        ws.data_ptr(), o.data_ptr(), b, t, heads, dm, *o.stride()[:3],
        1.0 / HEAD_DIM**0.5, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "fused attention kernel launch")
    global launches
    launches += 1
    return o.transpose(1, 2)


def fused_qkv_mha(x, wq, bq, wk, bk, wv, bv, lengths, heads):
    """Projections + attention of x [B, T, D] with lengths int32 [B] valid
    keys per batch row -> O head-major [B, H, T, hd]. K4 on CUDA tensors,
    the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_qkv_attention_ref(x, wq, bq, wk, bk, wv, bv, lengths, heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused kernel runs on CUDA tensors, got {x.device}")
    return _fused_kernel(x, wq, bq, wk, bk, wv, bv, lengths, heads)


class FusedQKVAttention(torch.autograd.Function):
    """``FusedQKVAttention.apply(x, wq, bq, wk, bk, wv, bv, lengths, heads)``
    -> O head-major [B, H, T, hd], differentiable in x and the projections
    (lengths and heads get no gradient): ``fused_qkv_mha`` forward (K4 on
    the card), the vjp of the unfused composition backward (products and
    ``FlashAttention``: K1 + K2 + K3 on the card)."""

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, lengths, heads):
        ctx.save_for_backward(x, wq, bq, wk, bk, wv, bv, lengths)
        ctx.heads = heads
        return fused_qkv_mha(x, wq, bq, wk, bk, wv, bv, lengths, heads)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        *saved, lengths = ctx.saved_tensors
        needs = ctx.needs_input_grad[:7]
        inputs = [a.detach().requires_grad_(n) for a, n in zip(saved, needs)]
        with torch.enable_grad():
            q, k, v = _qkv(*inputs, ctx.heads)
            o = FlashAttention.apply(q, k, v, lengths).transpose(1, 2)
            grads = iter(torch.autograd.grad(o, [a for a, n in zip(inputs, needs) if n], do))
        return (*(next(grads) if n else None for n in needs), None, None)


def fused_qkv_attention(x, wq, bq, wk, bk, wv, bv, wo, bo, key_mask=None, heads: int = 12):
    """The attention sublayer on hidden states x [B, T, D]: q/k/v
    projections and masked softmax attention in K4 (``FusedQKVAttention``),
    then the out-projection as one product of the head-major output.
    key_mask: optional bool [B, T] prefix mask, True = valid key. Weights
    in ``nn.Linear``'s [out, in] layout. Returns [B, T, D].

    Beyond ``MAX_FUSED_T`` frames it computes the unfused composition,
    attention through ``mha(impl="kernel")`` (K1 on the card), as the JAX
    package falls back to its unfused path."""
    b, t, dm = x.shape
    if not fused_supported(t):
        q, k, v = _qkv(x, wq, bq, wk, bk, wv, bv, heads)
        attn = mha(q, k, v, key_mask=key_mask, impl="kernel")
        return F.linear(attn.reshape(b, t, dm), wo, bo)
    if key_mask is None:
        lengths = torch.full((b,), t, dtype=torch.int32, device=x.device)
    else:
        lengths = key_mask.sum(dim=-1, dtype=torch.int32)
    o = FusedQKVAttention.apply(x, wq, bq, wk, bk, wv, bv, lengths, heads)
    return F.linear(o.transpose(1, 2).reshape(b, t, dm), wo, bo)
