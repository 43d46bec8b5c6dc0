"""Masked attention forward with LSE: plain PyTorch version and kernel K1.

Counterpart of ``nomad_tpu.ops.flash_attention``. ``mha_flash`` launches
the CUDA kernel (``csrc/flash_attention.cu``) on CUDA tensors and computes
the plain version on CPU tensors. Both take q/k/v as [B, T, H, D] and the
valid key count per batch row, and return O [B, T, H, D] and
LSE = m + log(l) [B, H, T] in f32. Every query row is defined and finite,
padded rows included; a row with no valid key gives O = 0, LSE = -1e30.
Forward only: on CUDA tensors that need a gradient it raises until the
backward kernels (TPU kernels K2, K3) are ported.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIM = 64  # the only head width the kernel takes

# Launches of the kernel since the count was last set to 0.
launches = 0


def flash_attention_ref(q, k, v, lengths):
    """What ``_flash_kernel`` computes, unfolded: scores of q/sqrt(D)
    against keys t < lengths[b] (the others set to -1e30, never added to),
    softmax in f32, O = P.V and LSE = m + log(l). Keys past the bound are
    zeroed before the product, so a NaN there cannot reach O."""
    b, t, h, d = q.shape
    lengths = lengths.to(device=q.device, dtype=torch.int64).clamp(0, t)
    valid = torch.arange(t, device=q.device)[None, :] < lengths[:, None]  # [B, T]
    qf = q.to(torch.float32) * (1.0 / d**0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.to(torch.float32))
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid[:, None, None, :], p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    vf = torch.where(valid[:, :, None, None], v.to(torch.float32), 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    has_key = lengths > 0
    inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))  # [B, H, T, 1]
    o = o * inv.permute(0, 2, 1, 3)
    lse = torch.where(
        has_key[:, None, None], (m + torch.log(l))[..., 0], torch.full_like(l[..., 0], NEG_INF)
    )
    return o.to(q.dtype), lse


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.nomad_flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i] + [ll] * 12 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _check_qkv(name, x, shape, device):
    if x.dtype != torch.float32:
        raise TypeError(f"flash kernel: {name} must be float32, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"flash kernel: {name} is on {x.device}, q on {device}")
    if tuple(x.shape) != shape:
        raise ValueError(f"flash kernel: {name} shape {tuple(x.shape)} != {shape}")
    if x.stride(3) != 1 or any(s % 4 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(
            f"flash kernel: {name} needs unit stride on the head axis, other "
            f"strides multiples of 4 and 16-byte alignment, got strides {x.stride()}"
        )


def _flash_kernel(q, k, v, lengths):
    b, t, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash kernel: head width {d} unsupported (only {HEAD_DIM})")
    if b > 65535 or h > 65535:
        raise ValueError(f"flash kernel: grid limits exceeded (B={b}, H={h})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_qkv(name, x, (b, t, h, d), q.device)
    if lengths.dtype != torch.int32 or lengths.shape != (b,) or lengths.device != q.device:
        raise ValueError(f"flash kernel: lengths must be int32 [{b}] on {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "flash kernel is forward-only: run under torch.inference_mode() "
            "(the backward kernels come with the loss slice)"
        )
    lengths = lengths.contiguous()
    o = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _lib()
    err = lib.nomad_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, t, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        1.0 / d**0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "flash attention kernel launch")
    global launches
    launches += 1
    return o, lse


def mha_flash(q, k, v, lengths):
    """Attention on [B, T, H, D] with lengths int32 [B] valid keys per
    batch row -> (O [B, T, H, D], LSE f32 [B, H, T]). K1 on CUDA tensors,
    the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel runs on CUDA tensors, got {q.device}")
    return _flash_kernel(q, k, v, lengths)
