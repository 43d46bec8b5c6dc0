"""Masked attention with LSE: kernels K1 (forward), K2 (dQ) and K3 (dK, dV)
beside their plain PyTorch versions.

Counterpart of ``nomad_tpu.ops.flash_attention``. ``mha_flash`` launches
K1 (``csrc/flash_attention.cu``) on CUDA tensors and computes the plain
version on CPU tensors. Both take q/k/v as [B, T, H, D] and the valid key
count per batch row, and return O [B, T, H, D] and LSE = m + log(l)
[B, H, T] in f32. Every query row is defined and finite, padded rows
included; a row with no valid key gives O = 0, LSE = -1e30.

``flash_attention_bwd`` is the backward: K2 and K3
(``csrc/flash_attention_bwd.cu``) on CUDA tensors, ``flash_attention_bwd_ref``
on CPU tensors. ``FlashAttention`` is the differentiable form, one
``torch.autograd.Function`` over both.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIM = 64  # the only head width the kernel takes

# K1's tiles (csrc/attention_tile.cuh): 64 query rows per block of 128
# threads, 32-key K/V tiles double-buffered, rows padded to 68 floats.
BLOCK_Q, BLOCK_K, THREADS = 64, 32, 128
_LD, _LD_P = HEAD_DIM + 4, BLOCK_K + 8
KEY_TILES_BYTES = 4 * (2 * 2 * BLOCK_K * _LD + BLOCK_Q * _LD_P)
FLASH_SMEM_BYTES = 4 * BLOCK_Q * _LD + KEY_TILES_BYTES

# K2's and K3's tiles (csrc/attention_bwd_tile.cuh): a block of 128 threads
# holds 64 rows (32 when T <= BWD_SMALL_T, which fills the card at the loss
# crop) of two operands, unpadded, and streams 32-row tiles of the other
# two, double-buffered; P and dS pass through per-warp slices of 36-float
# rows (K2: one for dS; K3: one for P, then dS). Blocks per SM: what the
# kernels are compiled for (__launch_bounds__).
BWD_SMALL_T, BWD_SMALL_ROWS, BWD_STAGES, BWD_BLOCKS_PER_SM = 64, 32, 2, 3
_LD_S = BLOCK_K + 4

# Launches of K1, K2 and K3 since each count was last set to 0.
launches = 0
launches_bwd_dq = 0
launches_bwd_dkv = 0


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


def flash_attention_bwd_ref(q, k, v, o, lse, do, lengths):
    """What ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` compute
    together, unfolded: Di = rowsum(dO*O), P = exp(s - LSE) over keys
    t < lengths[b] (0 elsewhere) with s = q.k/sqrt(D), dP = dO.V^T,
    dS = P*(dP - Di); dQ = dS.K/sqrt(D), dK = dS^T.Q/sqrt(D), dV = P^T.dO.
    Keys past the bound are zeroed before the products and get dK = dV = 0;
    a row with no valid key gets zero gradients."""
    b, t, h, d = q.shape
    lengths = lengths.to(device=q.device, dtype=torch.int64).clamp(0, t)
    valid = torch.arange(t, device=q.device)[None, :] < lengths[:, None]  # [B, T]
    vk = valid[:, :, None, None]
    scale = 1.0 / d**0.5
    qf = q.to(torch.float32) * scale
    kf = torch.where(vk, k.to(torch.float32), 0.0)
    vf = torch.where(vk, v.to(torch.float32), 0.0)
    dof = do.to(torch.float32)
    di = (dof * o.to(torch.float32)).sum(dim=-1).transpose(1, 2)  # [B, H, T]
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    p = torch.exp(torch.where(valid[:, None, None, :], s - lse[..., None], NEG_INF))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - di[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.where(vk, torch.einsum("bhqk,bqhd->bkhd", ds, qf), 0.0)
    dv = torch.where(vk, torch.einsum("bhqk,bqhd->bkhd", p, dof), 0.0)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_launch_plan(t: int, b: int, h: int) -> dict:
    """K1's grid (one block per 64-query tile, head and batch row) and its
    dynamic shared memory, which the C launcher checks against its own."""
    return {"grid": (-(-t // BLOCK_Q), h, b), "threads": THREADS,
            "rows_per_block": BLOCK_Q, "smem_bytes": FLASH_SMEM_BYTES}


def flash_bwd_launch_plan(t: int, b: int, h: int) -> dict:
    """K2's and K3's launches ({"dq": ..., "dkv": ...}): each kernel's grid
    (one block per tile of ``rows_per_block`` query rows for K2, key rows
    for K3, per head and batch row), threads, dynamic shared memory and the
    blocks per SM it is built for. The C launchers check rows and shared
    memory against their own rule."""
    rows = BWD_SMALL_ROWS if t <= BWD_SMALL_T else 64
    # resident rows (K2: Q and dO; K3: K and V), the K/V (K2) or Q/dO (K3)
    # tiles in flight, the slices: the same for both kernels
    smem = 4 * (2 * rows * HEAD_DIM + BWD_STAGES * 2 * BLOCK_K * _LD + rows * _LD_S)
    return {kernel: {"grid": (-(-t // rows), h, b), "threads": THREADS, "rows_per_block": rows,
                     "smem_bytes": smem, "blocks_per_sm": BWD_BLOCKS_PER_SM}
            for kernel in ("dq", "dkv")}


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.nomad_flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i] + [ll] * 12 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        occ = lib.nomad_flash_attention_fwd_occupancy
        occ.argtypes, occ.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    return lib


def flash_occupancy() -> int:
    """Blocks of K1 resident on one SM at its shared memory (the card)."""
    lib = _lib()
    blocks = ctypes.c_int(0)
    _build.check(lib, lib.nomad_flash_attention_fwd_occupancy(ctypes.byref(blocks)),
                 "flash attention occupancy")
    return blocks.value


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


def _check_inputs(q, k, v, lengths):
    b, t, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash kernel: head width {d} unsupported (only {HEAD_DIM})")
    if b > 65535 or h > 65535:
        raise ValueError(f"flash kernel: grid limits exceeded (B={b}, H={h})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_qkv(name, x, (b, t, h, d), q.device)
    if lengths.dtype != torch.int32 or lengths.shape != (b,) or lengths.device != q.device:
        raise ValueError(f"flash kernel: lengths must be int32 [{b}] on {q.device}")


def _flash_kernel(q, k, v, lengths):
    b, t, h, d = q.shape
    _check_inputs(q, k, v, lengths)
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
        1.0 / d**0.5, flash_launch_plan(t, b, h)["smem_bytes"],
        torch.cuda.current_stream(q.device).cuda_stream,
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


def _lib_bwd():
    lib = _build.load("flash_attention_bwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn, outs in ((lib.nomad_flash_attention_bwd_dq, 1), (lib.nomad_flash_attention_bwd_dkv, 2)):
        if fn.argtypes is None:
            fn.argtypes = [p] * (7 + outs) + [i] * 4 + [ll] * 12 + [ctypes.c_float, i, i, p]
            fn.restype = ctypes.c_int
    occ = lib.nomad_flash_attention_bwd_occupancy
    if occ.argtypes is None:
        occ.argtypes, occ.restype = [i, i, ctypes.POINTER(i)], ctypes.c_int
    return lib


def flash_bwd_occupancy(kernel: str, rows_per_block: int) -> int:
    """Blocks of K2 (``kernel="dq"``) or K3 (``"dkv"``) resident on one SM
    for a plan of ``rows_per_block`` rows, at its shared memory (the card)."""
    lib = _lib_bwd()
    blocks = ctypes.c_int(0)
    _build.check(lib, lib.nomad_flash_attention_bwd_occupancy(
        int(kernel == "dkv"), rows_per_block, ctypes.byref(blocks)), "flash backward occupancy")
    return blocks.value


def _bwd_args(q, k, v, o, lse, do, lengths):
    """Checks shared by K2 and K3; returns their inputs in launch form:
    dO as given when its strides suit the kernels (else a contiguous copy),
    Di = rowsum(dO*O) [B, H, T] from one PyTorch reduction, lengths
    contiguous."""
    b, t, h, d = q.shape
    _check_inputs(q, k, v, lengths)
    _check_qkv("o", o, (b, t, h, d), q.device)
    if do.dtype != torch.float32 or tuple(do.shape) != (b, t, h, d) or do.device != q.device:
        raise ValueError(f"flash kernel: dO must be float32 [{b}, {t}, {h}, {d}] on {q.device}")
    if do.stride(3) != 1 or any(s % 4 for s in do.stride()[:3]) or do.data_ptr() % 16:
        do = do.contiguous()
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, t) or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash kernel: lse must be contiguous float32 [{b}, {h}, {t}]")
    di = (do * o).sum(dim=-1).transpose(1, 2).contiguous()
    return do, di, lengths.contiguous()


def _launch_bwd(kernel, q, k, v, do, lse, di, lengths, outs, what):
    b, t, h, d = q.shape
    plan = flash_bwd_launch_plan(t, b, h)[kernel]
    lib = _lib_bwd()
    err = getattr(lib, f"nomad_flash_attention_bwd_{kernel}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), lengths.data_ptr(), *(x.data_ptr() for x in outs), b, t, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        1.0 / d**0.5, plan["rows_per_block"], plan["smem_bytes"],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, what)


def _bwd_dq_kernel(q, k, v, do, lse, di, lengths):
    """K2 on arguments prepared by ``_bwd_args``: dQ [B, T, H, D]."""
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq
    _launch_bwd("dq", q, k, v, do, lse, di, lengths, (dq,),
                "flash attention dQ kernel launch")
    global launches_bwd_dq
    launches_bwd_dq += 1
    return dq


def _bwd_dkv_kernel(q, k, v, do, lse, di, lengths):
    """K3 on arguments prepared by ``_bwd_args``: (dK, dV) [B, T, H, D]."""
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return dk, dv
    _launch_bwd("dkv", q, k, v, do, lse, di, lengths, (dk, dv),
                "flash attention dK/dV kernel launch")
    global launches_bwd_dkv
    launches_bwd_dkv += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, lengths):
    """Gradients (dQ, dK, dV) of ``mha_flash``'s O for the cotangent dO,
    from the saved O and LSE. K2 and K3 on CUDA tensors, the plain version
    on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel runs on CUDA tensors, got {q.device}")
    do, di, lengths = _bwd_args(q, k, v, o, lse, do, lengths)
    dq = _bwd_dq_kernel(q, k, v, do, lse, di, lengths)
    dk, dv = _bwd_dkv_kernel(q, k, v, do, lse, di, lengths)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, lengths)`` -> O [B, T, H, D], masked
    attention differentiable in q, k, v (lengths int32 [B] gets no
    gradient): ``mha_flash`` forward (K1 on the card), ``flash_attention_bwd``
    backward (K2 + K3 on the card); the plain versions of both on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, lengths):
        o, lse = mha_flash(q, k, v, lengths)
        ctx.save_for_backward(q, k, v, o, lse, lengths)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse, lengths = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, lengths)
        return dq, dk, dv, None
