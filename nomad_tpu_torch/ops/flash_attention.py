"""Masked attention with LSE: kernels K1 and K1b (forward), K2 (dQ) and K3
(dK, dV) beside their plain PyTorch versions.

Counterpart of ``nomad_tpu.ops.flash_attention``. ``mha_flash`` launches
K1 (``csrc/flash_attention.cu``, f32: the "highest" and "high" flavours)
or K1b (``csrc/flash_attention_bf16.cu``, the TPU kernel's own "default"
flavour: bf16 products, f32 accumulation and softmax; its prologue folds
k and v to bf16 once per call, ``fold_bf16_ref``) on CUDA tensors and
computes the plain version of the same flavour on CPU tensors. Both take
q/k/v as [B, T, H, D] and the valid key count per batch row, and return O
[B, T, H, D] and LSE = m + log(l) [B, H, T] in f32. Every query row is
defined and finite, padded rows included; a row with no valid key gives
O = 0, LSE = -1e30.

``flash_attention_bwd`` is the backward: K2 and K3
(``csrc/flash_attention_bwd.cu``, f32) or K2b and K3b
(``csrc/flash_attention_bwd_bf16.cu``, the TPU kernels' own "default"
flavour: bf16 products, f32 accumulation, exp and masks; their prologue
folds q, k, v and dO to bf16 once per call, ``fold_bf16_ref``) on CUDA
tensors, ``flash_attention_bwd_ref`` of the same flavour on CPU tensors.
``FlashAttention`` is the differentiable form, one
``torch.autograd.Function`` over both.

Every kernel also takes bf16 tensors (bf16 activations in the block
stack, where the TPU kernels read bf16 blocks through ``astype(float32)``
and store in the inputs' dtype): the bf16-I/O flavours of K1b, K2b and K3b
(the trainer's ``fast_bf16``) and of K1, K2 and K3 (bf16 activations at a
"highest" or "high" attention island), built from the same templates,
return O, dQ, dK and dV in bf16, each the f32-I/O flavour's output on the
upcast inputs rounded once; LSE and Di stay f32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .precision import is_bf16, round_bf16

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

# K2b's and K3b's blocks (csrc/flash_attention_bwd_bf16.cu): a consumer
# warpgroup and a producer warp (160 threads) own 64 rows; their two
# resident 64-row bf16 tiles and a ring of BWD_BF16_STAGES stages of two
# streamed tiles (K3b's with 64 LSE and Di values) in dynamic shared
# memory, aligned by hand to 1,024 bytes. Blocks per SM: what the kernels
# are compiled for (K3b holds four accumulators, K2b three). Their
# prologue folds q, k, v and dO to bf16 [B*H, T64, 64] (T64: T rounded up
# to BWD_BF16_ROWS) and LSE and Di to f32 [B*H, T64].
BWD_BF16_ROWS, BWD_BF16_THREADS, BWD_BF16_STAGES = 64, 160, 3
BWD_BF16_BLOCKS_PER_SM = {"dq": 3, "dkv": 2}
BWD_BF16_SMEM_BYTES = (2 + 2 * BWD_BF16_STAGES) * BWD_BF16_ROWS * HEAD_DIM * 2 \
    + 2 * BWD_BF16_STAGES * BWD_BF16_ROWS * 4 + (2 * BWD_BF16_STAGES + 1) * 8 + 1024

# K1b's block (csrc/flash_attention_bf16.cu): a consumer warpgroup and a
# producer warp (160 threads) own 64 query rows; their Q tile and a ring of
# FWD_BF16_STAGES (K, V) tile pairs, all bf16 64 x 64, in dynamic shared
# memory with the ring's barriers, aligned by hand to 1,024 bytes. Blocks
# per SM: what the kernel is built for. Its prologue folds k and v to bf16
# [2, B*H, T64, 64] (T64: T rounded up to FWD_BF16_ROWS).
FWD_BF16_ROWS, FWD_BF16_THREADS, FWD_BF16_STAGES, FWD_BF16_BLOCKS_PER_SM = 64, 160, 4, 3
FWD_BF16_SMEM_BYTES = (1 + 2 * FWD_BF16_STAGES) * FWD_BF16_ROWS * HEAD_DIM * 2 \
    + 2 * FWD_BF16_STAGES * 8 + 1024

# Launches of K1, K1b and its prologue (the forward fold), K2, K3, K2b, K3b
# and K2b/K3b's prologue (the backward fold), of the bf16-I/O flavours of
# K1b, K2b, K3b and the folds (``*_bf16_io``) and of K1, K2 and K3
# (``*_f32_bf16_io``), since each count was last set to 0.
launches = 0
launches_fwd_fold_bf16 = 0
launches_fwd_fold_bf16_io = 0
launches_bwd_fold_bf16 = 0
launches_bwd_fold_bf16_io = 0
launches_bf16 = 0
launches_bwd_dq = 0
launches_bwd_dkv = 0
launches_bwd_dq_bf16 = 0
launches_bwd_dkv_bf16 = 0
launches_bf16_io = 0
launches_bwd_dq_bf16_io = 0
launches_bwd_dkv_bf16_io = 0
launches_f32_bf16_io = 0
launches_bwd_dq_f32_bf16_io = 0
launches_bwd_dkv_f32_bf16_io = 0


def flash_attention_ref(q, k, v, lengths, precision="highest"):
    """What ``_flash_kernel`` computes, unfolded: scores of q/sqrt(D)
    against keys t < lengths[b] (the others set to -1e30, never added to),
    softmax in f32, O = P.V / l and LSE = m + log(l). Keys past the bound
    are zeroed before the product, so a NaN there cannot reach O.

    ``precision`` "highest" or "high": f32 products. "default", the TPU
    kernel's single pass (``nomad_tpu/ops/flash_attention.py:63-77``):
    s = bf16(q/sqrt(D)) . bf16(k) in f32 (the scale 1/8 is exact),
    p = exp(s - m) in f32, l the sum of the unrounded p, and
    O = bf16(p) . bf16(v) / l."""
    rnd = round_bf16 if is_bf16(precision) else (lambda x: x)
    b, t, h, d = q.shape
    lengths = lengths.to(device=q.device, dtype=torch.int64).clamp(0, t)
    valid = torch.arange(t, device=q.device)[None, :] < lengths[:, None]  # [B, T]
    qf = rnd(q.to(torch.float32) * (1.0 / d**0.5))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, rnd(k.to(torch.float32)))
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid[:, None, None, :], p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    vf = torch.where(valid[:, :, None, None], v.to(torch.float32), 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", rnd(p), rnd(vf))
    has_key = lengths > 0
    inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))  # [B, H, T, 1]
    o = o * inv.permute(0, 2, 1, 3)
    lse = torch.where(
        has_key[:, None, None], (m + torch.log(l))[..., 0], torch.full_like(l[..., 0], NEG_INF)
    )
    return o.to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, o, lse, do, lengths, precision="highest"):
    """What ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` compute
    together, unfolded: Di = rowsum(dO*O), P = exp(s - LSE) over keys
    t < lengths[b] (0 elsewhere) with s = q.k/sqrt(D), dP = dO.V^T,
    dS = P*(dP - Di); dQ = dS.K/sqrt(D), dK = dS^T.Q/sqrt(D), dV = P^T.dO.
    Keys past the bound are zeroed before the products and get dK = dV = 0;
    a row with no valid key gets zero gradients.

    ``precision`` "highest" or "high": f32 products. "default", the TPU
    kernels' single pass (``nomad_tpu/ops/flash_attention.py:200-219``,
    ``:239-264``): every product takes operands rounded to bf16 (P and dS
    included) and sums in f32, s = (bf16(q) . bf16(k)) / sqrt(D) (the scale
    1/8 is exact), exp, the mask, Di and LSE stay f32."""
    b, t, h, d = q.shape
    lengths = lengths.to(device=q.device, dtype=torch.int64).clamp(0, t)
    valid = torch.arange(t, device=q.device)[None, :] < lengths[:, None]  # [B, T]
    vk = valid[:, :, None, None]
    scale = 1.0 / d**0.5
    kf = torch.where(vk, k.to(torch.float32), 0.0)
    vf = torch.where(vk, v.to(torch.float32), 0.0)
    dof = do.to(torch.float32)
    di = (dof * o.to(torch.float32)).sum(dim=-1).transpose(1, 2)  # [B, H, T]
    bf16 = is_bf16(precision)
    if bf16:  # q unscaled: the kernels scale the product
        qf, kf, vf, dof = (round_bf16(x) for x in (q.to(torch.float32), kf, vf, dof))
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    else:
        qf = q.to(torch.float32) * scale
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    p = torch.exp(torch.where(valid[:, None, None, :], s - lse[..., None], NEG_INF))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - di[..., None])
    if bf16:
        ds, p = round_bf16(ds), round_bf16(p)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dk = torch.where(vk, dk * scale if bf16 else dk, 0.0)
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


def flash_bwd_bf16_launch_plan(t: int, b: int, h: int) -> dict:
    """K2b's and K3b's launches ({"dq": ..., "dkv": ...}): one block of 160
    threads per 64-row tile (K2b: query rows, K3b: key rows) of the folded
    length ``t_pad`` (t rounded up to 64), head and batch row; the dynamic
    shared memory, the ring's stages and the blocks per SM they are built
    for. The C launchers check rows, threads and shared memory against
    their own rule."""
    t_pad = -(-t // BWD_BF16_ROWS) * BWD_BF16_ROWS
    return {kernel: {"grid": (t_pad // BWD_BF16_ROWS, h, b), "threads": BWD_BF16_THREADS,
                     "rows_per_block": BWD_BF16_ROWS, "smem_bytes": BWD_BF16_SMEM_BYTES,
                     "stages": BWD_BF16_STAGES, "t_pad": t_pad,
                     "blocks_per_sm": BWD_BF16_BLOCKS_PER_SM[kernel]}
            for kernel in ("dq", "dkv")}


def flash_bf16_launch_plan(t: int, b: int, h: int) -> dict:
    """K1b's launch: one block of 160 threads per 64 query rows of the
    folded length ``t_pad`` (t rounded up to 64), head and batch row; the
    dynamic shared memory, the ring's stages and the blocks per SM it is
    built for. The C launcher checks rows, threads, shared memory and
    stages against its own rule."""
    t_pad = -(-t // FWD_BF16_ROWS) * FWD_BF16_ROWS
    return {"grid": (t_pad // FWD_BF16_ROWS, h, b), "threads": FWD_BF16_THREADS,
            "rows_per_block": FWD_BF16_ROWS, "smem_bytes": FWD_BF16_SMEM_BYTES,
            "stages": FWD_BF16_STAGES, "t_pad": t_pad, "blocks_per_sm": FWD_BF16_BLOCKS_PER_SM}


def fold_bf16_ref(x, lengths, zero_past_bound: bool) -> torch.Tensor:
    """The plain version of K1b's and K2b/K3b's prologues for one operand:
    x [B, T, H, D] folded head-major to bf16 [B*H, T64, D], T64 = T
    rounded up to 64, rows t >= T zero (the JAX package's ``_fold_args``
    ``prep`` with 64-row blocks, then rounded to nearest-even bf16) and,
    with ``zero_past_bound`` (k and v), rows t >= lengths[b] zero too."""
    b, t, h, d = x.shape
    t_pad = -(-t // BWD_BF16_ROWS) * BWD_BF16_ROWS
    out = torch.zeros((b, h, t_pad, d), dtype=torch.bfloat16, device=x.device)
    out[:, :, :t] = x.transpose(1, 2).to(torch.bfloat16)
    if zero_past_bound:
        lens = lengths.to(device=x.device, dtype=torch.int64).clamp(0, t)
        past = torch.arange(t_pad, device=x.device)[None, :] >= lens[:, None]  # [B, T64]
        out[past[:, None, :, None].expand_as(out)] = 0
    return out.reshape(b * h, t_pad, d)


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.nomad_flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i] + [ll] * 12 + [ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
        occ = lib.nomad_flash_attention_fwd_occupancy
        occ.argtypes, occ.restype = [i, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    return lib


def flash_occupancy(bf16_io: bool = False) -> int:
    """Blocks of K1 (its bf16-I/O flavour with ``bf16_io``) resident on
    one SM at its shared memory (the card)."""
    lib = _lib()
    blocks = ctypes.c_int(0)
    _build.check(lib, lib.nomad_flash_attention_fwd_occupancy(int(bf16_io), ctypes.byref(blocks)),
                 "flash attention occupancy")
    return blocks.value


def _strides_ok(x) -> bool:
    """Unit stride on the head axis, the others whole 16-byte words (4 f32
    or 8 bf16 elements), 16-byte alignment."""
    per_word = 16 // x.element_size()
    return x.stride(3) == 1 and not any(s % per_word for s in x.stride()[:3]) and \
        not x.data_ptr() % 16


def _check_qkv(name, x, shape, device, dtype=torch.float32):
    if x.dtype != dtype:
        raise TypeError(f"flash kernel: {name} must be {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"flash kernel: {name} is on {x.device}, q on {device}")
    if tuple(x.shape) != shape:
        raise ValueError(f"flash kernel: {name} shape {tuple(x.shape)} != {shape}")
    if not _strides_ok(x):
        raise ValueError(
            f"flash kernel: {name} needs unit stride on the head axis, other "
            f"strides whole 16-byte words and 16-byte alignment, got strides {x.stride()}"
        )


def _check_inputs(q, k, v, lengths):
    """Shapes, strides and dtypes the kernels take: q, k and v all float32
    or all bfloat16."""
    b, t, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash kernel: head width {d} unsupported (only {HEAD_DIM})")
    if b > 65535 or h > 65535:
        raise ValueError(f"flash kernel: grid limits exceeded (B={b}, H={h})")
    dtype = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_qkv(name, x, (b, t, h, d), q.device, dtype)
    if lengths.dtype != torch.int32 or lengths.shape != (b,) or lengths.device != q.device:
        raise ValueError(f"flash kernel: lengths must be int32 [{b}] on {q.device}")


def _lib_bf16():
    lib = _build.load("flash_attention_bf16")
    whole = lib.nomad_flash_attention_bf16_fwd
    if whole.argtypes is None:  # the entries' types, once per library
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        for fn, args in ((lib.nomad_flash_attention_bf16_fwd_fold,
                          [p] * 4 + [i] * 4 + [ll] * 6 + [i, p]),
                         (lib.nomad_flash_attention_bf16_fwd_kernel,
                          [p] * 5 + [i] * 4 + [ll] * 6 + [i] * 4 + [f, i, p]),
                         (lib.nomad_flash_attention_bf16_fwd_occupancy,
                          [i, ctypes.POINTER(i)]),
                         (whole, [p] * 7 + [i] * 4 + [ll] * 12 + [i] * 4 + [f, i, p])):
            fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def flash_bf16_occupancy(bf16_io: bool = False) -> int:
    """Blocks of K1b (its bf16-I/O flavour with ``bf16_io``) resident on
    one SM at its dynamic shared memory (the card)."""
    lib = _lib_bf16()
    blocks = ctypes.c_int(0)
    _build.check(lib, lib.nomad_flash_attention_bf16_fwd_occupancy(
        int(bf16_io), ctypes.byref(blocks)), "bf16 flash attention occupancy")
    return blocks.value


def _flash_bf16_fold_shape(q) -> tuple:
    """K1b's fold for q's shape: [2, B*H, T64, D] (k, v)."""
    b, t, h, d = q.shape
    return (2, b * h, -(-t // FWD_BF16_ROWS) * FWD_BF16_ROWS, d)


def _flash_bf16_workspace(q) -> torch.Tensor:
    """K1b's prologue's buffer for a call on q's shape: the fold, bf16."""
    return torch.empty(_flash_bf16_fold_shape(q), dtype=torch.bfloat16, device=q.device)


def _check_flash_bf16_workspace(q, workspace) -> None:
    """Refuse a workspace that was not made for q's shape and device: the
    kernel reads it through a tensor map built from q's shape alone."""
    shape = _flash_bf16_fold_shape(q)
    if (not torch.is_tensor(workspace) or tuple(workspace.shape) != shape
            or workspace.dtype != torch.bfloat16 or workspace.device != q.device
            or not workspace.is_contiguous()):
        raise ValueError(f"flash kernel: the forward's workspace must be contiguous bf16 "
                         f"{list(shape)} on {q.device}")


def _count_fwd_bf16(kernels, bf16_io: bool) -> None:
    """One launch more on the counter of each of ``kernels`` ("fold",
    "kernel": K1b itself) in its I/O flavour."""
    for kernel in kernels:
        name = "launches_fwd_fold_bf16" if kernel == "fold" else "launches_bf16"
        globals()[name + ("_io" if bf16_io else "")] += 1


def _flash_bf16_fold(q, k, v, lengths, workspace=None) -> torch.Tensor:
    """K1b's prologue alone: k and v rounded to bf16 (copied, for bf16
    inputs) and folded as ``fold_bf16_ref`` folds them, zero past each
    bound, into ``workspace`` (``_flash_bf16_workspace(q)``, made when not
    given); returns it."""
    b, t, h, d = q.shape
    _check_inputs(q, k, v, lengths)
    if workspace is None:
        workspace = _flash_bf16_workspace(q)
    _check_flash_bf16_workspace(q, workspace)
    if q.numel() == 0:
        return workspace
    bf16_io = q.dtype == torch.bfloat16
    lib = _lib_bf16()
    err = lib.nomad_flash_attention_bf16_fwd_fold(
        k.data_ptr(), v.data_ptr(), lengths.contiguous().data_ptr(), workspace.data_ptr(),
        b, t, h, d, *k.stride()[:3], *v.stride()[:3], int(bf16_io),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "bf16 flash attention prologue launch")
    _count_fwd_bf16(("fold",), bf16_io)
    return workspace


def _flash_bf16_outputs(q):
    """K1b's O [B, T, H, D] in q's dtype and LSE f32 [B, H, T], empty."""
    b, t, h, d = q.shape
    return (torch.empty((b, t, h, d), dtype=q.dtype, device=q.device),
            torch.empty((b, h, t), dtype=torch.float32, device=q.device))


def _flash_bf16_body(q, workspace, lengths):
    """K1b alone on its prologue's ``workspace`` for q's shape: (O in q's
    dtype, LSE f32)."""
    b, t, h, d = q.shape
    _check_flash_bf16_workspace(q, workspace)
    o, lse = _flash_bf16_outputs(q)
    if o.numel() == 0:
        return o, lse
    bf16_io = q.dtype == torch.bfloat16
    plan = flash_bf16_launch_plan(t, b, h)
    lib = _lib_bf16()
    err = lib.nomad_flash_attention_bf16_fwd_kernel(
        q.data_ptr(), workspace.data_ptr(), lengths.contiguous().data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, t, h, d, *q.stride()[:3], *o.stride()[:3], plan["rows_per_block"],
        plan["threads"], plan["smem_bytes"], plan["stages"], 1.0 / d**0.5, int(bf16_io),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "bf16 flash attention kernel launch")
    _count_fwd_bf16(("kernel",), bf16_io)
    return o, lse


def _flash_bf16_kernel(q, k, v, lengths):
    """K1b: the "default" flavour on the tensor cores (bf16 operands, f32
    accumulation and softmax), the same inputs and outputs as K1; on bf16
    q, k and v its bf16-I/O flavour, O in bf16. The prologue and the kernel
    in one C call, one tensor map: at the loss crop the host's work, not
    the card's, sets the pace."""
    b, t, h, d = q.shape
    _check_inputs(q, k, v, lengths)
    o, lse = _flash_bf16_outputs(q)
    if o.numel() == 0:
        return o, lse
    bf16_io = q.dtype == torch.bfloat16
    lengths = lengths.contiguous()
    workspace = _flash_bf16_workspace(q)
    plan = flash_bf16_launch_plan(t, b, h)
    lib = _lib_bf16()
    err = lib.nomad_flash_attention_bf16_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), workspace.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, t, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        plan["rows_per_block"], plan["threads"], plan["smem_bytes"], plan["stages"],
        1.0 / d**0.5, int(bf16_io), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "bf16 flash attention launch")
    _count_fwd_bf16(("fold", "kernel"), bf16_io)
    return o, lse


def _flash_kernel(q, k, v, lengths):
    """K1: the f32 flavour ("highest", "high"); on bf16 q, k and v its
    bf16-I/O flavour, O in bf16."""
    b, t, h, d = q.shape
    _check_inputs(q, k, v, lengths)
    bf16_io = q.dtype == torch.bfloat16
    lengths = lengths.contiguous()
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _lib()
    err = lib.nomad_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, t, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        1.0 / d**0.5, flash_launch_plan(t, b, h)["smem_bytes"], int(bf16_io),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "flash attention kernel launch")
    global launches, launches_f32_bf16_io
    if bf16_io:
        launches_f32_bf16_io += 1
    else:
        launches += 1
    return o, lse


def mha_flash(q, k, v, lengths, precision="highest"):
    """Attention on [B, T, H, D] with lengths int32 [B] valid keys per
    batch row -> (O [B, T, H, D] in q's dtype, LSE f32 [B, H, T]). On CUDA
    tensors K1 ("highest", "high") or K1b ("default"), each on f32 or bf16
    I/O, on CPU tensors the plain version of the same flavour."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, lengths, precision)
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel runs on CUDA tensors, got {q.device}")
    if is_bf16(precision):
        return _flash_bf16_kernel(q, k, v, lengths)
    return _flash_kernel(q, k, v, lengths)


def _lib_bwd():
    lib = _build.load("flash_attention_bwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn, outs in ((lib.nomad_flash_attention_bwd_dq, 1), (lib.nomad_flash_attention_bwd_dkv, 2)):
        if fn.argtypes is None:
            fn.argtypes = [p] * (7 + outs) + [i] * 4 + [ll] * 12 + [ctypes.c_float, i, i, i, p]
            fn.restype = ctypes.c_int
    occ = lib.nomad_flash_attention_bwd_occupancy
    if occ.argtypes is None:
        occ.argtypes, occ.restype = [i, i, i, ctypes.POINTER(i)], ctypes.c_int
    return lib


def flash_bwd_occupancy(kernel: str, rows_per_block: int, bf16_io: bool = False) -> int:
    """Blocks of K2 (``kernel="dq"``) or K3 (``"dkv"``), or of their
    bf16-I/O flavour with ``bf16_io``, resident on one SM for a plan of
    ``rows_per_block`` rows, at its shared memory (the card)."""
    lib = _lib_bwd()
    blocks = ctypes.c_int(0)
    _build.check(lib, lib.nomad_flash_attention_bwd_occupancy(
        int(kernel == "dkv"), rows_per_block, int(bf16_io), ctypes.byref(blocks)),
        "flash backward occupancy")
    return blocks.value


def _bwd_args(q, k, v, o, lse, do, lengths):
    """Checks shared by K2 and K3 and by K2b and K3b, on f32 or bf16
    tensors; returns their inputs in launch form: dO as given when its
    strides suit the kernels (else a contiguous copy), Di = rowsum(dO*O)
    [B, H, T] in f32 from one PyTorch reduction of the upcast operands (as
    the JAX package upcasts before it multiplies), lengths contiguous."""
    b, t, h, d = q.shape
    _check_inputs(q, k, v, lengths)
    _check_qkv("o", o, (b, t, h, d), q.device, q.dtype)
    if do.dtype != q.dtype or tuple(do.shape) != (b, t, h, d) or do.device != q.device:
        raise ValueError(f"flash kernel: dO must be {q.dtype} [{b}, {t}, {h}, {d}] on {q.device}")
    if not _strides_ok(do):
        do = do.contiguous()
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, t) or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash kernel: lse must be contiguous float32 [{b}, {h}, {t}]")
    di = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
    return do, di, lengths.contiguous()


def _launch_bwd(kernel, q, k, v, do, lse, di, lengths, outs, what):
    b, t, h, d = q.shape
    plan = flash_bwd_launch_plan(t, b, h)[kernel]
    lib = _lib_bwd()
    err = getattr(lib, f"nomad_flash_attention_bwd_{kernel}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), lengths.data_ptr(), *(x.data_ptr() for x in outs), b, t, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        1.0 / d**0.5, plan["rows_per_block"], plan["smem_bytes"], int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, what)


def _bwd_dq_kernel(q, k, v, do, lse, di, lengths):
    """K2 on arguments prepared by ``_bwd_args``: dQ [B, T, H, D] in q's
    dtype (f32, or bf16 for the bf16-I/O flavour)."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    _launch_bwd("dq", q, k, v, do, lse, di, lengths, (dq,),
                "flash attention dQ kernel launch")
    global launches_bwd_dq, launches_bwd_dq_f32_bf16_io
    if q.dtype == torch.bfloat16:
        launches_bwd_dq_f32_bf16_io += 1
    else:
        launches_bwd_dq += 1
    return dq


def _bwd_dkv_kernel(q, k, v, do, lse, di, lengths):
    """K3 on arguments prepared by ``_bwd_args``: (dK, dV) [B, T, H, D] in
    q's dtype."""
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return dk, dv
    _launch_bwd("dkv", q, k, v, do, lse, di, lengths, (dk, dv),
                "flash attention dK/dV kernel launch")
    global launches_bwd_dkv, launches_bwd_dkv_f32_bf16_io
    if q.dtype == torch.bfloat16:
        launches_bwd_dkv_f32_bf16_io += 1
    else:
        launches_bwd_dkv += 1
    return dk, dv


def _lib_bwd_bf16():
    lib = _build.load("flash_attention_bwd_bf16")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fold = lib.nomad_flash_attention_bwd_bf16_fold
    if fold.argtypes is None:
        fold.argtypes = [p] * 9 + [i] * 4 + [ll] * 12 + [i, p]
        fold.restype = ctypes.c_int
    whole = lib.nomad_flash_attention_bwd_bf16
    if whole.argtypes is None:
        whole.argtypes = [p] * 12 + [i] * 4 + [ll] * 12 + [i] * 3 + [ctypes.c_float, i, p]
        whole.restype = ctypes.c_int
    for fn, outs in ((lib.nomad_flash_attention_bwd_bf16_dq, 1),
                     (lib.nomad_flash_attention_bwd_bf16_dkv, 2)):
        if fn.argtypes is None:
            fn.argtypes = [p] * (3 + outs) + [i] * 7 + [ctypes.c_float, i, p]
            fn.restype = ctypes.c_int
    occ = lib.nomad_flash_attention_bwd_bf16_occupancy
    if occ.argtypes is None:
        occ.argtypes, occ.restype = [i, i, ctypes.POINTER(i)], ctypes.c_int
    return lib


def flash_bwd_bf16_occupancy(kernel: str, bf16_io: bool = False) -> int:
    """Blocks of K2b (``kernel="dq"``) or K3b (``"dkv"``), or of their
    bf16-I/O flavour with ``bf16_io``, resident on one SM (the card)."""
    lib = _lib_bwd_bf16()
    blocks = ctypes.c_int(0)
    _build.check(lib, lib.nomad_flash_attention_bwd_bf16_occupancy(
        int(kernel == "dkv"), int(bf16_io), ctypes.byref(blocks)),
        "bf16 flash backward occupancy")
    return blocks.value


def _bwd_bf16_workspace(q):
    """The prologue's buffers for a backward call on q's shape: the fold
    (bf16 [4, B*H, T64, D]: q, k, v, dO) and LSE and Di padded (f32
    [2, B*H, T64])."""
    b, t, h, d = q.shape
    t_pad = -(-t // BWD_BF16_ROWS) * BWD_BF16_ROWS
    return (torch.empty((4, b * h, t_pad, d), dtype=torch.bfloat16, device=q.device),
            torch.empty((2, b * h, t_pad), dtype=torch.float32, device=q.device))


def _check_bwd_bf16_workspace(q, workspace) -> None:
    """Refuse a workspace that was not made for q's shape and device: the
    kernels read it through a tensor map built from q's shape alone."""
    b, t, h, d = q.shape
    t_pad = -(-t // BWD_BF16_ROWS) * BWD_BF16_ROWS
    want = (((4, b * h, t_pad, d), torch.bfloat16), ((2, b * h, t_pad), torch.float32))
    if len(workspace) != 2 or any(
            tuple(x.shape) != shape or x.dtype != dtype or x.device != q.device
            or not x.is_contiguous() for x, (shape, dtype) in zip(workspace, want)):
        raise ValueError(f"flash kernel: the backward's workspace must be contiguous bf16 "
                         f"{list(want[0][0])} and float32 {list(want[1][0])} on {q.device}")


def _count_bwd_bf16(kernels, bf16_io: bool) -> None:
    """One launch more on the counter of each of ``kernels`` ("fold", "dq",
    "dkv") in its I/O flavour."""
    for kernel in kernels:
        globals()[f"launches_bwd_{kernel}_bf16" + ("_io" if bf16_io else "")] += 1


def _bwd_bf16_fold(q, k, v, do, lse, di, lengths, workspace=None):
    """K2b/K3b's prologue on arguments prepared by ``_bwd_args``: q, k, v
    and dO rounded to bf16 (copied, for bf16 inputs) and folded as
    ``fold_bf16_ref`` folds them, k and v zero past each bound; LSE and Di
    padded with zeros. Writes into ``workspace`` (``_bwd_bf16_workspace``)
    when it is given; returns it."""
    b, t, h, d = q.shape
    bf16_io = q.dtype == torch.bfloat16
    if workspace is None:
        workspace = _bwd_bf16_workspace(q)
    _check_bwd_bf16_workspace(q, workspace)
    if q.numel() == 0:
        return workspace
    lib = _lib_bwd_bf16()
    err = lib.nomad_flash_attention_bwd_bf16_fold(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), lengths.data_ptr(), *(x.data_ptr() for x in workspace), b, t, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        int(bf16_io), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "bf16 flash attention backward prologue launch")
    _count_bwd_bf16(("fold",), bf16_io)
    return workspace


def _bwd_bf16_kernel(kernel, q, workspace, lengths):
    """K2b (``kernel="dq"``: (dQ,)) or K3b (``"dkv"``: (dK, dV)) alone, on
    the prologue's ``workspace`` for q's shape; outputs [B, T, H, D] in q's
    dtype (f32, or bf16 for the bf16-I/O flavour)."""
    b, t, h, d = q.shape
    bf16_io = q.dtype == torch.bfloat16
    _check_bwd_bf16_workspace(q, workspace)
    outs = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device)
                 for _ in range(1 if kernel == "dq" else 2))
    if q.numel() == 0:
        return outs
    plan = flash_bwd_bf16_launch_plan(t, b, h)[kernel]
    lib = _lib_bwd_bf16()
    err = getattr(lib, f"nomad_flash_attention_bwd_bf16_{kernel}")(
        *(x.data_ptr() for x in workspace), lengths.data_ptr(), *(x.data_ptr() for x in outs),
        b, t, h, d, plan["rows_per_block"], plan["threads"], plan["smem_bytes"],
        1.0 / d**0.5, int(bf16_io), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, f"bf16 flash attention {'dQ' if kernel == 'dq' else 'dK/dV'} "
                 "kernel launch")
    _count_bwd_bf16((kernel,), bf16_io)
    return outs


def _bwd_bf16(q, k, v, do, lse, di, lengths):
    """The prologue, K2b and K3b in one C call on arguments prepared by
    ``_bwd_args``, as ``flash_attention_bwd`` runs them: (dQ, dK, dV) in
    q's dtype. One call into C and one tensor map for both kernels: at the
    loss crop the host's work, not the card's, sets the pace."""
    b, t, h, d = q.shape
    bf16_io = q.dtype == torch.bfloat16
    outs = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    if q.numel() == 0:
        return outs
    workspace = _bwd_bf16_workspace(q)
    plan = flash_bwd_bf16_launch_plan(t, b, h)["dq"]
    lib = _lib_bwd_bf16()
    err = lib.nomad_flash_attention_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), lengths.data_ptr(), *(x.data_ptr() for x in workspace),
        *(x.data_ptr() for x in outs), b, t, h, d, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *do.stride()[:3], plan["rows_per_block"], plan["threads"],
        plan["smem_bytes"], 1.0 / d**0.5, int(bf16_io),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "bf16 flash attention backward launch")
    _count_bwd_bf16(("fold", "dq", "dkv"), bf16_io)
    return outs


def flash_attention_bwd(q, k, v, o, lse, do, lengths, precision="highest"):
    """Gradients (dQ, dK, dV) of ``mha_flash``'s O for the cotangent dO,
    from the saved O and LSE, in q's dtype. On CUDA tensors K2 and K3
    ("highest", "high") or K2b and K3b ("default"), each on f32 or bf16
    I/O, on CPU tensors the plain version of the same flavour."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, lengths, precision)
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel runs on CUDA tensors, got {q.device}")
    do, di, lengths = _bwd_args(q, k, v, o, lse, do, lengths)
    if is_bf16(precision):
        return _bwd_bf16(q, k, v, do, lse, di, lengths)
    dq = _bwd_dq_kernel(q, k, v, do, lse, di, lengths)
    dk, dv = _bwd_dkv_kernel(q, k, v, do, lse, di, lengths)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, lengths, precision="highest")`` -> O
    [B, T, H, D], masked attention differentiable in q, k, v (lengths int32
    [B] gets no gradient): ``mha_flash`` forward (K1, or K1b for
    "default", on the card), ``flash_attention_bwd`` backward (K2 + K3, or
    K2b + K3b for "default", on the card); the plain versions of both on
    the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, precision="highest"):
        o, lse = mha_flash(q, k, v, lengths, precision)
        ctx.save_for_backward(q, k, v, o, lse, lengths)
        ctx.precision = precision
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse, lengths = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, lengths, ctx.precision)
        return dq, dk, dv, None, None
