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
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _build
from .attention import mha
from .flash_attention import HEAD_DIM, KEY_TILES_BYTES, NEG_INF, THREADS, FlashAttention

# The JAX kernel's single pass over the padded sequence had to fit VMEM, so
# it takes round_up(T, 128) <= 1024 frames (~21 s of audio); K4 needs no
# padding to 128 and takes T <= 1024, the same set of lengths.
MAX_FUSED_T = 1024

# K4's tiles (csrc/fused_attention.cu): 64-row chunks; in phase 1 two
# model-axis slices in flight, 16 wide for Q, K and V and 32 for one
# tensor; rows padded by 4 floats
ROWS_PER_BLOCK = 64
MAX_CLUSTER = MAX_FUSED_T // ROWS_PER_BLOCK  # 16, past the portable 8
_SLOTS_BYTES = 4 * 3 * ROWS_PER_BLOCK * (HEAD_DIM + 4)
_PROJ_BYTES = 4 * 2 * max((ROWS_PER_BLOCK + nt * HEAD_DIM) * (slice_ + 4)
                          for nt, slice_ in ((3, 16), (1, 32)))
FUSED_SMEM_BYTES = _SLOTS_BYTES + max(_PROJ_BYTES, KEY_TILES_BYTES)

# Launches of K4 since the count was last set to 0.
launches = 0


def fused_supported(t: int) -> bool:
    return t <= MAX_FUSED_T


@dataclass(frozen=True)
class FusedPlan:
    """How K4 splits one (batch, head) over a thread-block cluster of
    ``cluster`` blocks (grid x), for T frames. ``tensors_per_block`` 3: a
    cluster along T, block r projects Q, K and V of rows 64r .. 64r + 63
    and attends those query rows. 1 (T <= 64): block g projects tensor g
    (Q, K, V) of all rows, and the blocks share the query rows by 16-row
    warp tiles, warp tile w going to block w % 3."""

    t: int
    cluster: int
    rows_per_block: int
    tensors_per_block: int
    grid: tuple
    smem_bytes: int

    def projects(self, rank: int) -> list:
        """(tensor, first row, end row) that block ``rank`` projects when
        every key is valid (Q: 0, K: 1, V: 2)."""
        if self.tensors_per_block == 1:
            return [(rank, 0, self.t)]
        r0 = rank * self.rows_per_block
        return [(g, r0, min(self.t, r0 + self.rows_per_block)) for g in range(3)]

    def attends(self, rank: int) -> list:
        """(first, end) query rows whose O block ``rank`` writes."""
        if self.tensors_per_block == 1:
            return [(16 * w, min(self.t, 16 * w + 16))
                    for w in range(THREADS // 32) if w % 3 == rank and 16 * w < self.t]
        r0 = rank * self.rows_per_block
        return [(r0, min(self.t, r0 + self.rows_per_block))]


def fused_launch_plan(t: int, b: int, h: int) -> FusedPlan:
    """K4's launch for x [b, t, 64 h]: the cluster size, rows per block,
    tensors per block, grid (cluster, h, b) and dynamic shared memory. The
    C launcher checks each against the kernel's own rule."""
    if not 1 <= t <= MAX_FUSED_T:
        raise ValueError(f"fused kernel: T = {t} outside 1 .. {MAX_FUSED_T}")
    if t <= ROWS_PER_BLOCK:
        cluster, tensors = 3, 1
    else:
        cluster, tensors = -(-t // ROWS_PER_BLOCK), 3
    return FusedPlan(t, cluster, ROWS_PER_BLOCK, tensors, (cluster, h, b), FUSED_SMEM_BYTES)


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
        fn.argtypes = [p] * 9 + [i] * 4 + [ll] * 3 + [ctypes.c_float] + [i] * 4 + [p]
        fn.restype = ctypes.c_int
        occ = lib.nomad_fused_qkv_attention_fwd_occupancy
        occ.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i)]
        occ.restype = ctypes.c_int
    return lib


def fused_occupancy(t: int) -> tuple:
    """(blocks of K4 resident on one SM, clusters resident on the card) for
    the cluster size of T frames (the card)."""
    lib = _lib()
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.nomad_fused_qkv_attention_fwd_occupancy(
        fused_launch_plan(t, 1, 1).cluster, ctypes.byref(blocks), ctypes.byref(clusters))
    _build.check(lib, err, "fused attention occupancy")
    return blocks.value, clusters.value


def _check_inputs(x, params, lengths, heads):
    if x.ndim != 3:
        raise ValueError(f"fused kernel: x must be [B, T, D], got shape {tuple(x.shape)}")
    b, t, dm = x.shape
    if heads <= 0 or dm % heads or dm // heads != HEAD_DIM:
        raise ValueError(
            f"fused kernel: head width {dm}/{heads} unsupported (only {HEAD_DIM})")
    if not fused_supported(t):
        raise ValueError(f"fused kernel: T = {t} frames > {MAX_FUSED_T}")
    if b > 65535 or heads > 65535:
        raise ValueError(f"fused kernel: grid limits exceeded (B={b}, H={heads})")
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
    lengths = lengths.contiguous()
    plan = fused_launch_plan(t, b, heads)
    lib = _lib()
    err = lib.nomad_fused_qkv_attention_fwd(
        x.data_ptr(), *(a.data_ptr() for a in params.values()), lengths.data_ptr(),
        o.data_ptr(), b, t, heads, dm, *o.stride()[:3], 1.0 / HEAD_DIM**0.5,
        plan.cluster, plan.rows_per_block, plan.tensors_per_block, plan.smem_bytes,
        torch.cuda.current_stream(x.device).cuda_stream,
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
