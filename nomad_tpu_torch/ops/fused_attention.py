"""Projection-fused attention: kernels K4 and K4b beside their plain
PyTorch versions.

Counterpart of ``nomad_tpu.ops.fused_attention``. ``fused_qkv_mha``
launches K4 (``csrc/fused_attention.cu``, f32: the TPU kernel's "highest"
and "high3" modes) or K4b (``csrc/fused_attention_bf16.cu``, its
"default" mode: each of the five products in one bf16 pass with f32
accumulation, an f32 softmax) on CUDA tensors and computes the plain
version of the same precision on CPU tensors: the q/k/v projections of
every head and masked softmax attention in one call, from the hidden
states x [B, T, D_model] and the projections' weights in ``nn.Linear``'s
[out, in] layout, returning O head-major [B, H, T, hd]. Every query row
is defined, padded rows included; a row with no valid key gives O = 0.

``FusedQKVAttention`` is the differentiable form. Its backward is the vjp
of the unfused composition at the same precision, as the JAX package's is
(``_fused_bwd``): the projections are recomputed through
``precision.linear`` and the attention goes through
``flash_attention.FlashAttention`` (K1 forward, K2 + K3 backward on the
card; K1b, K2b + K3b at "default"). ``fused_qkv_attention`` is the whole
sublayer, out-projection included (``precision.linear``); beyond
``MAX_FUSED_T`` frames it takes the unfused composition with K1 or K1b,
the JAX package's own shape rule.

On a bf16 x (bf16 activations in the block stack) K4 and K4b run their
bf16-I/O flavours: x is read as bf16, the weights and biases stay f32, O
comes back in bf16, each the f32-I/O flavour's O on the upcast x rounded
once. The JAX package hands its fused path the raw f32 parameters, so the
out-projection, the backward's q/k/v recompute and the fallback beyond
``MAX_FUSED_T`` take ``precision.linear_raw_weights`` there (an f32
product of the upcast x, one rounding), not flax's bf16 ``nn.Dense``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from . import precision as prec_ops
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

# K4b's (csrc/fused_attention_bf16.cu): a ring of 3 stages, each a 64-wide
# model-axis slice of 64 bf16 x rows and 192 bf16 weight rows (Q, K and V
# of one head), on 1,024-byte swizzle atoms, with a "full" and an "empty"
# mbarrier per stage; once phase 1 is done, in the ring's memory, Q, K and
# V of the chunk and three K + V tiles of 64 keys (64 rows of 128 bytes
# each); 1,024 bytes to align the ring. A consumer warpgroup and a producer
# warp a block, 2 blocks an SM.
_BF16_STAGES, _BF16_SLICE = 3, 64
_BF16_HEAD_ROWS = 3 * HEAD_DIM  # rows of the packed weights per head
_BF16_RING_BYTES = 2 * _BF16_STAGES * (ROWS_PER_BLOCK + _BF16_HEAD_ROWS) * _BF16_SLICE
FUSED_BF16_SMEM_BYTES = _BF16_RING_BYTES + 8 * 2 * _BF16_STAGES + 1024
FUSED_BF16_THREADS = THREADS + 32
FUSED_BF16_BLOCKS_PER_SM = 2

# Launches of K4 and of K4b, and of their bf16-I/O flavours, since each
# count was last set to 0.
launches = 0
launches_bf16 = 0
launches_f32_bf16_io = 0
launches_bf16_io = 0


def fused_supported(t: int) -> bool:
    return t <= MAX_FUSED_T


@dataclass(frozen=True)
class FusedPlan:
    """How K4 splits one (batch, head) over a thread-block cluster of
    ``cluster`` blocks (grid x), for T frames. ``tensors_per_block`` 3: a
    cluster along T, block r projects Q, K and V of rows 64r .. 64r + 63
    and attends those query rows. 1 (T <= 64): block g projects tensor g
    (Q, K, V) of all rows, and the blocks share the query rows by 16-row
    warp tiles, warp tile w going to block w % 3. ``smem_bytes`` and
    ``threads`` are the kernel's own (K4 or K4b)."""

    t: int
    cluster: int
    rows_per_block: int
    tensors_per_block: int
    grid: tuple
    smem_bytes: int
    threads: int

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


def fused_launch_plan(t: int, b: int, h: int, precision: str = "highest") -> FusedPlan:
    """The launch of K4 (or of K4b, at ``precision`` "default") for x
    [b, t, 64 h]: the cluster size, rows per block, tensors per block,
    grid (cluster, h, b), dynamic shared memory and threads a block. The
    two kernels split a (batch, head) alike and differ in shared memory
    and threads. The C launcher checks each against the kernel's own
    rule."""
    if not 1 <= t <= MAX_FUSED_T:
        raise ValueError(f"fused kernel: T = {t} outside 1 .. {MAX_FUSED_T}")
    if t <= ROWS_PER_BLOCK:
        cluster, tensors = 3, 1
    else:
        cluster, tensors = -(-t // ROWS_PER_BLOCK), 3
    if prec_ops.is_bf16(precision):
        smem, threads = FUSED_BF16_SMEM_BYTES, FUSED_BF16_THREADS
    else:
        smem, threads = FUSED_SMEM_BYTES, THREADS
    return FusedPlan(t, cluster, ROWS_PER_BLOCK, tensors, (cluster, h, b), smem, threads)


def _linear(x, w, bias, precision):
    """A product of the fused path at ``precision``: ``precision.linear``,
    or on a bf16 x ``precision.linear_raw_weights`` (the raw f32 weights,
    one rounding), as the JAX package's ``_unfused_ref``."""
    if x.dtype == torch.bfloat16:
        return prec_ops.linear_raw_weights(x, w, bias, precision)
    return prec_ops.linear(x, w, bias, precision)


def _qkv(x, wq, bq, wk, bk, wv, bv, heads, precision="highest"):
    """The three projections at ``precision`` (``_linear``) as [B, T, H,
    hd] views of [B, T, D] products."""
    b, t, dm = x.shape
    return tuple(_linear(x, w, bias, precision).view(b, t, heads, dm // heads)
                 for w, bias in ((wq, bq), (wk, bk), (wv, bv)))


def fused_qkv_attention_ref(x, wq, bq, wk, bk, wv, bv, lengths, heads, precision="highest"):
    """What ``_fused_kernel`` computes, unfolded: Q = (x.Wq^T + bq)/sqrt(hd),
    K and V likewise; scores against keys t < lengths[b] (the others set to
    -1e30, never added to), softmax in f32, O = P.V / l, returned
    head-major [B, H, T, hd]. Values past the bound are zeroed before the
    product, so a NaN there cannot reach O.

    ``precision`` "highest" or "high": f32 products. "default", the TPU
    kernel's ``_dot`` at DEFAULT (``nomad_tpu/ops/fused_attention.py:65-87``):
    the operands of all five products rounded to bf16 (``round_bf16``), f32
    sums, each bias added in f32 after its product; the scale 1/sqrt(hd) is
    exact, so q is rounded after it, and p = exp(s - m) is rounded against
    the row's final maximum with l the sum of the unrounded p.

    A bf16 x is upcast; O is returned in x's dtype, rounded once."""
    b, t, dm = x.shape
    hd = dm // heads
    rnd = prec_ops.round_bf16 if prec_ops.is_bf16(precision) else (lambda y: y)
    xr = rnd(x.to(torch.float32))
    q, k, v = ((torch.matmul(xr, rnd(w).t()) + bias).view(b, t, heads, hd).transpose(1, 2)
               for w, bias in ((wq, bq), (wk, bk), (wv, bv)))  # [B, H, T, hd]
    lengths = lengths.to(device=x.device, dtype=torch.int64).clamp(0, t)
    valid = torch.arange(t, device=x.device)[None, :] < lengths[:, None]  # [B, T]
    s = torch.matmul(rnd(q * (1.0 / hd**0.5)), rnd(k).transpose(-1, -2))
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid[:, None, None, :], p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(rnd(p), rnd(torch.where(valid[:, None, :, None], v, 0.0)))
    o = o * torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    return o.to(x.dtype)


# the library and C entry of each precision's kernel: K4 (f32), K4b (bf16);
# each takes f32 or bf16 I/O
_KERNELS = {False: ("fused_attention", "nomad_fused_qkv_attention_fwd"),
            True: ("fused_attention_bf16", "nomad_fused_qkv_attention_bf16_fwd")}


def _lib(bf16: bool = False):
    source, entry = _KERNELS[bf16]
    lib = _build.load(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # K4b also takes the buffers of its packed weights and rounded x, and
        # its threads a block
        fn.argtypes = [p] * (11 if bf16 else 9) + [i] * 4 + [ll] * 3 + [ctypes.c_float] + (
            [i] * (6 if bf16 else 5) + [p])
        fn.restype = ctypes.c_int
        occ = getattr(lib, f"{entry}_occupancy")
        occ.argtypes = [i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        occ.restype = ctypes.c_int
    return lib


def fused_occupancy(t: int, precision: str = "highest", bf16_io: bool = False) -> tuple:
    """(blocks of K4, or of K4b at "default", or of their bf16-I/O flavour
    with ``bf16_io``, resident on one SM, clusters resident on the card)
    for the cluster size of T frames (the card)."""
    bf16 = prec_ops.is_bf16(precision)
    lib = _lib(bf16)
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    err = getattr(lib, f"{_KERNELS[bf16][1]}_occupancy")(
        fused_launch_plan(t, 1, 1, precision).cluster, int(bf16_io), ctypes.byref(blocks),
        ctypes.byref(clusters))
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
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused kernel: x must be float32 or bfloat16, got {x.dtype}")
    for name, a in (("x", x), *params.items()):
        if name != "x" and a.dtype != torch.float32:
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


def pack_weights_ref(wq, wk, wv, heads: int) -> torch.Tensor:
    """The plain version of K4b's prologue: the q/k/v weights ([out, in])
    rounded to bf16 and packed head-major, [H * 3 * hd, D], rows 3 hd h ..
    3 hd h + hd - 1 head h's rows of wq, then of wk, then of wv: the JAX
    package's ``per_head_w`` ([H, D, hd] of the [in, out] weights), each
    head's slice transposed, stacked over the three."""
    dm = wq.shape[1]
    hd = dm // heads
    return torch.stack([w.view(heads, hd, dm) for w in (wq, wk, wv)], dim=1).to(
        torch.bfloat16).reshape(heads * 3 * hd, dm)


def _bf16_workspace(x, heads):
    """K4b's buffers, written by its prologue: the packed weights
    (``pack_weights_ref``'s layout) and, for an f32 x, x rounded to bf16
    (None for a bf16 x, which the kernel reads as it is)."""
    dm = x.shape[2]
    wp = torch.empty((heads * _BF16_HEAD_ROWS, dm), dtype=torch.bfloat16, device=x.device)
    xr = None if x.dtype == torch.bfloat16 else torch.empty(x.shape, dtype=torch.bfloat16,
                                                              device=x.device)
    return wp, xr


def _launch(bf16, x, wq, bq, wk, bk, wv, bv, lengths, heads, workspace=None):
    """K4 or K4b (their bf16-I/O flavour on a bf16 x) on inputs that pass
    ``_check_inputs``: O [B, T, H, hd] in x's dtype, written through its
    strides and handed out head-major as a view, so the out-projection
    reads it as [B, T, D] with no copy. K4b writes its prologue's buffers
    into ``workspace`` (``_bf16_workspace``) when it is given."""
    params = {"wq": wq, "bq": bq, "wk": wk, "bk": bk, "wv": wv, "bv": bv}
    _check_inputs(x, params, lengths, heads)
    b, t, dm = x.shape
    o = torch.empty((b, t, heads, HEAD_DIM), dtype=x.dtype, device=x.device)
    if o.numel() == 0:
        return o.transpose(1, 2)
    lengths = lengths.contiguous()
    plan = fused_launch_plan(t, b, heads, "default" if bf16 else "highest")
    buffers, threads = (), ()
    if bf16:
        workspace = workspace or _bf16_workspace(x, heads)
        buffers = tuple(0 if a is None else a.data_ptr() for a in workspace)
        threads = (plan.threads,)
    lib = _lib(bf16)
    err = getattr(lib, _KERNELS[bf16][1])(
        x.data_ptr(), *(a.data_ptr() for a in params.values()), lengths.data_ptr(),
        o.data_ptr(), *buffers, b, t, heads, dm, *o.stride()[:3], 1.0 / HEAD_DIM**0.5,
        plan.cluster, plan.rows_per_block, plan.tensors_per_block, *threads, plan.smem_bytes,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, f"{'bf16 ' if bf16 else ''}fused attention kernel launch")
    return o.transpose(1, 2)


def _fused_kernel(x, wq, bq, wk, bk, wv, bv, lengths, heads):
    """K4: the f32 flavour ("highest", "high"); on a bf16 x its bf16-I/O
    flavour."""
    o = _launch(False, x, wq, bq, wk, bk, wv, bv, lengths, heads)
    global launches, launches_f32_bf16_io
    if x.dtype == torch.bfloat16:
        launches_f32_bf16_io += 1
    else:
        launches += 1
    return o


def _fused_bf16_kernel(x, wq, bq, wk, bk, wv, bv, lengths, heads):
    """K4b: the "default" flavour on the tensor cores; f32 inputs (rounded
    by the kernel's prologue, which also packs the weights) and output, as
    K4's, or on a bf16 x its bf16-I/O flavour."""
    o = _launch(True, x, wq, bq, wk, bk, wv, bv, lengths, heads)
    global launches_bf16, launches_bf16_io
    if x.dtype == torch.bfloat16:
        launches_bf16_io += 1
    else:
        launches_bf16 += 1
    return o


def fused_qkv_mha(x, wq, bq, wk, bk, wv, bv, lengths, heads, precision="highest"):
    """Projections + attention of x [B, T, D] (f32 or bf16; f32 weights)
    with lengths int32 [B] valid keys per batch row -> O head-major [B, H,
    T, hd] in x's dtype. On CUDA tensors K4 ("highest", "high") or K4b
    ("default"), on CPU tensors the plain version of the same precision."""
    if x.device.type == "cpu":
        return fused_qkv_attention_ref(x, wq, bq, wk, bk, wv, bv, lengths, heads, precision)
    if x.device.type != "cuda":
        raise ValueError(f"fused kernel runs on CUDA tensors, got {x.device}")
    if prec_ops.is_bf16(precision):
        return _fused_bf16_kernel(x, wq, bq, wk, bk, wv, bv, lengths, heads)
    return _fused_kernel(x, wq, bq, wk, bk, wv, bv, lengths, heads)


class FusedQKVAttention(torch.autograd.Function):
    """``FusedQKVAttention.apply(x, wq, bq, wk, bk, wv, bv, lengths, heads,
    precision="highest")`` -> O head-major [B, H, T, hd], differentiable in
    x and the projections (lengths, heads and precision get no gradient):
    ``fused_qkv_mha`` forward (K4, or K4b at "default", on the card), the
    vjp of the unfused composition at the same precision backward
    (``_linear``, whose backward at "default" rounds as JAX transposes a
    DEFAULT product, and ``FlashAttention``: K1 + K2 + K3 on the card, K1b
    + K2b + K3b at "default"; their bf16-I/O flavours on a bf16 x)."""

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, lengths, heads, precision="highest"):
        ctx.save_for_backward(x, wq, bq, wk, bk, wv, bv, lengths)
        ctx.heads, ctx.precision = heads, precision
        return fused_qkv_mha(x, wq, bq, wk, bk, wv, bv, lengths, heads, precision)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        *saved, lengths = ctx.saved_tensors
        needs = ctx.needs_input_grad[:7]
        inputs = [a.detach().requires_grad_(n) for a, n in zip(saved, needs)]
        with torch.enable_grad():
            q, k, v = _qkv(*inputs, ctx.heads, ctx.precision)
            o = FlashAttention.apply(q, k, v, lengths, ctx.precision).transpose(1, 2)
            grads = iter(torch.autograd.grad(o, [a for a, n in zip(inputs, needs) if n], do))
        return (*(next(grads) if n else None for n in needs), None, None, None)


def fused_qkv_attention(x, wq, bq, wk, bk, wv, bv, wo, bo, key_mask=None, heads: int = 12,
                        precision: str = "highest"):
    """The attention sublayer on hidden states x [B, T, D] at one
    ``precision`` for the whole block, as the JAX kernel has one mode:
    q/k/v projections and masked softmax attention in K4, or K4b at
    "default" (``FusedQKVAttention``), then the out-projection (``_linear``)
    as one product of the head-major output.
    key_mask: optional bool [B, T] prefix mask, True = valid key. Weights
    in ``nn.Linear``'s [out, in] layout. Returns [B, T, D].

    Beyond ``MAX_FUSED_T`` frames it computes the unfused composition at
    the same precision, attention through ``mha(impl="kernel")`` (K1, or
    K1b at "default", on the card), as the JAX package falls back to its
    ``_unfused_ref``."""
    b, t, dm = x.shape
    if not fused_supported(t):
        q, k, v = _qkv(x, wq, bq, wk, bk, wv, bv, heads, precision)
        attn = mha(q, k, v, key_mask=key_mask, impl="kernel", precision=precision)
        return _linear(attn.reshape(b, t, dm), wo, bo, precision)
    if key_mask is None:
        lengths = torch.full((b,), t, dtype=torch.int32, device=x.device)
    else:
        lengths = key_mask.sum(dim=-1, dtype=torch.int32)
    o = FusedQKVAttention.apply(x, wq, bq, wk, bk, wv, bv, lengths, heads, precision)
    return _linear(o.transpose(1, 2).reshape(b, t, dm), wo, bo, precision)
