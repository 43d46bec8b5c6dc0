"""Projection-fused attention: kernels K4, K4-bf16, K4b and K4h beside
their plain PyTorch versions.

Counterpart of ``nomad_tpu.ops.fused_attention``. ``fused_qkv_mha``
launches, by precision, one of the TPU kernel's three modes on CUDA
tensors: at "highest" K4 (``csrc/fused_attention.cu``, f32) on an f32 x
and K4-bf16 (``csrc/fused_attention_bf16.cu``, the same f32-exact
products on the tensor cores: three bf16 planes of the weights, and of Q,
K, V and P, six passes a product in the key loop) on a bf16 x, at "high"
K4h (the same source, the TPU kernel's "high3": each of the five products
three bf16 passes on hi/lo splits of its operands, f32 accumulation), at
"default" K4b (the same source, one bf16 pass a product); the softmax is
f32 in all. On CPU tensors it computes the
plain version of the same precision: the q/k/v projections of every head
and masked softmax attention in one call, from the hidden states x [B, T,
D_model] and the projections' weights in ``nn.Linear``'s [out, in]
layout, returning O head-major [B, H, T, hd]. Every query row is defined,
padded rows included; a row with no valid key gives O = 0.

``FusedQKVAttention`` is the differentiable form. Its backward is the vjp
of the unfused composition at the same precision, as the JAX package's is
(``_fused_bwd``): the projections are recomputed through
``precision.linear`` and the attention goes through
``flash_attention.FlashAttention`` (K1 forward, K2 + K3 backward on the
card; K1b, K2b + K3b at "default"): at "high" the f32 products the JAX
package's ``_unfused_ref`` takes at Precision.HIGH (XLA's HIGH is f32
off the TPU), not high3. ``fused_qkv_attention`` is the whole
sublayer, out-projection included (``precision.linear``); beyond
``MAX_FUSED_T`` frames it takes the unfused composition with K1 or K1b,
the JAX package's own shape rule.

On a bf16 x (bf16 activations in the block stack) K4h and K4b run their
bf16-I/O flavours: x is read as bf16, the weights and biases stay f32, O
comes back in bf16, each the f32-I/O flavour's O on the upcast x rounded
once; at "highest" K4-bf16 computes K4's products in the tensor core's
order, so its O lies within one bf16 step of K4's on the upcast x rounded
once, not on it. The JAX package hands its fused path the raw f32 parameters, so the
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
# K4h's (the same source, templated on its 3 passes): every tile in a hi
# and a lo plane, so a stage is 64 KB and the ring 192 KB (phase 2's Q, K,
# V and key tiles, 144 KB, fit in it); two blocks do not fit an SM's
# 228 KB, so 1 block an SM, as many threads as K4b's
_HIGH3_PLANES = 2
FUSED_HIGH3_SMEM_BYTES = _HIGH3_PLANES * _BF16_RING_BYTES + 8 * 2 * _BF16_STAGES + 1024
FUSED_HIGH3_BLOCKS_PER_SM = 1
# K4-bf16's (the same source at six passes, "highest" on a bf16 x): the
# weights in three planes and x in one, so a 64-wide stage is 80 KB and the
# ring holds 2 (3 would be 240 KB); phase 2's Q, K and V of the chunk and
# three K + V tiles, each in three planes (216 KB), outgrow the ring and
# set the size; 1 block an SM
_HIGHEST_PLANES, _HIGHEST_STAGES = 3, 2
_HIGHEST_RING_BYTES = 2 * _HIGHEST_STAGES * (ROWS_PER_BLOCK + _HIGHEST_PLANES * _BF16_HEAD_ROWS) \
    * _BF16_SLICE
_HIGHEST_PHASE2_BYTES = 2 * _HIGHEST_PLANES * (3 + 3 * 2) * ROWS_PER_BLOCK * HEAD_DIM
FUSED_HIGHEST_BF16_SMEM_BYTES = max(_HIGHEST_RING_BYTES, _HIGHEST_PHASE2_BYTES) \
    + 8 * 2 * _HIGHEST_STAGES + 1024
FUSED_HIGHEST_BF16_BLOCKS_PER_SM = 1

# Launches of K4, K4b and K4h, of K4b's and K4h's bf16-I/O flavours and of
# K4-bf16 (``launches_f32_bf16_io``: "highest" on a bf16 x), since each
# count was last set to 0.
launches = 0
launches_bf16 = 0
launches_high3 = 0
launches_f32_bf16_io = 0
launches_bf16_io = 0
launches_high3_bf16_io = 0


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
    ``threads`` are the kernel's own (K4, K4h or K4b)."""

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


def fused_launch_plan(t: int, b: int, h: int, precision: str = "highest",
                      bf16_x: bool = False) -> FusedPlan:
    """The launch of ``precision``'s kernel (K4 at "highest", K4-bf16 at
    "highest" with ``bf16_x``, K4h at "high", K4b at "default") for x [b,
    t, 64 h]: the cluster size, rows per block, tensors per block, grid
    (cluster, h, b), dynamic shared memory and threads a block. The kernels
    split a (batch, head) alike and differ in shared memory and threads.
    The C launcher checks each against the kernel's own rule."""
    prec_ops.check(precision)
    if not 1 <= t <= MAX_FUSED_T:
        raise ValueError(f"fused kernel: T = {t} outside 1 .. {MAX_FUSED_T}")
    if t <= ROWS_PER_BLOCK:
        cluster, tensors = 3, 1
    else:
        cluster, tensors = -(-t // ROWS_PER_BLOCK), 3
    smem, threads = {"highest": (FUSED_SMEM_BYTES, THREADS),
                     "high": (FUSED_HIGH3_SMEM_BYTES, FUSED_BF16_THREADS),
                     "default": (FUSED_BF16_SMEM_BYTES, FUSED_BF16_THREADS)}[precision]
    if precision == "highest" and bf16_x:
        smem, threads = FUSED_HIGHEST_BF16_SMEM_BYTES, FUSED_BF16_THREADS
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


def _product(precision):
    """The plain version's product a @ b at ``precision``: f32 at
    "highest"; high3 at "high" (``precision.matmul_high3``); at "default"
    one bf16 pass (both operands rounded to bf16, f32 sums)."""
    if prec_ops.is_bf16(precision):
        return lambda a, b: torch.matmul(prec_ops.round_bf16(a), prec_ops.round_bf16(b))
    return prec_ops.matmul_high3 if precision == "high" else torch.matmul


def fused_qkv_attention_ref(x, wq, bq, wk, bk, wv, bv, lengths, heads, precision="highest"):
    """What ``_fused_kernel`` computes, unfolded: Q = (x.Wq^T + bq)/sqrt(hd),
    K and V likewise; scores against keys t < lengths[b] (the others set to
    -1e30, never added to), softmax in f32, O = P.V / l, returned
    head-major [B, H, T, hd]. Values past the bound are zeroed before the
    product, so a NaN there cannot reach O.

    ``precision`` is the TPU kernel's ``_dot`` mode
    (``nomad_tpu/ops/fused_attention.py:65-90``) for all five products,
    each bias added in f32 after its product. "highest": f32 products.
    "high", its "high3": each operand split into hi = bf16(a) and lo =
    bf16(a - hi), the product hh + hl + lh of f32 products of those
    bf16 values (exact products, f32 sums; on a bf16 x, x's lo is 0).
    "default": the operands rounded to bf16 (``round_bf16``), f32 sums. The
    scale 1/sqrt(hd) is exact, so q is rounded or split after it; p = exp(s
    - m) is rounded or split against the row's final maximum, with l the
    sum of the unrounded p.

    A bf16 x is upcast; O is returned in x's dtype, rounded once."""
    b, t, dm = x.shape
    hd = dm // heads
    mm = _product(precision)
    xr = x.to(torch.float32)
    q, k, v = ((mm(xr, w.t()) + bias).view(b, t, heads, hd).transpose(1, 2)
               for w, bias in ((wq, bq), (wk, bk), (wv, bv)))  # [B, H, T, hd]
    lengths = lengths.to(device=x.device, dtype=torch.int64).clamp(0, t)
    valid = torch.arange(t, device=x.device)[None, :] < lengths[:, None]  # [B, T]
    s = mm(q * (1.0 / hd**0.5), k.transpose(-1, -2))
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid[:, None, None, :], p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    o = mm(p, torch.where(valid[:, None, :, None], v, 0.0))
    o = o * torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    return o.to(x.dtype)


# the library and C entry of each kernel by (precision, bf16 x): K4 (f32
# FMA, an f32 x), K4-bf16 (bf16 x 6, a bf16 x), K4h (bf16 x 3) and K4b
# (bf16), K4h and K4b in f32 or bf16 I/O; K4-bf16, K4h and K4b are one
# template
_KERNELS = {("highest", False): ("fused_attention", "nomad_fused_qkv_attention_fwd"),
            ("highest", True): ("fused_attention_bf16", "nomad_fused_qkv_attention_highest_fwd"),
            ("high", False): ("fused_attention_bf16", "nomad_fused_qkv_attention_high3_fwd"),
            ("high", True): ("fused_attention_bf16", "nomad_fused_qkv_attention_high3_fwd"),
            ("default", False): ("fused_attention_bf16", "nomad_fused_qkv_attention_bf16_fwd"),
            ("default", True): ("fused_attention_bf16", "nomad_fused_qkv_attention_bf16_fwd")}


def _lib(precision: str = "highest", bf16_x: bool = False):
    source, entry = _KERNELS[precision, bf16_x]
    lib = _build.load(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # K4-bf16, K4b and K4h also take the buffers of their packed
        # weights and rounded x, their threads a block and x's type
        tc = source == "fused_attention_bf16"
        fn.argtypes = [p] * (11 if tc else 9) + [i] * 4 + [ll] * 3 + [ctypes.c_float] + (
            [i] * (6 if tc else 4) + [p])
        fn.restype = ctypes.c_int
        occ = getattr(lib, f"{entry}_occupancy")
        occ.argtypes = [i] * (2 if tc else 1) + [ctypes.POINTER(i), ctypes.POINTER(i)]
        occ.restype = ctypes.c_int
    return lib


def fused_occupancy(t: int, precision: str = "highest", bf16_io: bool = False) -> tuple:
    """(blocks of ``precision``'s kernel, K4 (K4-bf16 with ``bf16_io``),
    K4h or K4b (their bf16-I/O flavours with ``bf16_io``), resident on one
    SM, clusters resident on the card) for the cluster size of T frames (the
    card)."""
    lib = _lib(precision, bf16_io)
    source, entry = _KERNELS[precision, bf16_io]
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    io = (int(bf16_io),) if source == "fused_attention_bf16" else ()
    err = getattr(lib, f"{entry}_occupancy")(
        fused_launch_plan(t, 1, 1, precision, bf16_io).cluster, *io, ctypes.byref(blocks),
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


def pack_weights_ref(wq, wk, wv, heads: int, planes: int = 1) -> torch.Tensor:
    """The plain version of K4b's prologue: the q/k/v weights ([out, in])
    rounded to bf16 and packed head-major, [H * 3 * hd, D], rows 3 hd h ..
    3 hd h + hd - 1 head h's rows of wq, then of wk, then of wv: the JAX
    package's ``per_head_w`` ([H, D, hd] of the [in, out] weights), each
    head's slice transposed, stacked over the three. ``planes`` 2: K4h's,
    the hi plane, then the lo plane (``precision.split_bf16``), [2 H * 3
    hd, D]. ``planes`` 3: K4-bf16's, the weights times
    ``precision.SPLIT3_SCALE`` split into their hi, mid and lo planes
    (``precision.split3_bf16``, whose sum is the scaled weight exactly),
    [3 H * 3 hd, D]."""
    dm = wq.shape[1]
    hd = dm // heads
    w = torch.stack([w.view(heads, hd, dm) for w in (wq, wk, wv)], dim=1).reshape(
        heads * 3 * hd, dm)
    if planes == 3:
        return torch.cat(prec_ops.split3_bf16(w * prec_ops.SPLIT3_SCALE)).to(torch.bfloat16)
    if planes == 2:
        return torch.cat(prec_ops.split_bf16(w)).to(torch.bfloat16)
    return w.to(torch.bfloat16)


def _bf16_workspace(x, heads, planes: int = 1):
    """K4b's (``planes`` 1), K4h's (2) or K4-bf16's (3) buffers, written by
    its prologue: the packed weights (``pack_weights_ref``'s layout, the
    planes one after the other) and, for an f32 x, x rounded to bf16 (K4h:
    [2, B, T, D], its hi and its lo plane; None for a bf16 x, which the
    kernel reads as it is)."""
    b, t, dm = x.shape
    wp = torch.empty((planes * heads * _BF16_HEAD_ROWS, dm), dtype=torch.bfloat16,
                     device=x.device)
    xr = None if x.dtype == torch.bfloat16 else torch.empty(
        (planes * b, t, dm), dtype=torch.bfloat16, device=x.device)
    return wp, xr


def _planes(precision, bf16_x: bool) -> int:
    """The bf16 planes of the packed weights of ``precision``'s kernel on a
    bf16 (``bf16_x``) or f32 x: K4b 1, K4h 2, K4-bf16 3; 0 for K4, which
    packs nothing."""
    if precision == "highest":
        return 3 if bf16_x else 0
    return _HIGH3_PLANES if precision == "high" else 1


def _launch(precision, x, wq, bq, wk, bk, wv, bv, lengths, heads, workspace=None):
    """``precision``'s kernel on x's type, K4 or K4-bf16, K4h or K4b (its
    bf16-I/O flavour on a bf16 x) on inputs that pass ``_check_inputs``: O
    [B, T, H, hd] in x's dtype, written through its strides and handed out
    head-major as a view, so the out-projection reads it as [B, T, D] with
    no copy. K4-bf16, K4b and K4h write their prologue's buffers into
    ``workspace`` (``_bf16_workspace``) when it is given."""
    params = {"wq": wq, "bq": bq, "wk": wk, "bk": bk, "wv": wv, "bv": bv}
    _check_inputs(x, params, lengths, heads)
    b, t, dm = x.shape
    bf16_x = x.dtype == torch.bfloat16
    o = torch.empty((b, t, heads, HEAD_DIM), dtype=x.dtype, device=x.device)
    if o.numel() == 0:
        return o.transpose(1, 2)
    lengths = lengths.contiguous()
    plan = fused_launch_plan(t, b, heads, precision, bf16_x)
    buffers, tail = (), ()
    planes = _planes(precision, bf16_x)
    if planes:
        workspace = workspace or _bf16_workspace(x, heads, planes)
        buffers = tuple(0 if a is None else a.data_ptr() for a in workspace)
    lib = _lib(precision, bf16_x)
    source, entry = _KERNELS[precision, bf16_x]
    if source == "fused_attention_bf16":
        tail = (plan.threads, plan.smem_bytes, int(bf16_x))
    else:
        tail = (plan.smem_bytes,)
    err = getattr(lib, entry)(
        x.data_ptr(), *(a.data_ptr() for a in params.values()), lengths.data_ptr(),
        o.data_ptr(), *buffers, b, t, heads, dm, *o.stride()[:3], 1.0 / HEAD_DIM**0.5,
        plan.cluster, plan.rows_per_block, plan.tensors_per_block, *tail,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, f"fused attention kernel launch at {precision!r}")
    return o.transpose(1, 2)


# each kernel's launch counters: (f32 x, bf16 x); "highest" on a bf16 x is
# K4-bf16
_COUNTERS = {"highest": ("launches", "launches_f32_bf16_io"),
             "high": ("launches_high3", "launches_high3_bf16_io"),
             "default": ("launches_bf16", "launches_bf16_io")}


def _run_kernel(precision, x, wq, bq, wk, bk, wv, bv, lengths, heads):
    """``_launch`` of ``precision``'s kernel, counted by its flavour's
    counter: K4 ("highest" on an f32 x, f32 FMA), K4-bf16 ("highest" on a
    bf16 x: its prologue splits the weights into three planes, the products
    on the tensor cores), K4h ("high", the TPU kernel's "high3" on the
    tensor cores, its prologue splitting the weights and an f32 x) or K4b
    ("default", its prologue rounding them); on a bf16 x K4h's and K4b's
    bf16-I/O flavours."""
    o = _launch(precision, x, wq, bq, wk, bk, wv, bv, lengths, heads)
    counter = _COUNTERS[precision][int(x.dtype == torch.bfloat16)]
    globals()[counter] += 1
    return o


def fused_qkv_mha(x, wq, bq, wk, bk, wv, bv, lengths, heads, precision="highest"):
    """Projections + attention of x [B, T, D] (f32 or bf16; f32 weights)
    with lengths int32 [B] valid keys per batch row -> O head-major [B, H,
    T, hd] in x's dtype. On CUDA tensors K4 ("highest"), K4h ("high") or
    K4b ("default"), on CPU tensors the plain version of the same
    precision."""
    if x.device.type == "cpu":
        return fused_qkv_attention_ref(x, wq, bq, wk, bk, wv, bv, lengths, heads, precision)
    if x.device.type != "cuda":
        raise ValueError(f"fused kernel runs on CUDA tensors, got {x.device}")
    prec_ops.check(precision)
    return _run_kernel(precision, x, wq, bq, wk, bk, wv, bv, lengths, heads)


class FusedQKVAttention(torch.autograd.Function):
    """``FusedQKVAttention.apply(x, wq, bq, wk, bk, wv, bv, lengths, heads,
    precision="highest")`` -> O head-major [B, H, T, hd], differentiable in
    x and the projections (lengths, heads and precision get no gradient):
    ``fused_qkv_mha`` forward (K4, K4h at "high", K4b at "default", on the
    card), the vjp of the unfused composition at the same precision backward
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
    q/k/v projections and masked softmax attention in K4, K4h at "high" or
    K4b at "default" (``FusedQKVAttention``), then the out-projection (``_linear``)
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
