"""Lossless int16 wire codec (counterpart of ``nomad_tpu.ops.wirecodec``):
delta + zigzag + per-block bit-plane packing, encoded on the host, decoded
on the device.

The format, bit for bit the JAX package's:
  * a [B, T] int16 batch (T a multiple of S = 1,024) is split into
    1,024-sample blocks;
  * per block the first sample is stored raw (``firsts``), the first
    differences are zigzag-mapped to unsigned values below 2^17, and the
    block's largest value sets its bit width w in [0, 17] (``widths``);
  * the values are stored bit-plane-wise per 32-sample group: word (g, k)
    holds bit k of group g's 32 values (bit j = sample j), w words a group,
    32 groups a block, word-aligned per block (``offsets``);
  * the stream is padded to a quantized bucket of words (``_pack_bucket``)
    and, for one copy to the device, framed with the int32 side arrays as
    tail rows (``combined_rows``).

``encode`` packs with the C++ packer (``io.native.native_pack_i16``) and
falls back to numpy (``_encode_core``); ``decode_numpy`` is the host's
reference decoder. ``decode`` and ``decode_combined`` decode on whatever
device their tensors lie, in PyTorch ops: one gather of the plane words,
17 shift-and-mask passes, un-zigzag, a cumulative sum along each block.
Torch has no uint32 shifts, masks or sums, so the device side works on the
frame's bits viewed as int32: an arithmetic ``>> j`` followed by ``& 1``
still extracts bit j, bit 31 included, and the sums stay in the int16
range. The JAX module's AOT and prewarm machinery (``_decode_aot``,
``prewarm_decode_combined*``, ``decode_combined_ready``, its atexit join)
exists to avoid XLA compiles per frame shape, and PyTorch runs eagerly, so
it has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.native import native_pack_i16

S = 1024  # samples per block (engine bucket lengths are multiples of 4096)
MAX_W = 17  # zigzag of int16 first differences needs at most 17 bits
MIN_PACK_WORDS = 1 << 12  # 16 KB floor for the padded packed stream


def _pack_bucket(n: int) -> int:
    """Quantized packed-stream length: 1/16-octave steps above a 16 KB
    floor, so at most 6.25 % of padding."""
    if n <= MIN_PACK_WORDS:
        return MIN_PACK_WORDS
    p = 1 << ((n - 1).bit_length() - 1)
    step = max(MIN_PACK_WORDS, p // 16)
    return ((n + step - 1) // step) * step


def encode(batch: np.ndarray, pool=None, chunks: int = 8):
    """Pack a [B, T] int16 array (T % S == 0).

    Returns dict(packed u32[Wp], widths i32[NB], offsets i32[NB],
    firsts i32[NB], shape (B, T), nbytes int), or None when the input does
    not qualify (dtype, rank, length). Without the C++ packer, ``pool`` (a
    ThreadPoolExecutor) splits the rows over threads and merges the
    chunks' streams with shifted offsets."""
    if batch.dtype != np.int16 or batch.ndim != 2 or batch.shape[1] % S:
        return None
    b, t = batch.shape
    nat = native_pack_i16(batch)
    if nat is not None:
        packed, widths, offsets, firsts = nat
        return _finalize(packed, widths, offsets.astype(np.int64), firsts, b, t)
    if pool is not None and b >= 2 * chunks:
        parts = list(pool.map(_encode_core, np.array_split(batch, chunks, axis=0)))
        base = 0
        packed_parts, widths_p, offsets_p, firsts_p = [], [], [], []
        for packed_c, widths_c, offsets_c, firsts_c in parts:
            packed_parts.append(packed_c)
            widths_p.append(widths_c)
            offsets_p.append(offsets_c + base)
            firsts_p.append(firsts_c)
            base += len(packed_c)
        return _finalize(np.concatenate(packed_parts), np.concatenate(widths_p),
                         np.concatenate(offsets_p), np.concatenate(firsts_p), b, t)
    return _finalize(*_encode_core(batch), b, t)


def _finalize(packed, widths, offsets, firsts, b, t):
    # +1 guard word (the decoder's gather of a block's last plane words may
    # read one past the stream), then pad to the quantized bucket
    wp = _pack_bucket(len(packed) + 1)
    packed = np.pad(packed, (0, wp - len(packed)))
    meta_bytes = widths.nbytes + 4 * len(offsets) + firsts.nbytes
    return {
        "packed": packed,
        "widths": widths,
        "offsets": offsets.astype(np.int32),
        "firsts": firsts,
        "shape": (b, t),
        "nbytes": packed.nbytes + meta_bytes,
    }


def _encode_core(batch: np.ndarray):
    """Pack rows into an exact-length word stream; returns (packed
    u32[total], widths, offsets i64, firsts)."""
    b, t = batch.shape
    nb = t // S
    x = batch.astype(np.int32).reshape(b * nb, S)
    d = np.empty_like(x)
    d[:, 0] = 0
    d[:, 1:] = x[:, 1:] - x[:, :-1]
    z = ((d << 1) ^ (d >> 31)).astype(np.uint32)  # zigzag, < 2^17
    mx = z.max(axis=1)
    widths = np.zeros(b * nb, np.int32)  # bit_length(mx)
    nz = mx > 0
    widths[nz] = np.floor(np.log2(mx[nz].astype(np.float64))).astype(np.int32) + 1
    nwords = (widths.astype(np.int64) * S + 31) // 32
    offsets = np.zeros(b * nb, np.int64)
    offsets[1:] = np.cumsum(nwords)[:-1]
    total = int(offsets[-1] + nwords[-1]) if b * nb else 0

    packed = np.zeros(total, np.uint32)
    # bit-plane transpose per 32-sample group, blocks grouped by width
    pos = np.arange(32, dtype=np.uint32)[None, None, :]
    for w in np.unique(widths):
        if w == 0:
            continue
        w = int(w)
        sel = np.flatnonzero(widths == w)
        m = len(sel)
        zz = z[sel].reshape(m, S // 32, 32)
        words = np.empty((m, S // 32, w), np.uint32)
        for k in range(w):
            words[:, :, k] = (((zz >> np.uint32(k)) & np.uint32(1)) << pos
                              ).sum(axis=-1, dtype=np.uint32)
        nw = S // 32 * w
        idx = offsets[sel][:, None] + np.arange(nw)[None, :]
        packed[idx.ravel()] = words.reshape(m, nw).ravel()
    return packed, widths, offsets, x[:, 0].copy()


def meta_rows(b: int, t: int) -> int:
    """Rows of MIN_PACK_WORDS words the [3, NB] side arrays take in a
    combined frame (fixed by the batch shape)."""
    return -(-(3 * b * (t // S)) // MIN_PACK_WORDS)


def pack_meta(enc: dict) -> np.ndarray:
    """[3, NB] int32: widths, offsets, firsts."""
    return np.stack([enc["widths"], enc["offsets"], enc["firsts"]])


def combined_rows(enc: dict) -> np.ndarray:
    """The one-copy frame: the bucket-padded stream as [Rp, MIN_PACK_WORDS]
    uint32 rows, then the int32 side arrays' bits as ``meta_rows`` tail
    rows (zero-padded). The decoder slices the tail back out by the batch
    shape."""
    b, t = enc["shape"]
    rows = enc["packed"].reshape(-1, MIN_PACK_WORDS)
    m = pack_meta(enc).astype(np.int32).view(np.uint32).ravel()
    mr = meta_rows(b, t)
    tail = np.zeros(mr * MIN_PACK_WORDS, np.uint32)
    tail[: len(m)] = m
    return np.concatenate([rows, tail.reshape(mr, MIN_PACK_WORDS)], axis=0)


def decode_combined(frame: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """A combined frame (``combined_rows``' bits as an int32 tensor, any
    shape) -> the [b, t] int16 batch on the frame's device."""
    flat = frame.reshape(-1)
    nb_meta = 3 * b * (t // S)
    split = flat.shape[0] - meta_rows(b, t) * MIN_PACK_WORDS
    return decode(flat[:split], flat[split:split + nb_meta].view(3, b * (t // S)), b, t)


def decode(packed: torch.Tensor, meta: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """The packed stream (int32 bits, 1-D) and its [3, NB] int32 side
    arrays -> the [b, t] int16 batch, on their device."""
    dev = packed.device
    widths, offsets, firsts = meta[0], meta[1], meta[2]
    nb = t // S
    w = widths[:, None, None]  # [NB, 1, 1]
    g = torch.arange(S // 32, dtype=torch.int32, device=dev)[None, :, None]  # groups
    k = torch.arange(MAX_W, dtype=torch.int32, device=dev)[None, None, :]  # planes
    # plane word (g, k) of block n lies at offsets[n] + g*w + k; for k >= w
    # the index reads past the block (clamped here, masked below)
    wi = offsets[:, None, None] + g * w + k
    words = packed[wi.clamp(0, packed.shape[0] - 1).long()]  # [NB, G, MAX_W]
    words = torch.where(k < w, words, 0)
    # sample j of each group from its 17 plane bits
    j = torch.arange(32, dtype=torch.int32, device=dev)[None, None, :]
    v = torch.zeros((b * nb, S // 32, 32), dtype=torch.int32, device=dev)
    for kk in range(MAX_W):
        v |= ((words[:, :, kk, None] >> j) & 1) << kk
    v = v.reshape(b * nb, S)
    d = (v >> 1) ^ -(v & 1)  # un-zigzag
    x = firsts[:, None] + torch.cumsum(d, dim=1)  # int64: bounded by the int16 range
    return x.reshape(b, t).to(torch.int16)


def decode_numpy(enc: dict) -> np.ndarray:
    """The host's reference decoder."""
    b, t = enc["shape"]
    nb = t // S
    widths = enc["widths"].astype(np.int64)
    offsets = enc["offsets"].astype(np.int64)
    packed = enc["packed"]
    g = np.arange(S // 32, dtype=np.int64)[None, :, None]
    k = np.arange(MAX_W, dtype=np.int64)[None, None, :]
    wi = offsets[:, None, None] + g * widths[:, None, None] + k
    words = packed[np.clip(wi, 0, len(packed) - 1)]
    words = np.where(k < widths[:, None, None], words, np.uint32(0))
    j = np.arange(32, dtype=np.uint32)[None, None, :]
    v = np.zeros((b * nb, S // 32, 32), np.uint32)
    for kk in range(MAX_W):
        bit = (words[:, :, kk][:, :, None] >> j) & np.uint32(1)
        v |= bit << np.uint32(kk)
    v = v.reshape(b * nb, S)
    d = (v >> 1).astype(np.int32) ^ (-(v & 1).astype(np.int32))
    out = enc["firsts"].astype(np.int32)[:, None] + np.cumsum(d, axis=1)
    return out.reshape(b, t).astype(np.int16)
