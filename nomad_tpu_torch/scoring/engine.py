"""Batched, length-bucketed embedding engine (counterpart of
``nomad_tpu.scoring.engine``).

  * Files are decoded on the host (thread pool, numpy), sorted by length
    and grouped into quantized length buckets (``bucket_length``). Each
    bucket runs as [B, T] batches sized by a sample budget
    (``batch_size_for``); per-item lengths drive the model's exact masking,
    so padded batched embeddings equal unpadded batch-1 ones.
  * A short final batch is padded by repeating its last row, and the extra
    rows are dropped: a few batch shapes, exact results.
  * PCM16 batches ship as int16 from pinned host memory (half the bytes of
    f32) with ``non_blocking`` copies, and are dequantized /32768 on the
    device, exactly. Embeddings stay on the device: ``embed_waves_device``
    returns them there, so the scorer's ``cdist`` runs on the device and
    one device-to-host copy per pass brings back the distance matrix.

The JAX engine's relay machinery (transfer-mode probes, the wire codec,
AOT prewarm, padding to compiled shapes) answers a TPU host link and
XLA's compile-per-shape; PyTorch runs eagerly on a local card, so none of
it is carried over.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from ..io import load_for_scoring
from ..models.heads import NomadModel
from ..models.wav2vec2 import feature_frame_lengths

MIN_BUCKET = 4096  # samples (~0.26 s); below this, padding waste is noise
# ~96 files x 10 s per batch: the JAX package's steady batch for the 10 s
# bucket (163,840 padded samples), kept so both packages batch alike
DEFAULT_BATCH_SAMPLE_BUDGET = 96 * 163_840
MAX_BATCH = 256
PCM16_SCALE = 32768.0
IO_THREADS = 16  # host decode threads
# The plain attention path ('ref') holds three [B, H, T', T'] f32 buffers
# per block at once (scores, masked scores, softmax weights). Capped at
# 20 GB of an 80 GB card: the conv frontend's largest activations at the
# sample budget take ~13 GB, the weights 0.4 GB. The kernel paths ('kernel',
# 'fused_qkv') hold no [T', T'] buffer and are not capped.
REF_ATTN_SCORE_BYTES_BUDGET = 20 << 30


def bucket_length(
    n: int, min_bucket: int = MIN_BUCKET, steps_per_octave: int = 4
) -> int:
    """Quantized pad target: multiples of (nearest lower power of two /
    steps_per_octave); <= 1/steps_per_octave padding waste."""
    if n <= min_bucket:
        return min_bucket
    p = 1 << ((n - 1).bit_length() - 1)  # largest power of two < n
    step = max(min_bucket, p // steps_per_octave)
    return ((n + step - 1) // step) * step


def wave_i16able(w: np.ndarray) -> bool:
    """True when the waveform rides the int16 path exactly: int16 already,
    or float32 with every sample on the 1/32768 grid."""
    if w.dtype == np.int16:
        return True
    if w.dtype != np.float32 or len(w) == 0:
        return w.dtype == np.float32
    scaled = w * PCM16_SCALE
    rounded = np.rint(scaled)
    return bool(
        np.array_equal(scaled, rounded)
        and rounded.min() >= -32768
        and rounded.max() <= 32767
    )


class EmbeddingEngine:
    def __init__(
        self,
        model: NomadModel,
        device: torch.device,
        batch_sample_budget: int = DEFAULT_BATCH_SAMPLE_BUDGET,
        method: str = "forward",
    ):
        """``method``: the model method that embeds a batch, ``forward``
        (the NOMAD embedding) or ``forward_features`` (the raw pooled
        features of the ``eval_w2v`` ablation)."""
        if method not in ("forward", "forward_features"):
            raise ValueError(f"method must be 'forward' or 'forward_features', got {method!r}")
        self.model = model
        self.device = torch.device(device)
        self.batch_sample_budget = batch_sample_budget
        self.method = method
        self.batches = 0  # forward passes run, for launch-count checks

    def _attn_batch_cap(self, length: int) -> int:
        """Largest batch whose plain-path attention buffers fit the budget
        (quadratic in frames); the kernel paths are capped by samples only."""
        cfg = self.model.config
        if cfg.attention_impl in ("kernel", "fused_qkv"):
            return MAX_BATCH
        frames = max(int(feature_frame_lengths(length, cfg)), 1)
        per_item = 3 * cfg.num_heads * frames * frames * 4
        return max(1, REF_ATTN_SCORE_BYTES_BUDGET // per_item)

    def batch_size_for(self, length: int, remaining: Optional[int] = None) -> int:
        b = max(1, self.batch_sample_budget // max(length, 1))
        b = min(b, MAX_BATCH, self._attn_batch_cap(length))
        # snap down to a multiple of 32 (powers of two below that)
        if b >= 32:
            b = (b // 32) * 32
        else:
            b = 1 << int(math.floor(math.log2(b)))
        if remaining is not None and remaining < b:
            # tail batch: smallest grid size covering the remainder
            if remaining > 32:
                b = ((remaining + 31) // 32) * 32
            else:
                b = 1 << max(0, (remaining - 1)).bit_length()
        return b

    def _chunk_batches(self, n_items: int, blen: int) -> list:
        """Padded batch sizes for a bucket of n_items files: full batches,
        then one right-sized tail."""
        full = self.batch_size_for(blen)
        sizes = []
        left = n_items
        while left > 0:
            b = min(self.batch_size_for(blen, remaining=left), full)
            sizes.append(b)
            left -= min(b, left)
        return sizes

    def plan(self, lengths: Sequence[int]) -> list:
        """[(indices, padded batch size, bucket length)] in run order:
        buckets shortest first, files sorted by length inside them."""
        order = sorted(range(len(lengths)), key=lambda i: lengths[i])
        groups: dict[int, list[int]] = {}
        for i in order:
            groups.setdefault(bucket_length(lengths[i]), []).append(i)
        chunks = []
        for blen, idxs in sorted(groups.items()):
            start = 0
            for bsz in self._chunk_batches(len(idxs), blen):
                take = min(bsz, len(idxs) - start)
                chunks.append((idxs[start : start + take], bsz, blen))
                start += take
        return chunks

    def _assemble(self, waves, i16able, chunk, bsz, blen):
        """Padded host batch (pinned when the device is CUDA) + lengths;
        pad rows repeat the last file."""
        is_i16 = all(i16able[i] for i in chunk)
        dtype = torch.int16 if is_i16 else torch.float32
        host = torch.zeros(
            (bsz, blen), dtype=dtype, pin_memory=self.device.type == "cuda"
        )
        batch = host.numpy()
        lengths = np.empty((bsz,), np.int64)
        for row, i in enumerate(chunk):
            w = waves[i]
            if is_i16 and w.dtype != np.int16:
                w = np.rint(w * PCM16_SCALE).astype(np.int16)
            elif not is_i16 and w.dtype == np.int16:
                w = w.astype(np.float32) / PCM16_SCALE
            batch[row, : len(w)] = w
            lengths[row] = len(w)
        for row in range(len(chunk), bsz):
            batch[row] = batch[len(chunk) - 1]
            lengths[row] = lengths[len(chunk) - 1]
        return host, torch.from_numpy(lengths)

    def embed_waves_device(self, waves: Sequence[np.ndarray]) -> torch.Tensor:
        """Embed 1-D waveforms (int16 or float32) -> [N, emb_dim] f32 on the
        device, in input order."""
        n = len(waves)
        embed = getattr(self.model, self.method)
        if n == 0:
            width = (self.model.emb_dim if self.method == "forward"
                     else self.model.config.hidden_size)
            return torch.zeros((0, width), device=self.device)
        chunks = self.plan([len(w) for w in waves])
        with ThreadPoolExecutor(max_workers=8) as ex:
            i16able = list(ex.map(wave_i16able, waves))
        outs = []
        with ThreadPoolExecutor(max_workers=min(8, len(chunks))) as ex, torch.inference_mode():
            futures = [
                ex.submit(self._assemble, waves, i16able, *job) for job in chunks
            ]
            for (chunk, _bsz, _blen), fut in zip(chunks, futures):
                host, lengths = fut.result()
                wav = host.to(self.device, non_blocking=True)
                if wav.dtype == torch.int16:
                    wav = wav.to(torch.float32) / PCM16_SCALE
                emb = embed(wav, lengths.to(self.device))
                self.batches += 1
                outs.append(emb[: len(chunk)])
            perm = torch.tensor([i for c, _, _ in chunks for i in c], device=self.device)
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(n, device=self.device)
            return torch.cat(outs).index_select(0, inv)

    def embed_waves(self, waves: Sequence[np.ndarray]) -> np.ndarray:
        return self.embed_waves_device(waves).cpu().numpy()

    def load_waves(self, paths: Sequence[str]):
        with ThreadPoolExecutor(max_workers=IO_THREADS) as ex:
            return list(ex.map(load_for_scoring, paths))

    def embed_files_device(self, paths: Sequence[str]) -> torch.Tensor:
        return self.embed_waves_device(self.load_waves(paths))

    def embed_files(self, paths: Sequence[str]) -> np.ndarray:
        return self.embed_files_device(paths).cpu().numpy()


def list_dir_files(path: str) -> list[str]:
    """Quirk Q3: dir mode follows os.listdir order."""
    return [os.path.join(path, x) for x in os.listdir(path)]
