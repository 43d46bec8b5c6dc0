"""Batched embedding engine, its batches planned around the files' own
lengths (counterpart of ``nomad_tpu.scoring.engine``).

  * Files are sorted by length and cut into [B, T] batches of consecutive
    files (``plan``): each batch is as long as its longest file rounded up
    to ``MIN_BUCKET`` samples and holds its own files, within a sample
    budget; the cuts minimise the padded samples plus a fixed cost a batch
    (``BATCH_COST_SAMPLES``). The JAX engine quantizes lengths to buckets
    and batch sizes to a grid because XLA compiles each new shape; PyTorch
    compiles nothing per shape, so the port plans by lengths. Per-item
    lengths drive the model's exact masking, so padded batched embeddings
    equal unpadded batch-1 ones.
  * PCM16 batches ship as int16 from pinned host memory (half the bytes of
    f32) with ``non_blocking`` copies, and are dequantized /32768 on the
    device, exactly. Embeddings stay on the device: ``embed_waves_device``
    returns them there, so the scorer's ``cdist`` runs on the device and
    one device-to-host copy per pass brings back the distance matrix.
  * Files: when the native C++ ingest library builds (``io.native``), a
    batch's files are decoded, folded, resampled and padded by its thread
    pool straight into the pinned host batch; mono PCM16 files at 16 kHz
    ride its int16 loader. Any other batch (resampled, stereo, float or
    FLAC files) is quantized to the PCM16 grid in C++ and rides int16 too
    (``quantize_transfer``, on by default as in the JAX package: at most
    1/65,536 per sample from the float samples; False keeps them f32).
    Otherwise (or for a file it cannot probe) the Python decoder runs,
    with the same samples. ``trim`` keeps a file's first 10 s.
  * ``file_cache`` (an :class:`EmbeddingLRU`, or None for off): an
    unchanged file (same path, trim, mtime and size) reuses its embedding,
    a 1 KB row kept on the device, so a hit costs no decode, no copy to the
    device and no forward.
  * ``wire_codec`` ("auto", "on", "off"): the lossless int16 wire codec
    (``ops/wirecodec.py``). "auto" is off here: the JAX package turns it
    on on a TPU only. With "on", an int16 batch of at least
    ``parallel_put_min_bytes`` is packed on the host where it is
    assembled, its one frame copied from pinned memory and decoded on the
    device ahead of the forward, which sees the same int16 batch; a frame
    over ``wire_codec_max_ratio`` of the raw bytes ships raw and counts as
    a skip. Refused under a mesh.
  * ``serialize_pipeline``: wait for each batch's embeddings before the
    next batch is copied (the reference's serial loop, to time the
    overlap against).
  * ``mesh`` (a ``parallel.data_mesh``): data parallelism over the ranks
    of a process group, as the JAX engine shards its batches over the
    "data" axis. Every rank makes the same ``embed_*`` call on the same
    inputs (SPMD) and plans the same batches, each rounded up to a
    multiple of the world size n by pad rows that repeat its last file
    (dropped from the result). A rank decodes, copies and
    embeds only its b/n rows of each batch; one ``all_gather`` at the end
    of the call gives every rank the whole [N, emb] in input order. The
    engine runs on the rank's device (``cuda:<local rank>`` or the CPU);
    a ``device`` that disagrees raises. ``file_cache`` is refused under a
    mesh: a rank's hits and misses would follow its own cache, so the
    ranks would plan different batches and their collectives would not
    meet.

Members of the JAX engine that stay unported, each an answer to a TPU
host link or to XLA's compile per shape: the transfer-mode probes,
parallel puts and their throttle (``_probe_put``, ``_put_large``,
``probe_interval``); the relay's warm-up and the codec's race
(``warm_wire_*``, ``_measure_rtt``, ``_probe_codec``); the AOT
executables (``_aot``, ``_prewarm_keys``); ``pad_to_compiled``. PyTorch
runs eagerly, and the H100's host link moves a [96, 163,840] int16 batch
in a small fraction of the forward (``PERF.md``, phase 16 of
``chip_smoke.py``). ``prewarm`` stands in for the compile ladder.
"""

from __future__ import annotations

import math
import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from ..io import TARGET_SR, load_for_scoring, load_processing, native, sinc_resample_kernel
from ..models.heads import NomadModel
from ..models.wav2vec2 import feature_frame_lengths
from ..ops import wirecodec
from ..parallel.mesh import device_for, gather_rows
from ..utils.profiling import GLOBAL, timed

MIN_BUCKET = 4096  # samples (~0.26 s); below this, padding waste is noise
# The JAX package's steady batch, ~96 files x 10 s (163,840 padded samples):
# the most samples a batch holds, which bounds the activations' memory
DEFAULT_BATCH_SAMPLE_BUDGET = 96 * 163_840
# A batch's fixed device time in padded samples: the plan's cost of one more
# batch. On an H100 (700 W, f32 "exact" BASE), a batch's device time (196
# batches of one directory-scoring run, [1..96] x [24,576..393,216] samples)
# fits 4.21 ms + 29.21 ms per million samples (R^2 0.967): 4.21 / 29.21e-6 =
# 144,193 samples, rounded. From 50,000 to 800,000 the plan sends 1.02-1.06
# samples a real one on that run's files.
BATCH_COST_SAMPLES = 150_000
MAX_BATCH = 256
PCM16_SCALE = 32768.0
IO_THREADS = 16  # host decode threads
# The plain attention path ('ref') holds three [B, H, T', T'] f32 buffers
# per block at once (scores, masked scores, softmax weights). Capped at
# 20 GB of an 80 GB card: the conv frontend's largest activations at the
# sample budget take ~13 GB, the weights 0.4 GB. The kernel paths ('kernel',
# 'fused_qkv') hold no [T', T'] buffer and are not capped.
REF_ATTN_SCORE_BYTES_BUDGET = 20 << 30
PREWARM_TAILS = (1, 8, 32)  # tail batch sizes prewarm runs besides each full batch
TRIM_SEC = 10  # ``trim``: a file's first 10 s
WIRE_CODEC_MODES = ("auto", "on", "off")


class EmbeddingLRU:
    """Bounded embedding cache for long-lived servers (the dict protocol
    subset the engine uses), as ``nomad_tpu.scoring.engine.EmbeddingLRU``:
    evicts least-recently-used entries beyond ``maxsize``, and drops the
    stale entry of a path the moment a key with a new mtime/size replaces
    it. Keys are ``EmbeddingEngine._cache_key`` tuples, whose first item
    names the file (its path and trim)."""

    def __init__(self, maxsize: int = 65536):
        self.maxsize = int(maxsize)
        self._d: OrderedDict = OrderedDict()
        self._by_path: dict = {}  # a key's file -> its current key
        self.evictions = 0
        self.stale_evictions = 0

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def __getitem__(self, key):
        self._d.move_to_end(key)
        return self._d[key]

    def __setitem__(self, key, value) -> None:
        old = self._by_path.get(key[0])
        if old is not None and old != key and old in self._d:
            del self._d[old]
            self.stale_evictions += 1
        self._by_path[key[0]] = key
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            victim, _ = self._d.popitem(last=False)
            self._by_path.pop(victim[0], None)
            self.evictions += 1

    def stats(self) -> dict:
        return {"entries": len(self._d), "maxsize": self.maxsize,
                "evictions": self.evictions, "stale_evictions": self.stale_evictions}


def predicted_length(sr: int, frames: int) -> int:
    """Samples at 16 kHz of a file of ``frames`` samples at ``sr`` after
    resampling (torchaudio's ceil(new * n / orig)): the length a batch is
    planned for before it is decoded."""
    if sr == TARGET_SR:
        return frames
    _k, _w, orig_g, new_g = sinc_resample_kernel(sr, TARGET_SR)
    return int(math.ceil(new_g * frames / orig_g))


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
        device: Optional[torch.device] = None,
        batch_sample_budget: int = DEFAULT_BATCH_SAMPLE_BUDGET,
        method: str = "forward",
        mesh=None,
        quantize_transfer: bool = True,
        wire_codec: str = "auto",
        wire_codec_max_ratio: float = 0.95,
        parallel_put_min_bytes: int = 4 << 20,
        serialize_pipeline: bool = False,
    ):
        """``method``: the model method that embeds a batch, ``forward``
        (the NOMAD embedding) or ``forward_features`` (the raw pooled
        features of the ``eval_w2v`` ablation). ``file_cache`` starts off
        (None), as the reference recomputes every file; a server sets it.
        ``device`` may be None under a ``mesh``: the rank's device. The
        other arguments are the JAX engine's fields of the same names (the
        module docstring); ``parallel_put_min_bytes`` is only the wire
        codec's floor here."""
        if method not in ("forward", "forward_features"):
            raise ValueError(f"method must be 'forward' or 'forward_features', got {method!r}")
        if wire_codec not in WIRE_CODEC_MODES:
            raise ValueError(f"wire_codec must be one of {WIRE_CODEC_MODES}, got {wire_codec!r}")
        if wire_codec == "on" and mesh is not None:
            raise ValueError(
                "wire_codec='on' under a mesh: the codec packs whole batches on one device, "
                "where a mesh copies each rank's rows of a batch; use 'auto' or 'off'")
        self.model = model
        self.mesh = mesh
        # the batch plan reads only the world size: None without a mesh
        self.world: Optional[int] = None
        self.rank = 0
        if mesh is not None:
            if tuple(mesh.mesh_dim_names or ()) != ("data",):
                raise ValueError(f"the engine shards over a 1-D 'data' mesh, got axes "
                                 f"{mesh.mesh_dim_names}")
            device = device_for(mesh, device)
            self.world, self.rank = mesh.size(), mesh.get_local_rank("data")
        elif device is None:
            raise ValueError("EmbeddingEngine needs a device or a mesh")
        self.device = torch.device(device)
        self.batch_sample_budget = batch_sample_budget
        self.method = method
        self.quantize_transfer = quantize_transfer
        self.wire_codec = wire_codec
        self.wire_codec_max_ratio = wire_codec_max_ratio
        self.parallel_put_min_bytes = parallel_put_min_bytes
        self.serialize_pipeline = serialize_pipeline
        self.file_cache = None
        self.cache_hits = 0
        self.batches = 0  # forward passes run, for launch-count checks
        self.transfer = dict.fromkeys(
            ("h2d_bytes_int16", "h2d_bytes_f32", "h2d_bytes_packed", "native_batches",
             "python_batches", "codec_hits", "codec_skips", "codec_saved_bytes"), 0)
        self._skips_lock = threading.Lock()  # skips are counted on the assemble threads

    @property
    def file_cache(self) -> Optional[EmbeddingLRU]:
        return self._file_cache

    @file_cache.setter
    def file_cache(self, cache: Optional[EmbeddingLRU]) -> None:
        if cache is not None and self.mesh is not None:
            raise ValueError(
                "file_cache is single-process: under a mesh each rank's hits would follow its "
                "own cache, the ranks would plan different batches and their collectives would "
                "not meet")
        self._file_cache = cache

    def transfer_stats(self) -> dict:
        """Host-to-device bytes by kind (int16 and f32 batches, packed
        frames), batches by ingest path, and the wire codec's keys of the
        JAX engine: frames shipped, batches shipped raw instead, MB saved,
        and whether the codec is on."""
        t = dict(self.transfer)
        saved = t.pop("codec_saved_bytes")
        return {"batches": self.batches, **t, "codec_saved_MB": round(saved / 1e6, 1),
                "codec_in_use": self.wire_codec == "on"}

    def _attn_batch_cap(self, length: int) -> int:
        """Largest batch whose plain-path attention buffers fit the budget
        (quadratic in frames); the kernel paths are capped by samples only."""
        cfg = self.model.config
        if cfg.attention_impl in ("kernel", "fused_qkv"):
            return MAX_BATCH
        frames = max(int(feature_frame_lengths(length, cfg)), 1)
        per_item = 3 * cfg.num_heads * frames * frames * 4
        return max(1, REF_ATTN_SCORE_BYTES_BUDGET // per_item)

    def _row_cap(self, blen: int) -> int:
        """Most rows a batch of ``blen`` samples may hold: the sample budget,
        ``MAX_BATCH`` and the plain path's attention buffers; under a mesh a
        multiple of the world size, at least one row a rank."""
        b = max(1, self.batch_sample_budget // max(blen, 1))
        b = min(b, MAX_BATCH, self._attn_batch_cap(blen))
        if self.world is not None:
            b = max(self.world, (b // self.world) * self.world)
        return b

    def _padded_rows(self, rows: int) -> int:
        """A batch of ``rows`` files as sent: under a mesh, rounded up to a
        multiple of the world size."""
        return rows if self.world is None else rows + (-rows) % self.world

    def batch_size_for(self, length: int) -> int:
        """The full batch at ``length`` samples that ``prewarm`` warms, the
        JAX engine's: the row cap, snapped down to a multiple of 32 (powers
        of two below that) without a mesh."""
        b = self._row_cap(length)
        if self.world is not None:
            return b
        return (b // 32) * 32 if b >= 32 else 1 << (b.bit_length() - 1)

    def plan(self, lengths: Sequence[int], groups: Optional[Sequence] = None) -> list:
        """[(indices, padded batch size, batch length)] in run order,
        shortest batches first. The files, sorted by length (stably), are
        cut into batches of consecutive files (``_cuts``), each as long as
        its longest file rounded up to ``MIN_BUCKET``. With ``groups`` (one
        key per file), files of different keys never share a batch."""
        lengths = np.asarray(lengths, dtype=np.int64)
        members: dict = {}
        for i, key in enumerate(groups if groups is not None else [0] * len(lengths)):
            members.setdefault(key, []).append(i)
        chunks = []
        for key in sorted(members):
            idx = np.asarray(members[key])
            idx = idx[np.argsort(lengths[idx], kind="stable")]
            blens = np.maximum(-(-lengths[idx] // MIN_BUCKET), 1) * MIN_BUCKET
            for start, stop in self._cuts(blens):
                chunks.append((idx[start:stop].tolist(), self._padded_rows(stop - start),
                               int(blens[stop - 1])))
        chunks.sort(key=lambda c: c[2])  # stable: groups in key order at one length
        return chunks

    def _cuts(self, blens: np.ndarray) -> list:
        """(start, stop) of each batch over files sorted by length, whose
        lengths rounded up to the grid are ``blens``: the cuts that minimise
        the samples sent (padded rows x batch length) plus
        ``BATCH_COST_SAMPLES`` a batch, within each batch's row cap. A
        dynamic programme over the last file of a batch: the best plan up to
        file j is the best, over the batch's first file i within the cap,
        of the best plan up to i plus the batch i..j-1."""
        n = len(blens)
        caps = {b: self._row_cap(b) for b in np.unique(blens).tolist()}
        most = max(caps.values(), default=1)
        # rows sent by batches of most, most - 1, ..., 1 files: [most - r:] ends at r
        rows = np.array([self._padded_rows(r) for r in range(most, 0, -1)], dtype=np.int64)
        sent = {b: rows * b for b in caps}
        best = np.zeros(n + 1, dtype=np.int64)
        first = [0] * (n + 1)
        for j, b in enumerate(blens.tolist(), 1):
            lo = max(0, j - caps[b])
            cost = best[lo:j] + sent[b][most - (j - lo):]
            k = int(cost.argmin())
            best[j] = cost[k] + BATCH_COST_SAMPLES
            first[j] = lo + k
        cuts, j = [], n
        while j > 0:
            cuts.append((first[j], j))
            j = first[j]
        return cuts[::-1]

    def _rank_rows(self, chunk, bsz: int) -> list:
        """The files of this rank's rows of a padded batch of ``bsz``: the
        chunk itself without a mesh; under one, rank r's b/n rows of the
        chunk followed by pad rows that repeat its last file."""
        if self.world is None:
            return list(chunk)
        rows = list(chunk) + [chunk[-1]] * (bsz - len(chunk))
        s = bsz // self.world
        return rows[self.rank * s:(self.rank + 1) * s]

    def _host_batch(self, bsz: int, blen: int, dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """Empty host batch and lengths, pinned when the device is CUDA."""
        pin = self.device.type == "cuda"
        with timed("engine.host_batch"):
            return (torch.empty((bsz, blen), dtype=dtype, pin_memory=pin),
                    torch.empty((bsz,), dtype=torch.int64, pin_memory=pin))

    def _assemble(self, waves, i16able, chunk, bsz, blen):
        """Padded host batch (this rank's rows, ``_rank_rows``) + lengths
        from decoded waveforms."""
        is_i16 = all(i16able[i] for i in chunk)
        rows = self._rank_rows(chunk, bsz)
        host, lengths_t = self._host_batch(len(rows), blen,
                                           torch.int16 if is_i16 else torch.float32)
        batch, lengths = host.numpy(), lengths_t.numpy()
        batch.fill(0)
        for row, i in enumerate(rows):
            w = waves[i]
            if is_i16 and w.dtype != np.int16:
                w = np.rint(w * PCM16_SCALE).astype(np.int16)
            elif not is_i16 and w.dtype == np.int16:
                w = w.astype(np.float32) / PCM16_SCALE
            batch[row, : len(w)] = w
            lengths[row] = len(w)
        return host, lengths_t, self._encode_batch(host)

    def _encode_batch(self, host: torch.Tensor) -> Optional[torch.Tensor]:
        """The wire codec's frame of a host batch, its bits as int32 (pinned
        on CUDA), or None when the batch ships raw: the codec off, not
        int16, under ``parallel_put_min_bytes``, or a frame over
        ``wire_codec_max_ratio`` of the raw bytes (counted as a skip)."""
        batch = host.numpy()
        if (self.wire_codec != "on" or batch.dtype != np.int16
                or batch.nbytes < self.parallel_put_min_bytes):
            return None
        with timed("engine.encode", nbytes=batch.nbytes):
            enc = wirecodec.encode(batch)
            frame = None if enc is None else wirecodec.combined_rows(enc)
        if frame is None or frame.nbytes > self.wire_codec_max_ratio * batch.nbytes:
            with self._skips_lock:
                self.transfer["codec_skips"] += 1
            return None
        out = torch.empty(frame.shape, dtype=torch.int32, pin_memory=self.device.type == "cuda")
        out.numpy()[...] = frame.view(np.int32)
        return out

    def _submit(self, host: torch.Tensor, lengths: torch.Tensor, native_ingest: bool,
                frame: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Copy a host batch to the device, or its wire-codec ``frame`` and
        decode it there, and embed it: one embedding a row."""
        rows = host.shape[0]
        nbytes = host.numel() * host.element_size()
        sent = nbytes if frame is None else frame.numel() * frame.element_size()
        with timed("engine.submit", items=rows, nbytes=sent):
            stop = GLOBAL.device_timer(self.device)  # None unless profiling on CUDA
            if frame is None:
                wav = host.to(self.device, non_blocking=True)
            else:
                wav = wirecodec.decode_combined(frame.to(self.device, non_blocking=True),
                                                *host.shape)
            if wav.dtype == torch.int16:
                wav = wav.to(torch.float32) / PCM16_SCALE
            emb = getattr(self.model, self.method)(wav, lengths.to(self.device, non_blocking=True))
            if stop is not None:
                stop("engine.batch", rows=rows, bsz=rows, blen=host.shape[1],
                     samples=int(lengths.sum()))
        if self.serialize_pipeline and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.batches += 1
        if frame is None:
            self.transfer["h2d_bytes_int16" if host.dtype == torch.int16
                          else "h2d_bytes_f32"] += nbytes
        else:
            self.transfer["h2d_bytes_packed"] += sent
            self.transfer["codec_hits"] += 1
            self.transfer["codec_saved_bytes"] += nbytes - sent
        self.transfer["native_batches" if native_ingest else "python_batches"] += 1
        return emb

    def _collect(self, chunks, outs: list, n: int) -> torch.Tensor:
        """The batches' embeddings back in input order: one stack of row
        views queued on the device, with no index to copy over (a copy to
        the device would wait for the forward). The caller's copy to the
        host waits for the device. Under a mesh the ranks' rows are
        gathered first."""
        with timed("engine.collect", items=n):
            if self.mesh is not None:
                outs = self._gather(outs)
            rows = [None] * n
            for (chunk, _, _), emb in zip(chunks, outs):
                for i, row in zip(chunk, emb.unbind(0)):
                    rows[i] = row
            return torch.stack(rows)

    def _gather(self, outs: list) -> list:
        """Each batch's rows from every rank (pad rows last, which
        ``_collect`` drops): one ``all_gather`` of this rank's rows of all
        the batches over the mesh."""
        parts = gather_rows(torch.cat(outs), self.mesh).chunk(self.world)
        whole, start = [], 0
        for emb in outs:
            s = emb.shape[0]
            whole.append(torch.cat([p[start:start + s] for p in parts]))
            start += s
        return whole

    def _empty(self) -> torch.Tensor:
        width = self.model.emb_dim if self.method == "forward" else self.model.config.hidden_size
        return torch.zeros((0, width), device=self.device)

    def embed_waves_device(self, waves: Sequence[np.ndarray]) -> torch.Tensor:
        """Embed 1-D waveforms (int16 or float32) -> [N, emb_dim] f32 on the
        device, in input order."""
        n = len(waves)
        if n == 0:
            return self._empty()
        with timed("engine.plan", items=n):
            chunks = self.plan([len(w) for w in waves])
        with ThreadPoolExecutor(max_workers=8) as ex:
            i16able = list(ex.map(wave_i16able, waves))
        outs = []
        with ThreadPoolExecutor(max_workers=min(8, len(chunks))) as ex, torch.inference_mode():
            futures = [
                ex.submit(self._assemble, waves, i16able, *job) for job in chunks
            ]
            for fut in futures:
                host, lengths, frame = fut.result()
                outs.append(self._submit(host, lengths, native_ingest=False, frame=frame))
            return self._collect(chunks, outs, n)

    def embed_waves(self, waves: Sequence[np.ndarray]) -> np.ndarray:
        return self.embed_waves_device(waves).cpu().numpy()

    def load_waves(self, paths: Sequence[str], trim: bool = False):
        with ThreadPoolExecutor(max_workers=IO_THREADS) as ex:
            return list(ex.map(lambda p: load_for_scoring(p, trim=trim), paths))

    def prewarm(self, durations: Sequence[float] = (10.0,)) -> None:
        """Embed one zero batch at each duration's full batch shape and at
        tails of 1, 8 and 32 rows: loads the kernels (a kernel's first launch
        in a process waits for the device), settles cuDNN's plans and the
        allocator's pools before the first request. Counts no batch."""
        with torch.inference_mode():
            for sec in durations:
                blen = bucket_length(int(round(float(sec) * TARGET_SR)))
                full = self.batch_size_for(blen)
                for bsz in sorted({self._padded_rows(min(t, full)) for t in PREWARM_TAILS}
                                  | {full}):
                    bsz //= self.world or 1  # a rank's share
                    wav = torch.zeros((bsz, blen), device=self.device)
                    lengths = torch.full((bsz,), blen, dtype=torch.int64, device=self.device)
                    emb = getattr(self.model, self.method)(wav, lengths)
                    torch.stack(emb.unbind(0))  # _collect's kernel, loaded before a request
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------- files ----------------

    def _cache_key(self, path: str, trim: bool = False):
        try:
            st = os.stat(path)
        except OSError:
            return None  # unstatable: let the embed path report the error
        return ((os.path.abspath(path), trim), st.st_mtime_ns, st.st_size)

    def embed_files_device(self, paths: Sequence[str], trim: bool = False) -> torch.Tensor:
        """Files -> [N, emb_dim] f32 on the device, in input order (with
        ``trim``, of each file's first 10 s). With ``file_cache``,
        unchanged files reuse their earlier embedding (the same bits: the
        forward is deterministic per file and batch shape); only the misses
        are decoded and embedded, in batches of their own."""
        paths = list(paths)
        if self.file_cache is None or not paths:
            return self._embed_files_uncached(paths, trim)
        keys = [self._cache_key(p, trim) for p in paths]
        # snapshot the hits before inserting: the inserts below may evict
        # this request's own hits from a bounded cache
        hits = {i: self.file_cache[k] for i, k in enumerate(keys)
                if k is not None and k in self.file_cache}
        self.cache_hits += len(hits)
        missing = [i for i in range(len(paths)) if i not in hits]
        fresh = {}
        if missing:
            emb = self._embed_files_uncached([paths[i] for i in missing], trim)
            for row, i in enumerate(missing):
                fresh[i] = emb[row]
                if keys[i] is not None:
                    # a row of its own, so an evicted entry frees its memory
                    self.file_cache[keys[i]] = emb[row].clone()
        return torch.stack([hits[i] if i in hits else fresh[i] for i in range(len(paths))])

    def embed_files(self, paths: Sequence[str], trim: bool = False) -> np.ndarray:
        return self.embed_files_device(paths, trim).cpu().numpy()

    def _embed_files_uncached(self, paths: list, trim: bool) -> torch.Tensor:
        if not paths:
            return self._empty()
        emb = self._embed_files_native(paths, trim)
        if emb is not None:
            return emb
        return self.embed_waves_device(self.load_waves(paths, trim))

    def _embed_files_native(self, paths: list, trim: bool) -> Optional[torch.Tensor]:
        """The native ingest path (counterpart of the JAX engine's
        ``_embed_files_native``): probe every file, plan batches by the
        predicted length at 16 kHz (trimmed), keep files of other rates in
        batches of their own (one resampling kernel bank per batch), and
        decode each batch in the C++ thread pool into its pinned host batch:
        raw int16 when every file of the batch is mono PCM16 at 16 kHz;
        otherwise quantized to int16 in C++ with ``quantize_transfer``, else
        f32. None when the library is unavailable or a file cannot be
        probed: the Python path runs."""
        if not native.available():
            return None
        with timed("engine.probe", items=len(paths)):
            infos = [native.native_probe(p) for p in paths]
        if any(info is None for info in infos):
            return None
        trim_sec = TRIM_SEC if trim else 0
        with timed("engine.plan", items=len(paths)):
            rates = [info[0] for info in infos]
            i16 = [sr == TARGET_SR and ch == 1 and bits == 16 and not is_float and not is_flac
                   for sr, _frames, ch, bits, is_float, is_flac in infos]
            limit = TARGET_SR * trim_sec if trim else math.inf
            chunks = self.plan([min(predicted_length(sr, frames), limit)
                                for sr, frames, *_ in infos], groups=rates)
        outs = []
        with torch.inference_mode():
            for chunk, bsz, blen in chunks:
                is_i16 = all(i16[i] for i in chunk)
                rows = self._rank_rows(chunk, bsz)
                host, lengths_t = self._host_batch(
                    len(rows), blen,
                    torch.int16 if is_i16 or self.quantize_transfer else torch.float32)
                batch, lengths = host.numpy(), lengths_t.numpy()
                chunk_paths = [paths[i] for i in rows]
                with timed("engine.native_ingest", items=len(rows)):
                    if is_i16:
                        _, _, errs = native.native_load_batch_i16(
                            chunk_paths, blen, TARGET_SR, trim_sec, IO_THREADS,
                            out=batch, lengths=lengths)
                    else:
                        sr = rates[chunk[0]]
                        _, _, errs = native.native_load_batch(
                            chunk_paths, blen, TARGET_SR, trim_sec,
                            expect_sr=0 if sr == TARGET_SR else sr, num_threads=IO_THREADS,
                            quantize_i16=self.quantize_transfer, out=batch,
                            lengths=lengths)
                with timed("engine.host_batch"):
                    for row, i in enumerate(rows):
                        if errs[row] != 0:  # a file the C++ path refused: decode it in Python
                            w = load_processing(paths[i], trim=trim)[0][:blen]
                            if batch.dtype == np.int16:
                                w = np.clip(np.round(w * PCM16_SCALE), -32768,
                                            32767).astype(np.int16)
                            batch[row] = 0
                            batch[row, : len(w)] = w
                            lengths[row] = len(w)
                outs.append(self._submit(host, lengths_t, native_ingest=True,
                                         frame=self._encode_batch(host)))
            return self._collect(chunks, outs, len(paths))


def list_dir_files(path: str) -> list[str]:
    """Quirk Q3: dir mode follows os.listdir order."""
    return [os.path.join(path, x) for x in os.listdir(path)]
