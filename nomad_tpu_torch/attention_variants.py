"""Where the attention kernels spend their time on the card: diagnostic
variants.

    python -m nomad_tpu_torch.attention_variants [--kernels k4,k4b,k1,k1b,k23,k23b]

Builds copies of ``csrc/fused_attention.cu``, ``csrc/fused_attention_bf16.cu``,
``csrc/flash_attention.cu``, ``csrc/flash_attention_bf16.cu``,
``csrc/flash_attention_bwd.cu`` and ``csrc/flash_attention_bwd_bf16.cu``
(and of the headers they include)
with one part switched off, each by a text substitution that must match
the source, into
``build/nomad_tpu_torch/variants/`` (nvcc, as ``ops/_build.py`` builds the
real kernels), and times each against the unchanged kernel at the paths'
shapes with CUDA events (``--kernels`` picks groups or single variants by
name; all by default):

* K4 ``phase1``: the projections only (the key loop runs over no key);
* K4 ``phase2``: the key loop only (no projection);
* K4 ``phase1_no_cluster``: the projections launched without the cluster
  attribute (implicit clusters of one block), which prices the cluster
  scheduling;
* K4b ``phase1``, ``phase2`` and ``phase1_no_cluster``, the same for K4b,
  in both I/O flavours; its prologue (packing the weights, rounding an
  f32 x) runs in each. Without the cluster attribute every block loads the
  whole weight tile itself, so that variant also prices the multicast;
* K4b ``phase2_no_copy``: the key loop without its copies of the peers'
  key tiles (the two first tiles are still copied; the sums are wrong),
  which prices the copies through distributed shared memory;
* K4b ``empty``: neither phase (the prologue, the launch, the cluster
  barriers and the O stores of rows with no key), its fixed cost;
* K1 ``two_blocks``: K1 held to 2 blocks per SM by its shared memory, K4's
  occupancy;
* K2 + K3 ``two_blocks``: both held to 2 blocks per SM by their shared
  memory (the plan gives 3), which prices the occupancy;
* K2 + K3 ``rows16``: 16-row blocks at the loss crop (the plan takes 32),
  one row a thread: 2.9 waves of the card instead of 1.94;
* K2 + K3 ``no_resident_loads``: the tile's loads of its resident rows
  taken out of the column loop (wrong sums), which prices half of the
  score loop's shared-memory loads;
* K2b + K3b (``k23b``), in both I/O flavours at [24, 499], a ragged
  [8, 4095] and [32, 50], through the port's own wrapper
  (``flash_attention.flash_attention_bwd`` at "default"), each kernel's
  device time under the profiler and the call's host time beside the
  call's: ``loads_only``, the producer's TMA ring with no wgmma and no
  exp; ``no_loads``, the consumers without the ring (no copies, no
  waits; wrong sums);
* the mma.sync K2b + K3b that the TMA/wgmma design replaced
  (``k23bmma``, in no default group: they patch that design's source,
  so run them in a checkout of it with this file copied in, e.g.
  ``--kernels k23b,k23bmma_no_stage,k23bmma_stage_only``):
  ``no_stage``, the tiles' loading and rounding skipped, and
  ``stage_only``, the products and exp skipped;
* K1b (``k1b``), in both I/O flavours at [96, 511], [24, 499], a ragged
  [8, 4095] and [32, 50], through the port's own wrapper
  (``flash_attention.mha_flash`` at "default", any prologue included):
  the call's time, its host time and each kernel's device time under the
  profiler (``fold``, ``kernel``); by name only, ``k1bw_ring_only`` (the
  producer's TMA ring, no wgmma and no exp2f), ``k1bw_no_ring`` (the
  consumers without the ring; wrong sums) and ``k1bw_two_blocks`` (built
  for 2 blocks an SM, not 3);
* the mma.sync K1b that the TMA/wgmma design replaced (``k1bmma``, by
  name only, in a checkout of that source: ``--kernels
  k1b,k1bmma_no_stage,k1bmma_stage_only,k1bmma_no_branch``): the staging
  skipped, the products and exp skipped, and exp2f of every element with
  the mask a select.

K4, K1 and K2 + K3 are called through their C entries with ``bf16_io`` 0
(the f32 flavours). K4b goes through the port's own wrapper
(``fused_attention.fused_qkv_mha`` at "default", on f32 and on bf16 x)
with the variant's library in place of the real one, so a checkout whose
K4b takes other arguments (an older one, say, to time the parent's kernel
with this file) is called as its own wrapper calls it. The variants
compute nothing useful and are never loaded by the port. Prints one JSON
object with the times (ms; K1b's and K2b + K3b's by kernel under
"ms_by_kernel", their calls' host times under "host_ms") and the card's
name and power limit. To time two checkouts in turns, name in each only
what both have (a group holds variants of its own checkout's source).

"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .ops import _build, flash_attention, fused_attention

VARIANTS = {
    "k4": ("fused_attention.cu", []),
    "k4_phase1": ("fused_attention.cu", [("attend_keys(qs, len,", "attend_keys(qs, 0,")]),
    "k4_phase2": ("fused_attention.cu", [
        ("if (split_rows) {", "if (false) {"),
        ("} else if (rank == 0 || len > 0) {", "} else if (false) {")]),
    "k4_phase1_no_cluster": ("fused_attention.cu", [
        ("attend_keys(qs, len,", "attend_keys(qs, 0,"),
        ("cfg.numAttrs = 1;", "cfg.numAttrs = 0;"),
        ("if (max_active_clusters<IO>(cluster) == 0) return", "if (false) return")]),
    "k4b": ("fused_attention_bf16.cu", []),
    "k4b_phase1": ("fused_attention_bf16.cu", [
        ("const int tiles = (len + kRows - 1) / kRows;", "const int tiles = 0;")]),
    "k4b_phase2": ("fused_attention_bf16.cu", [
        ("if (split_rows) {", "if (false) {"),
        ("} else if (rank == 0 || len > 0) {", "} else if (false) {")]),
    "k4b_phase2_no_copy": ("fused_attention_bf16.cu", [
        ("if (split_rows) {", "if (false) {"),
        ("} else if (rank == 0 || len > 0) {", "} else if (false) {"),
        ("if (t + 2 < tiles) fetch(t + 2);", ""),
        ("if (t + 2 < tiles) stash(sm.u.p2.kv[(t + 2) % 3]);", "")]),
    "k4b_empty": ("fused_attention_bf16.cu", [
        ("if (split_rows) {", "if (false) {"),
        ("} else if (rank == 0 || len > 0) {", "} else if (false) {"),
        ("const int tiles = (len + kRows - 1) / kRows;", "const int tiles = 0;")]),
    "k4b_phase1_no_cluster": ("fused_attention_bf16.cu", [
        ("const int tiles = (len + kRows - 1) / kRows;", "const int tiles = 0;"),
        ("cfg.numAttrs = 1;", "cfg.numAttrs = 0;"),
        ("if (max_active_clusters<IO>(cluster) == 0) return", "if (false) return")]),
    "k1": ("flash_attention.cu", []),
    "k1_two_blocks": ("flash_attention.cu", [
        ("kMinBlocks = 3;", "kMinBlocks = 2;"),
        ("kSmemBytes = sizeof(Smem);", "kSmemBytes = 113664;")]),
    "k23b": ("flash_attention_bwd_bf16.cu", []),
    # the mma.sync K2b + K3b that the TMA/wgmma design replaced (each block
    # stages its own tiles), to be run in a checkout of it: the staging
    # skipped (the tiles hold garbage), or the products and exp skipped (the
    # staging alone)
    "k23bmma_no_stage": ("flash_attention_bwd_bf16.cu", [
        ("stage(ks, vs, kb, skt, vb, svt, key0, len);", ""),
        ("stage(qs, dos, qb, sqt, db, sdt, q0, T);", "")]),
    "k23bmma_stage_only": ("flash_attention_bwd_bf16.cu", [
        ("product_nt(ds, qa, ks);  // the scores, unscaled\n    product_nt(dp, da, vs);",
         "for (int j = 0; j < 32; ++j) ds[j / 4][j % 4] = dp[j / 4][j % 4] = 0.f;"),
        ("ok ? expf(ds[j][e] * scale - row_lse[i]) : 0.f", "ok ? 1.f : 0.f"),
        ("product_nn(acc, ds, ks);", ""),
        ("product_nt(p, ka, qs);  // the scores, unscaled",
         "for (int j = 0; j < 32; ++j) p[j / 4][j % 4] = 0.f;"),
        ("ok ? expf(p[j][e] * scale - tile_lse[col]) : 0.f", "ok ? 1.f : 0.f"),
        ("product_nn(gv, p, dos);  // dV += bf16(P^T) . bf16(dO)", ""),
        ("product_nt(dpt, va, dos);  // dP^T = V . dO^T",
         "for (int j = 0; j < 32; ++j) dpt[j / 4][j % 4] = 0.f;"),
        ("product_nn(gk, p, qs);  // dK += bf16(dS^T) . bf16(Q)", "")]),
    # this K2b + K3b (TMA ring, wgmma): the producer's ring with no wgmma and
    # no exp, or the consumers without the ring (no copies, no waits)
    "k23b_loads_only": ("flash_attention_bwd_bf16.cu", [
        ("  for (int kk = 0; kk < kD / 16; ++kk) wgmma_m64n64(d, a + 2 * kk, b + 2 * kk, kk > 0);\n",
         ""),
        ("    wgmma_m64n64_rs(acc, xa[kk], sw128_desc(smem_u32(tile + 16 * kk * kD)));\n", ""),
        ("expf(s[e] * scale", "(s[e] * scale")]),
    "k23b_no_loads": ("flash_attention_bwd_bf16.cu", [
        ("        mbar_expect_tx(&sm.full[j], 2 * kTileBytes);\n"
         "        tma_2d(sm.ring[j].a, &tm, 0, rows + base + s * kRows, &sm.full[j], 0);      // K\n"
         "        tma_2d(sm.ring[j].b, &tm, 0, 2 * rows + base + s * kRows, &sm.full[j], 0);  // V\n",
         ""),
        ("        mbar_expect_tx(&sm.full[j], 2 * kTileBytes + 2 * kRows * 4);\n"
         "        tma_2d(sm.ring[j].a, &tm, 0, base + s * kRows, &sm.full[j], 0);             // Q\n"
         "        tma_2d(sm.ring[j].b, &tm, 0, 3 * rows + base + s * kRows, &sm.full[j], 0);  // dO\n"
         "        bulk_copy(sm.lse[j], ld + base + s * kRows, kRows * 4, &sm.full[j]);\n"
         "        bulk_copy(sm.di[j], ld + rows + base + s * kRows, kRows * 4, &sm.full[j]);\n",
         ""),
        ("mbar_wait(&sm.full[j], (tile / kStages) & 1);", "")]),
    # K1b through its wrapper (``mha_flash`` at "default"), prologue included
    "k1b": ("flash_attention_bf16.cu", []),
    # the mma.sync K1b that the TMA/wgmma design replaced (each block stages
    # its own K/V tiles), to be run in a checkout of it: the staging skipped
    # (the tiles hold garbage), the products and exp skipped (the staging
    # alone), or exp2f of every element with the mask a select
    "k1bmma_no_stage": ("flash_attention_bf16.cu", [
        ("stage_kv(ks, vs, kb, skt, vb, svt, key0, len);", "")]),
    "k1bmma_stage_only": ("flash_attention_bf16.cu", [
        ("        mma_bf16(s[j], qa[2 * kp], bk[0], bk[1]);\n"
         "        mma_bf16(s[j], qa[2 * kp + 1], bk[2], bk[3]);\n", ""),
        ("ok ? exp2f((s[j][2 * i + e] - mx) * kLog2e) : 0.f", "ok ? 1.f : 0.f"),
        ("        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);\n"
         "        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);\n", "")]),
    "k1bmma_no_branch": ("flash_attention_bf16.cu", [
        ("const float p = ok ? exp2f((s[j][2 * i + e] - mx) * kLog2e) : 0.f;",
         "const float x = exp2f((s[j][2 * i + e] - mx) * kLog2e);\n"
         "          const float p = ok ? x : 0.f;")]),
    # this K1b (prologue, TMA ring, the shared wgmma key loop), by name only:
    # the ring with no wgmma and no exp2f; the consumers without the ring
    # (no copies, no waits; wrong sums); built for 2 blocks an SM
    "k1bw_ring_only": ("flash_attention_bf16.cu", [
        ("attention_wgmma.cuh", "  for (int kk = 0; kk < kAttnRows / 16; ++kk) "
         "wgmma_m64n64(s, dq + 2 * kk, dk + 2 * kk, kk > 0);\n", ""),
        ("attention_wgmma.cuh", "    wgmma_m64n64_rs(acc, pa[kk], sw128_desc(smem_u32(kt.v + 16 * kk "
         "* kAttnRows)));\n", ""),
        ("attention_wgmma.cuh", "const float x = exp2f((s[4 * jj + 2 * i + e] - mx) * kLog2e);",
         "const float x = (s[4 * jj + 2 * i + e] - mx) * kLog2e;")]),
    "k1bw_no_ring": ("flash_attention_bf16.cu", [
        ("        mbar_expect_tx(&sm.full[j], 2 * kTileBytes);\n"
         "        tma_2d(sm.ring[j].k, &tm, 0, krow + s * kRows, &sm.full[j], 0);\n"
         "        tma_2d(sm.ring[j].v, &tm, 0, vrow + s * kRows, &sm.full[j], 0);\n", ""),
        ("mbar_wait(&sm.full[t % kStages], (t / kStages) & 1);", "")]),
    "k1bw_two_blocks": ("flash_attention_bf16.cu", [
        ("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 2;")]),
    "k23": ("flash_attention_bwd.cu", []),
    "k23_two_blocks": ("flash_attention_bwd.cu", [
        ("kMinBlocks = 3;", "kMinBlocks = 2;"),
        ("sizeof(DqSmem<4>)", "113664"), ("sizeof(DkvSmem<4>)", "113664")]),
    "k23_rows16": ("flash_attention_bwd.cu", [("kSmallRT = 2;", "kSmallRT = 1;")]),
    # (header, old, new): a substitution in an included header
    "k23_no_resident_loads": ("flash_attention_bwd.cu", [
        ("attention_bwd_tile.cuh", "for (int d = 0; d < kD; d += 4) {\n    float4 a[RT];",
         "float4 a[RT];\n  for (int d = 0; d < kD; d += 4) {"),
        ("attention_bwd_tile.cuh", "      a[i] = *reinterpret_cast",
         "      if (d == 0) a[i] = *reinterpret_cast")]),
}
K1_SMEM = {"k1": flash_attention.FLASH_SMEM_BYTES, "k1_two_blocks": 113664}
HEADERS = ("attention_tile.cuh", "attention_bwd_tile.cuh", "hopper.cuh", "attention_wgmma.cuh")
GROUPS = ("k4", "k4b", "k1", "k1b", "k23", "k23b")  # --kernels: a variant's group is its name's first word


def build(picked) -> dict:
    """The library of each variant in ``picked``, built in parallel: the
    variants it names, or, where it names only groups, every variant of
    each (the unchanged kernel's variant bears its group's name). Raises
    when a substitution does not match the source."""
    root = _build.build_dir() / "variants"
    by_name = set(picked) - set(GROUPS)
    procs = {}
    for name, (src, subs) in VARIANTS.items():
        if (name not in picked) if by_name else (name.split("_")[0] not in picked):
            continue
        # an older checkout lacks the newer headers
        texts = {f: (_build.CSRC / f).read_text() for f in (src, *HEADERS)
                 if (_build.CSRC / f).is_file()}
        for sub in subs:
            f, old, new = sub if len(sub) == 3 else (src, *sub)
            if old not in texts[f]:
                raise RuntimeError(f"variant {name}: {old!r} not in csrc/{f}")
            texts[f] = texts[f].replace(old, new)
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in texts.items():
            (d / f).write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{out}")
        libs[name] = ctypes.CDLL(str(root / name / "lib.so"))
    return libs


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def library(name: str, lib: ctypes.CDLL):
    """The port's wrappers call ``lib`` for ``csrc/<name>.cu`` inside the
    block: a variant runs through the same wrapper, arguments and
    buffers as the real kernel."""
    lib.nomad_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nomad_cuda_error_string.restype = ctypes.c_char_p
    saved = _build._libs.get(name)
    _build._libs[name] = lib
    try:
        yield
    finally:
        if saved is None:
            _build._libs.pop(name)
        else:
            _build._libs[name] = saved


def time_fused(libs, shapes, dev, stream, out) -> None:
    """K4's and K4b's variants that were built (K4b in both I/O flavours) at
    ``shapes``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    g = torch.Generator().manual_seed(0)
    h, dm = 12, 768
    for b, t, lens in shapes:
        x = torch.randn(b, t, dm, generator=g).to(dev)
        params = [a.to(dev) for _ in range(3) for a in (
            torch.randn(dm, dm, generator=g) / dm**0.5, 0.1 * torch.randn(dm, generator=g))]
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        plan = fused_attention.fused_launch_plan(t, b, h)
        o = torch.empty(b, t, h, 64, device=dev)
        for name in [v for v in VARIANTS if v.split("_")[0] == "k4" and v in libs]:
            fn = libs[name].nomad_fused_qkv_attention_fwd
            fn.argtypes = [p] * 9 + [i] * 4 + [ll] * 3 + [ctypes.c_float] + [i] * 5 + [p]
            args = (x.data_ptr(), *(a.data_ptr() for a in params), lengths.data_ptr(),
                    o.data_ptr(), b, t, h, dm, *o.stride()[:3], 0.125, plan.cluster,
                    plan.rows_per_block, plan.tensors_per_block, plan.smem_bytes, 0, stream)
            if fn(*args):
                raise RuntimeError(f"{name} [{b}, {t}]: launch refused")
            out["ms"][f"{name} [{b}, {t}, {dm}]"] = time_ms(lambda: fn(*args))
        for io in (torch.float32, torch.bfloat16):
            xi = x.to(io)
            for name in [v for v in VARIANTS if v.split("_")[0] == "k4b" and v in libs]:
                with library("fused_attention_bf16", libs[name]):
                    out["ms"][f"{name} [{b}, {t}, {dm}] bf16_io {int(io == torch.bfloat16)}"] = (
                        time_ms(lambda: fused_attention.fused_qkv_mha(
                            xi, *params, lengths, h, "default")))


def host_ms(fn, iters: int, rounds: int = 9) -> float:
    """Host time of one fn() (perf_counter, the card not waited on): what a
    launch-bound caller waits for. The median over ``rounds`` of the mean
    of ``iters`` calls in a row, since the host's cores are shared."""
    fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - start) * 1e3 / iters)
    torch.cuda.synchronize()
    return float(np.median(times))


def time_bwd_bf16(libs, dev, out) -> None:
    """K2b + K3b's variants that were built, in both I/O flavours, through
    the port's own wrapper (``flash_attention.flash_attention_bwd`` at
    "default", so an older checkout's kernels run as its wrapper calls
    them): the call's time (CUDA events, Di's reduction and any prologue
    included), its host time (the wrapper's own work per call, the card
    not waited for) and each kernel's device time under torch.profiler,
    by kernel name (``fold``: a prologue, ``dq``, ``dkv``, ``other``:
    Di)."""
    names = [v for v in VARIANTS if v.split("_")[0] in ("k23b", "k23bmma") and v in libs]
    g = torch.Generator().manual_seed(2)
    h = 12
    for b, t, lens in ((24, 499, [499, 249, 1, 0] + [499] * 20),
                       (8, 4095, [4095, 4000, 3001, 2048, 1025, 64, 1, 0]),
                       (32, 50, [50, 25, 1, 0] + [50] * 28)) if names else ():
        q, k, v = torch.randn(b, t, 3, h, 64, generator=g).to(dev).unbind(2)
        do = torch.randn(b, t, h, 64, generator=g).to(dev)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        for io in (torch.float32, torch.bfloat16):
            qi, ki, vi, doi = (x.to(io) for x in (q, k, v, do))
            o, lse = flash_attention.mha_flash(qi, ki, vi, lengths, "default")
            for name in names:
                with library("flash_attention_bwd_bf16", libs[name]):
                    def call():
                        return flash_attention.flash_attention_bwd(qi, ki, vi, o, lse, doi,
                                                                   lengths, "default")
                    key = f"{name} [{b}, {t}, {h}, 64] bf16_io {int(io == torch.bfloat16)}"
                    out["ms"][key] = time_ms(call, 10 if t > 1024 else 30)
                    out["host_ms"][key] = host_ms(call, 10 if t > 1024 else 50)
                    out["ms_by_kernel"][key] = profiled_parts(
                        call, {"fold": ("fold",), "dq": ("bwd_dq_bf16",),
                               "dkv": ("bwd_dkv_bf16",)})


def profiled_parts(call, parts: dict, reps: int = 10) -> dict:
    """Device time (ms) of one call by kernel, under torch.profiler over
    ``reps`` calls: {part: ms}, a kernel going to the first part whose
    name it holds (``parts``: {part: (substrings)}), else to "other"."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = dict.fromkeys([*parts, "other"], 0.0)
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        part = next((p for p, keys in parts.items() if any(k in evt.name for k in keys)), "other")
        out[part] += evt.time_range.elapsed_us() / 1e3 / reps
    return out


def time_flash_bf16(libs, dev, out) -> None:
    """K1b's variants that were built (``k1b``, ``k1bmma_*``), in both I/O
    flavours, through the port's own wrapper (``flash_attention.mha_flash``
    at "default", so an older checkout's kernel runs as its wrapper calls
    it) at the paths' shapes: the call's time (CUDA events, any prologue
    included), its host time and each kernel's device time under
    torch.profiler (``fold``: a prologue; ``kernel``: the attention)."""
    names = [v for v in VARIANTS if v.split("_")[0] in ("k1b", "k1bmma", "k1bw") and v in libs]
    g = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(3)
    h = 12
    shapes = ((96, 511, [511, 1, 0] + list(rng.integers(2, 511, size=9)) + [499] * 84),
              (24, 499, [499, 249, 1, 0] + [499] * 20),
              (8, 4095, [4095, 4000, 3001, 2048, 1025, 64, 1, 0]),
              (32, 50, [50, 25, 1, 0] + [50] * 28))
    for b, t, lens in shapes if names else ():
        q, k, v = torch.randn(b, t, 3, h, 64, generator=g).to(dev).unbind(2)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        for io in (torch.float32, torch.bfloat16):
            qi, ki, vi = (x.to(io) for x in (q, k, v))
            for name in names:
                with library("flash_attention_bf16", libs[name]):
                    def call():
                        return flash_attention.mha_flash(qi, ki, vi, lengths, "default")
                    key = f"{name} [{b}, {t}, {h}, 64] bf16_io {int(io == torch.bfloat16)}"
                    out["ms"][key] = time_ms(call, 10 if t > 1024 else 30)
                    out["host_ms"][key] = host_ms(call, 10 if t > 1024 else 50)
                    out["ms_by_kernel"][key] = profiled_parts(
                        call, {"fold": ("fold",), "kernel": ("flash_fwd_bf16",)})


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("attention_variants: needs a CUDA card")
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels", default=",".join(GROUPS),
                        help=f"comma-separated groups ({','.join(GROUPS)}) or variant names")
    picked = parser.parse_args().kernels.split(",")
    if set(picked) - set(GROUPS) - set(VARIANTS):
        sys.exit(f"attention_variants: --kernels takes {','.join(GROUPS)} or variant names")
    dev = torch.device("cuda")
    libs = build(picked)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    rng = np.random.default_rng(0)
    # the smoke's shapes: the scoring batch with its lengths, the loss crop,
    # and the longest input K4 takes, ragged
    main_lens = [511, 1] + list(rng.integers(2, 511, size=10)) + [499] * 84
    shapes = ((96, 511, main_lens), (32, 50, [50] * 32),
              (8, 1024, [1024, 1023, 777, 513, 512, 64, 2, 1]))
    stream = torch.cuda.current_stream().cuda_stream
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out = {"card": smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else
           torch.cuda.get_device_name(0), "ms": {}, "ms_by_kernel": {}, "host_ms": {}}
    time_fused(libs, shapes, dev, stream, out)
    time_bwd_bf16(libs, dev, out)
    time_flash_bf16(libs, dev, out)
    h = 12
    g = torch.Generator().manual_seed(1)
    k1 = [v for v in VARIANTS if v.split("_")[0] == "k1" and v in libs]
    k23 = [v for v in VARIANTS if v.split("_")[0] == "k23" and v in libs]
    if k1:
        b, t, lens = shapes[0]
        q, k, v = torch.randn(b, t, 3, h, 64, generator=g).to(dev).unbind(2)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        o, lse = torch.empty(b, t, h, 64, device=dev), torch.empty(b, h, t, device=dev)
        for name in k1:
            fn = libs[name].nomad_flash_attention_fwd
            fn.argtypes = [p] * 6 + [i] * 4 + [ll] * 12 + [ctypes.c_float, i, i, p]
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), b, t, h, 64, *q.stride()[:3], *k.stride()[:3],
                    *v.stride()[:3], *o.stride()[:3], 0.125, K1_SMEM[name], 0, stream)
            if fn(*args):
                raise RuntimeError(f"{name}: launch refused")
            out["ms"][f"{name} [{b}, {t}, {h}, 64]"] = time_ms(lambda: fn(*args))
    # K2 + K3 at the 10 s clips' [24, 499] and the loss crop's [32, 50]
    for b, t in ((24, 499), (32, 50)) if k23 else ():
        q, k, v = torch.randn(b, t, 3, h, 64, generator=g).to(dev).unbind(2)
        lengths = torch.full((b,), t, dtype=torch.int32, device=dev)
        o, lse = flash_attention.mha_flash(q, k, v, lengths)
        do, di, lengths = flash_attention._bwd_args(
            q, k, v, o, lse, torch.randn(b, t, h, 64, generator=g).to(dev), lengths)
        dq, dk, dv = (torch.empty(b, t, h, 64, device=dev) for _ in range(3))
        plan = flash_attention.flash_bwd_launch_plan(t, b, h)["dq"]
        for name in k23:
            rows, smem = plan["rows_per_block"], plan["smem_bytes"]
            if name == "k23_two_blocks" and rows == 64:
                smem = 113664
            elif name == "k23_rows16" and rows < 64:
                rows = 16  # resident rows, K/V or Q/dO tiles in flight, the slice
                smem = 4 * (2 * rows * 64 + 2 * 2 * 32 * 68 + rows * 36)
            elif name in ("k23_two_blocks", "k23_rows16"):
                continue
            total = 0.0
            for entry, outs in (("dq", (dq,)), ("dkv", (dk, dv))):
                fn = getattr(libs[name], f"nomad_flash_attention_bwd_{entry}")
                fn.argtypes = [p] * (7 + len(outs)) + [i] * 4 + [ll] * 12 + [ctypes.c_float, i, i, i, p]
                args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        di.data_ptr(), lengths.data_ptr(), *(x.data_ptr() for x in outs),
                        b, t, h, 64, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                        *do.stride()[:3], 0.125, rows, smem, 0, stream)
                if fn(*args):
                    raise RuntimeError(f"{name} {entry} [{b}, {t}]: launch refused")
                ms = time_ms(lambda: fn(*args))
                out["ms"][f"{name}_{entry} [{b}, {t}, {h}, 64]"] = ms
                total += ms
            out["ms"][f"{name}_pair [{b}, {t}, {h}, 64]"] = total
    print(json.dumps(out))


if __name__ == "__main__":
    main()
