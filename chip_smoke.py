"""Smoke run of nomad_tpu_torch on one CUDA card: build, check, time, score,
differentiate.

    python3 chip_smoke.py [--only-loss]

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from nomad_tpu_torch/csrc with nvcc,
     print ptxas' registers, shared memory and spills (a spill fails), and
     the occupancy (blocks per SM; K4's clusters on the card) of K1, K2,
     K3 and K4;
  3. hold each kernel against its plain PyTorch version on the card at the
     paths' shapes, and time kernel, plain version and one PyTorch call
     computing the same function (a yardstick the port never calls),
     beside the least time the card could take (bound): K1 and K5 at the
     scoring shapes, K2 and K3 (the attention backward) at the loss shape,
     the triplet-training shape and a ragged long shape, and untimed at
     every edge of their tiles, with NaN past the bound and a rerun that
     must give the same bits, K4 (projection-fused attention) at the
     scoring and loss shapes and a ragged [8, 1024] shape with garbage
     past each bound;
  4. the scoring paths at full wav2vec 2.0 BASE width with seeded weights:
     ``python -m nomad_tpu_torch --mode dir`` on 8 + 100 seeded 10 s WAVs,
     then ``Nomad(device="cuda").predict`` in process with the kernel
     launch counts read around it; embeddings held against the plain path
     on the same card and against batch-1 runs; warm throughput, pass time
     and peak memory; one warm pass under torch.profiler (device time by
     kernel group, the device's idle share). Then the same for the fused
     path (``attention_impl="fused_qkv"``: K4, no K1), held against the
     plain and K1 paths, and two single files on it: 300,000 samples
     (T' = 1,023, K4) and 400,000 (T' = 1,433, past K4's limit: K1);
  5. the loss paths at the same width, K1's and the fused one:
     ``Nomad.forward(estimate, clean)`` and ``.backward()`` on 32 seeded
     16,384-sample crops, then K1's on 24 seeded 10 s clips (160,000
     samples, T' = 499: the triplet batch's attention shape), with the
     launch counts of one step; loss and d loss / d estimate held against
     the plain path; forward(x, x) == 0; warm step time, host enqueue
     time, peak memory and one step under torch.profiler;
  6. the kernels' JSON line, the card line, and the last line
     ``{"ok": true, "device": {...}}``.
Exits non-zero, and prints no result, without a CUDA card or outside a
checkout of the repository. Every measurement is also printed as one
JSON object on the line that starts with "report: ". ``--only-loss`` runs
phases 1 and 5 alone and ends with the report line: the same loss steps
timed over another checkout's package (the script uses no entry point
newer than the loss path's).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from nomad_tpu_torch.api import Nomad, set_exact_precision
from nomad_tpu_torch.io import write_wav
from nomad_tpu_torch.models import Wav2Vec2Config
from nomad_tpu_torch.ops import _build, flash_attention, fused_attention, layernorm

ROOT = Path(__file__).resolve().parent
# H100 SXM data-sheet peaks (at the 700 W limit): HBM rate, f32 without
# tensor cores ("exact" forbids TF32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
SR = 16000
N_NMR, N_DEG, SECONDS = 8, 100, 10.0
# the SE demo's crop at its training batch (reference nomad_loss_test.py:196,
# nomad_tpu/configs/se_config.yaml:12): T' = 50 frames
LOSS_BATCH, LOSS_SAMPLES, LOSS_STEPS = 32, 16384, 7
# the loss on utterance-length clips: the triplet batch (A/P/N of batch 8)
# of 10 s trimmed to 160,000 samples gives T' = 499
LOSS10_BATCH, LOSS10_SAMPLES = 24, 160_000
# single files on the fused path: (samples, T' of their bucket); 1,023
# frames is the longest bucket K4 takes, 1,433 is past MAX_FUSED_T
FUSED_SINGLE_FILES = ((300_000, 1023), (400_000, 1433))
TOL_LN, TOL_FLASH = 1e-5, 2e-5  # f32, sums in another order than the plain version
# K2/K3 on unit-scale inputs: 2e-5 up to T = 512 keys or queries summed,
# growing as sqrt(T) beyond (rounding of a sum of T terms; at T = 4095 the
# one-key row's dK, analytically 0, is a sum of 4095 rounding residuals),
# plus 1e-5 relative: that row's dV sums every query's dO (|dV| ~ 30), one
# row after another in the kernel
TOL_FLASH_BWD, RTOL_FLASH_BWD = 2e-5, 1e-5
# K4: K1's tolerance, plus 1e-5 relative for the projections' sums of 768
# products, in another order than cuBLAS's
TOL_FUSED, RTOL_FUSED = 2e-5, 1e-5
TOL_REF_PATH, TOL_BATCH1 = 1e-4, 1e-5
TOL_LOSS_REL, TOL_GRAD_REL = 1e-5, 1e-4  # loss relative; gradient relative to max|g|

DEV = torch.device("cuda")
report: dict = {"kernels": {}, "checks": {}}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over iters calls (CUDA events, warmed up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn) -> dict:
    """Device time (ms) by kernel name of one warm fn() under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            names[evt.name[:120]] = names.get(evt.name[:120], 0.0) + evt.time_range.elapsed_us() / 1e3
    return dict(sorted(names.items(), key=lambda x: -x[1]))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------- phase 1: the card ----------------


def card_info() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    report["card"] = {"nvidia_smi": line, "torch_name": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()}
    print(f"card: {line} | torch: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    return line


# ---------------- phase 2: build ----------------


def build_kernels() -> None:
    t0 = time.perf_counter()
    logs = _build.build()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {len(logs)} kernel sources in {report['build_s']:.1f} s", flush=True)
    spills = []
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
                print(f"  ptxas[{name}]: {line.strip()}")
            spills += [f"{name}: {line.strip()}" for n in re.findall(r"(\d+) bytes spill", line)
                       if int(n)]
    if spills:
        fail("ptxas spills registers: " + "; ".join(spills))
    # resident blocks per SM (and K4's clusters on the card) at each
    # kernel's shared memory, from the CUDA occupancy API
    occ = {"flash_attention_fwd": {"blocks_per_sm": flash_attention.flash_occupancy(),
                                   "smem_bytes": flash_attention.FLASH_SMEM_BYTES}}
    for t in (50, 499):  # K2/K3's plans: 32-row blocks up to T = 64, 64-row beyond
        for kernel, plan in flash_attention.flash_bwd_launch_plan(t, 1, 12).items():
            blocks = flash_attention.flash_bwd_occupancy(kernel, plan["rows_per_block"])
            occ[f"flash_attention_bwd_{kernel}_T{t}"] = {
                "rows_per_block": plan["rows_per_block"], "blocks_per_sm": blocks,
                "plan_blocks_per_sm": plan["blocks_per_sm"], "smem_bytes": plan["smem_bytes"]}
            if blocks < plan["blocks_per_sm"]:
                fail(f"K2/K3 {kernel} at T = {t}: {blocks} blocks per SM, the plan claims "
                     f"{plan['blocks_per_sm']}")
    for t in (50, 65, 511, 1024):
        plan = fused_attention.fused_launch_plan(t, 1, 12)
        blocks, clusters = fused_attention.fused_occupancy(t)
        occ[f"fused_qkv_attention_fwd_T{t}"] = {
            "cluster": plan.cluster, "tensors_per_block": plan.tensors_per_block,
            "blocks_per_sm": blocks, "clusters_on_card": clusters, "smem_bytes": plan.smem_bytes}
    report["occupancy"] = occ
    print("occupancy: " + "; ".join(f"{k} {v}" for k, v in occ.items()), flush=True)


# ---------------- phase 3: kernels against their plain versions ----------------


def check_layernorm(rows: int, width: int, g: torch.Generator) -> dict:
    x = (3 * torch.randn(rows, width, generator=g) + 1).to(DEV)
    w = (1 + 0.1 * torch.randn(width, generator=g)).to(DEV)
    b = (0.1 * torch.randn(width, generator=g)).to(DEV)
    out = layernorm.layer_norm(x, w, b)
    ref = layernorm.layer_norm_ref(x, w, b)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not torch.isfinite(out).all() or err > TOL_LN:
        fail(f"layernorm [{rows}, {width}] max|d| {err:.3g} > {TOL_LN}")
    nbytes = 2 * rows * width * 4 + 2 * width * 4
    b_ms, b_by = bound(nbytes, 8.0 * rows * width)
    res = {
        "shape": [rows, width], "max_abs_err": err,
        "ms": time_ms(lambda: layernorm.layer_norm(x, w, b), 50),
        "plain_ms": time_ms(lambda: layernorm.layer_norm_ref(x, w, b), 20),
        "library_ms": time_ms(lambda: F.layer_norm(x, (width,), w, b, 1e-5), 50),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    print(f"  layernorm [{rows}, {width}]: max|d| {err:.3g}  kernel {res['ms']:.4f} ms  "
          f"plain {res['plain_ms']:.4f}  F.layer_norm {res['library_ms']:.4f}  "
          f"bound {b_ms:.4f} ({b_by})", flush=True)
    return res


def flash_bound(b: int, t: int, h: int, d: int, lengths: torch.Tensor) -> tuple[float, str]:
    """All T query rows are written; keys past lengths[b] are never read."""
    keys = int(lengths.sum())
    flops = 4.0 * h * d * t * keys
    nbytes = 4.0 * (2 * b * t * h * d + 2 * keys * h * d + b * h * t + b)
    return bound(nbytes, flops)


def check_flash(b: int, t: int, lengths: list, g: torch.Generator, timed: bool) -> dict:
    h, d = 12, 64
    # one [B, T, 3, H, D] buffer viewed as q, k, v: the strided layout the
    # model's projections hand over
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(DEV)
    q, k, v = qkv.unbind(2)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    o, lse = flash_attention.mha_flash(q, k, v, lens)
    torch.cuda.synchronize()
    err = 0.0
    for i in range(b):  # the plain version row by row: [1, H, T, T] at a time
        ro, rlse = flash_attention.flash_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1], lens[i:i + 1])
        err = max(err, (o[i:i + 1] - ro).abs().max().item(), (lse[i:i + 1] - rlse).abs().max().item())
    finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
    if not finite or err > TOL_FLASH:
        fail(f"flash [{b}, {t}, {h}, {d}] finite={finite} max|d| {err:.3g} > {TOL_FLASH}")
    b_ms, b_by = flash_bound(b, t, h, d, lens)
    res = {"shape": [b, t, h, d], "lengths_sum": int(lens.sum()), "max_abs_err": err,
           "bound_ms": b_ms, "bound_by": b_by}
    res["ms"] = time_ms(lambda: flash_attention.mha_flash(q, k, v, lens), 10 if t > 1024 else 30)
    if timed:
        mask = (torch.arange(t, device=DEV)[None, :] < lens[:, None])[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        res["plain_ms"] = time_ms(lambda: flash_attention.flash_attention_ref(q, k, v, lens), 5)
        res["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 10)
    print(f"  flash [{b}, {t}, {h}, {d}] keys {int(lens.sum())}: max|d| {err:.3g}  "
          f"kernel {res['ms']:.4f} ms  plain {res.get('plain_ms', float('nan')):.4f}  "
          f"sdpa {res.get('library_ms', float('nan')):.4f}  bound {b_ms:.4f} ({b_by})", flush=True)
    return res


def flash_bwd_bounds(b: int, t: int, h: int, d: int, lengths: torch.Tensor) -> dict:
    """Per kernel: every (query row, valid key) pair costs K2 6*D FLOP (s,
    dP, dQ) and K3 8*D (s, dP, dK, dV). Bytes: the valid keys' k and v,
    q, dO, LSE and Di of the batch rows that have a key, and the outputs
    (dQ; dK and dV), each once."""
    lens = lengths.long()
    keys, live = int(lens.sum()), int((lens > 0).sum())
    pairs = t * keys
    row = 4.0 * h * d
    reads = 2 * keys * row + 2 * live * t * row + 2 * live * h * t * 4.0
    return {"dq": bound(reads + b * t * row, 6.0 * h * d * pairs),
            "dkv": bound(reads + 2 * b * t * row, 8.0 * h * d * pairs)}


def check_flash_bwd(b: int, t: int, lengths: list, g: torch.Generator, timed: bool,
                    kernel_times: bool = True) -> dict:
    """K2 and K3 against flash_attention_bwd_ref on the card. NaN is written
    into k and v past each row's bound; dK and dV must be exactly 0 there,
    and a second call must give the same bits. ``kernel_times``: time K2
    and K3; ``timed``: the plain version and SDPA's gradient too."""
    h, d = 12, 64
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(DEV)
    q, k, v = qkv.unbind(2)
    for i, n in enumerate(lengths):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    o, lse = flash_attention.mha_flash(q, k, v, lens)
    do = torch.randn(b, t, h, d, generator=g).to(DEV)
    do_, di, lens_ = flash_attention._bwd_args(q, k, v, o, lse, do, lens)
    dq = flash_attention._bwd_dq_kernel(q, k, v, do_, lse, di, lens_)
    dk, dv = flash_attention._bwd_dkv_kernel(q, k, v, do_, lse, di, lens_)
    torch.cuda.synchronize()
    err = {"dq": 0.0, "dkv": 0.0}
    atol = TOL_FLASH_BWD * max(1.0, (t / 512) ** 0.5)
    excess = 0.0  # max of |d| - (atol + rtol |ref|): > 0 fails
    for i in range(b):  # the plain version row by row: [1, H, T, T] at a time
        sl = slice(i, i + 1)
        rq, rk, rv = flash_attention.flash_attention_bwd_ref(
            q[sl], k[sl], v[sl], o[sl], lse[sl], do[sl], lens[sl])
        for key, ours, ref in (("dq", dq, rq), ("dkv", dk, rk), ("dkv", dv, rv)):
            diff = (ours[sl] - ref).abs().nan_to_num(nan=float("inf"))  # a NaN fails
            err[key] = max(err[key], diff.max().item())
            excess = max(excess, (diff - atol - RTOL_FLASH_BWD * ref.abs()).max().item())
    finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
    zero_past = all(bool((dk[i, n:] == 0).all() and (dv[i, n:] == 0).all())
                    for i, n in enumerate(lengths))
    zero_rows = all(bool((dq[i] == 0).all()) for i, n in enumerate(lengths) if n == 0)
    again = (flash_attention._bwd_dq_kernel(q, k, v, do_, lse, di, lens_),
             *flash_attention._bwd_dkv_kernel(q, k, v, do_, lse, di, lens_))
    same_bits = all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again))
    del again
    if not (finite and zero_past and zero_rows and same_bits) or excess > 0:
        fail(f"flash bwd [{b}, {t}, {h}, {d}] finite={finite} zero past bound={zero_past} "
             f"zero rows={zero_rows} rerun same bits={same_bits} max|d| {err} beyond "
             f"{atol:.3g} + {RTOL_FLASH_BWD}|ref| by {excess:.3g}")
    bounds = flash_bwd_bounds(b, t, h, d, lens)
    iters = 10 if t > 1024 else 30
    res = {"shape": [b, t, h, d], "lengths": lengths, "lengths_sum": int(lens.sum()),
           "tolerance": [atol, RTOL_FLASH_BWD]}
    for key, fn in (("dq", lambda: flash_attention._bwd_dq_kernel(q, k, v, do_, lse, di, lens_)),
                    ("dkv", lambda: flash_attention._bwd_dkv_kernel(q, k, v, do_, lse, di, lens_))):
        res[key] = {"max_abs_err": err[key], "bound_ms": bounds[key][0], "bound_by": bounds[key][1]}
        if kernel_times:
            res[key]["ms"] = time_ms(fn, iters)
    if not kernel_times:
        print(f"  flash bwd [{b}, {t}, {h}, {d}] lengths {lengths}: K2 max|d| {err['dq']:.3g}, "
              f"K3 max|d| {err['dkv']:.3g} (<= {atol:.3g} + {RTOL_FLASH_BWD}|ref|), "
              "rerun same bits", flush=True)
        return res
    if timed:
        # one plain call and one library call compute K2 and K3's outputs
        # together: both times stand on both rows
        plain = time_ms(lambda: flash_attention.flash_attention_bwd_ref(
            q, k, v, o, lse, do, lens), 5)
        qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        mask = None
        if int(lens.min()) < t:
            mask = (torch.arange(t, device=DEV)[None, :] < lens[:, None])[:, None, None, :]
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        dot = do.transpose(1, 2)
        lib = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), 10)
        for key in ("dq", "dkv"):
            res[key]["plain_ms"], res[key]["library_ms"] = plain, lib
        res["library_kernels_ms"] = device_kernels(
            lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))
    if "library_kernels_ms" in res:
        print(f"  flash bwd [{b}, {t}, {h}, {d}]: SDPA's gradient launches "
              + "; ".join(f"{n} {ms:.4f} ms" for n, ms in res["library_kernels_ms"].items()))
    print(f"  flash bwd [{b}, {t}, {h}, {d}] keys {int(lens.sum())}: "
          f"K2 dQ max|d| {err['dq']:.3g} {res['dq']['ms']:.4f} ms (bound {bounds['dq'][0]:.4f}); "
          f"K3 dK/dV max|d| {err['dkv']:.3g} {res['dkv']['ms']:.4f} ms "
          f"(bound {bounds['dkv'][0]:.4f}); plain pair {res['dq'].get('plain_ms', float('nan')):.4f} "
          f"ms, sdpa grad {res['dq'].get('library_ms', float('nan')):.4f} ms", flush=True)
    return res


def fused_bound(b: int, t: int, h: int, dm: int, lengths: torch.Tensor) -> tuple[float, str]:
    """Q is projected for all T rows, K and V for the valid keys only, and
    every query row attends the valid keys. Bytes: x, the three weights
    and biases, lengths and O, each once."""
    keys = int(lengths.long().sum())
    flops = 2.0 * b * t * dm * dm + 4.0 * keys * dm * dm + 4.0 * h * 64 * t * keys
    nbytes = 4.0 * (2 * b * t * dm + 3 * dm * dm + 3 * dm + b)
    return bound(nbytes, flops)


def check_fused(b: int, t: int, lengths: list, g: torch.Generator, timed: bool) -> dict:
    """K4 against fused_qkv_attention_ref on the card, x at unit scale and
    the weights at the seeded init's (std 1/sqrt(768)). Where a row is
    ragged, x is zero past its bound for the comparison, and the valid
    rows of a call with 123.0 there must be the same bits."""
    h, dm = 12, 768
    x = torch.randn(b, t, dm, generator=g)
    params = [a.to(DEV) for _ in range(3) for a in (
        torch.randn(dm, dm, generator=g) / dm**0.5, 0.1 * torch.randn(dm, generator=g))]
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    x = x.to(DEV)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    o = fused_attention.fused_qkv_mha(x, *params, lens, h)
    ref = fused_attention.fused_qkv_attention_ref(x, *params, lens, h)
    torch.cuda.synchronize()
    diff = (o - ref).abs()
    err = diff.max().item()
    excess = (diff - TOL_FUSED - RTOL_FUSED * ref.abs()).max().item()
    garbage_ok = True
    if min(lengths) < t:
        x_bad = x.clone()
        for i, n in enumerate(lengths):
            x_bad[i, n:] = 123.0
        o_bad = fused_attention.fused_qkv_mha(x_bad, *params, lens, h)
        garbage_ok = bool(torch.isfinite(o_bad).all()) and all(
            torch.equal(o_bad[i, :, :n], o[i, :, :n]) for i, n in enumerate(lengths))
        del x_bad, o_bad
    finite = bool(torch.isfinite(o).all())
    if not (finite and garbage_ok) or excess > 0:
        fail(f"fused [{b}, {t}, {dm}] finite={finite} garbage past bound ignored={garbage_ok} "
             f"max|d| {err:.3g} beyond {TOL_FUSED} + {RTOL_FUSED}|ref| by {excess:.3g}")
    del ref, diff
    b_ms, b_by = fused_bound(b, t, h, dm, lens)
    res = {"shape": [b, t, dm], "heads": h, "lengths_sum": int(lens.sum()), "max_abs_err": err,
           "tolerance": [TOL_FUSED, RTOL_FUSED], "bound_ms": b_ms, "bound_by": b_by,
           "ms": time_ms(lambda: fused_attention.fused_qkv_mha(x, *params, lens, h), 20)}
    if timed:
        # the yardstick: one product against the stacked [3 * 768, 768]
        # weights, then SDPA with the key mask (two library calls)
        wqkv, bqkv = torch.cat(params[0::2]), torch.cat(params[1::2])
        mask = None
        if int(lens.min()) < t:
            mask = (torch.arange(t, device=DEV)[None, :] < lens[:, None])[:, None, None, :]

        def library():
            q, k, v = F.linear(x, wqkv, bqkv).view(b, t, 3, h, 64).permute(2, 0, 3, 1, 4)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        res["plain_ms"] = time_ms(
            lambda: fused_attention.fused_qkv_attention_ref(x, *params, lens, h), 5)
        res["library_ms"] = time_ms(library, 10)
    print(f"  fused [{b}, {t}, {dm}] keys {int(lens.sum())}: max|d| {err:.3g}  "
          f"kernel {res['ms']:.4f} ms  plain {res.get('plain_ms', float('nan')):.4f}  "
          f"F.linear + sdpa {res.get('library_ms', float('nan')):.4f}  "
          f"bound {b_ms:.4f} ({b_by})", flush=True)
    return res


def check_kernels() -> None:
    g = torch.Generator().manual_seed(0)
    rows = 96 * 511  # batch 96 of the 10 s bucket's 511 frames
    ln768 = check_layernorm(rows, 768, g)
    ln512 = check_layernorm(rows, 512, g)
    rng = np.random.default_rng(0)
    # the main path's 10 s files give 499 valid frames of 511; a few rows
    # ragged down to 1 key, and one full row
    main_lens = [511, 1] + list(rng.integers(2, 511, size=10)) + [499] * 84
    fl_main = check_flash(96, 511, main_lens, g, timed=True)
    fl_long = check_flash(8, 4095, [4095, 4000, 3001, 2048, 1025, 513, 64, 1], g, timed=False)
    report["kernels"]["layernorm_fwd"] = {"main": ln768, "d512": ln512}
    report["kernels"]["flash_attention_fwd"] = {"main": fl_main, "long": fl_long}
    bwd = {
        # the loss path: 32 crops of 16,384 samples, T' = 50, no padding
        "main": check_flash_bwd(LOSS_BATCH, 50, [50] * LOSS_BATCH, g, timed=True),
        # triplet training and the loss on 10 s clips: 24 rows of 160,000
        # samples, T' = 499
        "train": check_flash_bwd(LOSS10_BATCH, 499, [499] * LOSS10_BATCH, g, timed=True),
        "long": check_flash_bwd(8, 4095, [4095, 4000, 2047, 1025, 513, 64, 1, 0], g,
                                timed=True),
    }
    # every edge of the tiles (32-row streamed tiles; 32-row blocks up to
    # T = 64, 64-row beyond): a full row, a ragged one, 1 key and none
    for t in (1, 31, 32, 33, 63, 64, 65, 499):
        bwd[f"edge_T{t}"] = check_flash_bwd(4, t, [t, max(t // 2, 1), 1, 0], g, timed=False,
                                            kernel_times=False)
    for key, name in (("dq", "flash_attention_bwd_dq"), ("dkv", "flash_attention_bwd_dkv")):
        report["kernels"][name] = {shape: r[key] | {"shape": r["shape"]} for shape, r in bwd.items()}
    report["sdpa_grad_kernels_ms"] = {shape: r["library_kernels_ms"] for shape, r in bwd.items()
                                      if "library_kernels_ms" in r}
    report["kernels"]["fused_qkv_attention_fwd"] = {
        # the scoring path's 10 s bucket with its lengths, the loss crop,
        # and the longest input K4 takes, ragged down to one key
        "main": check_fused(96, 511, main_lens, g, timed=True),
        "loss": check_fused(LOSS_BATCH, 50, [50] * LOSS_BATCH, g, timed=True),
        "ragged": check_fused(8, 1024, [1024, 1023, 777, 513, 512, 64, 2, 1], g, timed=False),
    }
    # K1 at the loss crop (24 launches per loss step), and K4 where its
    # cluster first spans two 64-row chunks, ragged down to no key
    report["kernels"]["flash_attention_fwd"]["loss"] = check_flash(
        LOSS_BATCH, 50, [50] * LOSS_BATCH, g, timed=True)
    report["kernels"]["fused_qkv_attention_fwd"]["edge"] = check_fused(
        16, 65, [65] * 12 + [64, 33, 1, 0], g, timed=False)


# ---------------- phase 4: the main path ----------------


def speech_like(rng: np.random.Generator, n: int, noise) -> np.ndarray:
    """A voiced tone under a syllable-rate envelope plus white noise of
    amplitude ``noise`` (a float, or a (low, high) range to draw it from)."""
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 250)
    env = np.clip(np.sin(2 * np.pi * rng.uniform(0.5, 2) * t), 0, 1)
    x = 0.2 * np.sin(2 * np.pi * f0 * t) * env
    x += (noise if isinstance(noise, float) else rng.uniform(*noise)) * rng.standard_normal(n)
    return x.astype(np.float32)


def write_wavs(root: Path) -> tuple[str, str]:
    rng = np.random.default_rng(1234)
    n = int(SECONDS * SR)
    dirs = []
    for sub, count in (("nmr", N_NMR), ("deg", N_DEG)):
        p = root / sub
        p.mkdir()
        for i in range(count):
            x = speech_like(rng, n, 0.005 if sub == "nmr" else (0.01, 0.1))
            write_wav(str(p / f"{sub}_{i:03d}.wav"), x, SR, bits=16)
        dirs.append(str(p))
    return dirs[0], dirs[1]


def read_csv(path: Path) -> tuple[list, list, np.ndarray]:
    lines = path.read_text().splitlines()
    header = lines[0].split(",")
    rows = [ln.split(",") for ln in lines[1:]]
    return header, [r[0] for r in rows], np.array([[float(c) for c in r[1:]] for r in rows])


def check_csvs(out: Path, what: str) -> np.ndarray:
    h_avg, labels, avg = read_csv(out / "nomad_avg.csv")
    h_dm, labels_dm, dm = read_csv(out / "nomad_scores.csv")
    if h_avg != ["Test File", "NOMAD"] or avg.shape != (N_DEG, 1):
        fail(f"{what}: nomad_avg.csv header {h_avg}, shape {avg.shape}")
    if len(h_dm) != N_NMR + 1 or dm.shape != (N_DEG, N_NMR) or labels != labels_dm:
        fail(f"{what}: nomad_scores.csv header {h_dm}, shape {dm.shape}")
    if not (np.isfinite(avg).all() and np.isfinite(dm).all()):
        fail(f"{what}: non-finite scores")
    return dm


# kernel name -> layer of the model, first match wins (cuDNN's implicit-GEMM
# convolutions carry "gemm" in their names too, so convolutions go first)
KERNEL_GROUPS = (
    ("flash_attention_fwd", ("flash_fwd_kernel",)),
    ("fused_qkv_attention_fwd", ("fused_qkv_fwd_kernel",)),
    ("flash_attention_bwd", ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
    ("layernorm_fwd", ("layernorm_fwd_kernel",)),
    ("convolution", ("conv", "fprop", "implicit", "winograd", "cudnn")),
    ("matmul", ("gemm", "gemv", "cutlass", "sm90_xmma", "ampere")),
)


def profile_run(fn, key: str) -> None:
    """One warm run of fn under torch.profiler: device time by kernel
    group, and the device's busy share of the run's wall time, into
    report[key]."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, groups, by_name = [], {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.time_range.elapsed_us() <= 0:
            continue
        name = evt.name.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)),
                     "memcpy/memset" if "memcpy" in name or "memset" in name else "elementwise/other")
        groups[group] = groups.get(group, 0.0) + evt.time_range.elapsed_us()
        by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
        spans.append((evt.time_range.start, evt.time_range.end))
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):  # union of the device's busy intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    total = sum(groups.values())
    prof_info = {
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1 - busy / wall_us if spans else None,
        "device_ms_by_group": {g: t / 1e3 for g, t in sorted(groups.items(), key=lambda x: -x[1])},
        "top_kernels_ms": {n[:160]: t / 1e3 for n, t in sorted(by_name.items(), key=lambda x: -x[1])[:12]},
        # the host's side: CPU time by operator, its own time only
        "top_host_ops_self_ms": {
            e.key[:120]: e.self_cpu_time_total / 1e3 for e in sorted(
                prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]},
    }
    report[key] = prof_info
    if not spans:
        print(f"{key}: the profiler recorded no device activity (idle share not measured)")
        return
    print(f"{key}: run {wall_us / 1e3:.1f} ms under the profiler, device busy {busy / 1e3:.1f} ms, "
          f"idle share {prof_info['device_idle_share']:.3f}; device time by group: " + ", ".join(
              f"{g} {t:.1f} ms ({t * 1e3 / total:.1%})"
              for g, t in prof_info["device_ms_by_group"].items()), flush=True)


def reset_launches() -> None:
    flash_attention.launches = flash_attention.launches_bwd_dq = 0
    flash_attention.launches_bwd_dkv = layernorm.launches = fused_attention.launches = 0


def read_launches() -> dict:
    return {"flash_attention_fwd": flash_attention.launches,
            "flash_attention_bwd_dq": flash_attention.launches_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention.launches_bwd_dkv,
            "fused_qkv_attention_fwd": fused_attention.launches,
            "layernorm_fwd": layernorm.launches}


def launches_want(k1=0, k2=0, k3=0, k4=0, k5=0) -> dict:
    return {"flash_attention_fwd": k1, "flash_attention_bwd_dq": k2,
            "flash_attention_bwd_dkv": k3, "fused_qkv_attention_fwd": k4, "layernorm_fwd": k5}


def plain_config() -> Wav2Vec2Config:
    return Wav2Vec2Config.base(attention_impl="ref", layernorm_impl="ref")


def timed_passes(nomad: Nomad, waves: list) -> tuple[torch.Tensor, list]:
    """Three warm device passes (embed on decoded waveforms): the last
    embeddings and the pass times."""
    passes = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb = nomad.engine.embed_waves_device(waves)
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
    return emb, passes


def batch1_error(nomad: Nomad, waves: list, emb: torch.Tensor) -> float:
    """Batch-1 vs the padded batches: two files of the full batch of 96,
    two of the 12-file tail that runs padded to 16."""
    n = len(waves)
    return max((nomad.engine.embed_waves_device([waves[i]])[0] - emb[i]).abs().max().item()
               for i in (0, n // 2, n - 2, n - 1))


def run_main_path(card: str, tmp: Path, nmr: str, deg: str) -> tuple:
    """The K1 scoring path; returns the decoded waves, its embeddings and
    the plain path's."""
    total_s = (N_NMR + N_DEG) * SECONDS
    cli_out = tmp / "cli"
    cli_out.mkdir()
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch", "--mode", "dir", "--nmr", nmr, "--deg", deg,
         "--results_path", str(cli_out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    report["checks"]["cli_s"] = time.perf_counter() - t0
    if cli.returncode != 0:
        fail(f"CLI exit {cli.returncode}:\n{cli.stdout[-3000:]}\n{cli.stderr[-3000:]}")
    cli_dm = check_csvs(cli_out, "CLI")
    print(f"main path: CLI scored {N_DEG} x {N_NMR} files in {report['checks']['cli_s']:.1f} s "
          "(cold process: start, build load, weights, first pass)", flush=True)

    nomad = Nomad(device="cuda")
    api_out = tmp / "api"
    api_out.mkdir()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    nomad.predict("dir", nmr, deg, str(api_out))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = read_launches()
    batches = nomad.engine.batches
    report["launches"] = {"scoring": counts}
    report["checks"]["batches_per_pass"] = batches
    want = launches_want(k1=12 * batches, k5=26 * batches)
    if counts != want or batches == 0:
        fail(f"launch counts {counts} for {batches} batches (want {want})")
    api_dm = check_csvs(api_out, "API")
    if np.abs(api_dm - cli_dm).max() > 1e-3:
        fail(f"CLI and API scores differ by {np.abs(api_dm - cli_dm).max()}")
    print(f"main path: predict {cold_s:.2f} s cold, {batches} batches, launches {counts}",
          flush=True)

    # warm passes: whole predict (read + embed + cdist + CSVs), and the
    # device pass alone on decoded waveforms
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        nomad.predict("dir", nmr, deg, str(api_out))
        warm.append(time.perf_counter() - t0)
    paths = sorted(Path(nmr).iterdir()) + sorted(Path(deg).iterdir())
    waves = nomad.engine.load_waves([str(p) for p in paths])
    emb, passes = timed_passes(nomad, waves)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pred_s, pass_s = float(np.median(warm)), float(np.median(passes))
    report["main_path"] = {
        "files": N_NMR + N_DEG, "audio_s": total_s, "predict_warm_s": warm,
        "pass_s": passes, "wav_s_per_s_predict": total_s / pred_s,
        "wav_s_per_s_pass": total_s / pass_s, "peak_mem_gb": peak_gb, "card": card,
    }
    print(f"main path: warm predict {pred_s:.3f} s = {total_s / pred_s:.1f} wav-s/s; "
          f"device pass {pass_s:.3f} s = {total_s / pass_s:.1f} wav-s/s; "
          f"peak memory {peak_gb:.2f} GB  [{card}]", flush=True)
    profile_run(lambda: nomad.engine.embed_waves_device(waves), "profile")

    # the same weights on the plain path (plain attention and LayerNorm)
    plain_emb = Nomad(device="cuda", config=plain_config()).engine.embed_waves_device(waves)
    d_ref = (emb - plain_emb).abs().max().item()
    report["checks"]["kernel_vs_plain_path_emb"] = d_ref
    if not torch.isfinite(emb).all() or d_ref > TOL_REF_PATH:
        fail(f"kernel path vs plain path embeddings: max|d| {d_ref:.3g} > {TOL_REF_PATH}")
    d_b1 = batch1_error(nomad, waves, emb)
    report["checks"]["batch1_vs_padded_emb"] = d_b1
    if d_b1 > TOL_BATCH1:
        fail(f"batch-1 vs padded-batch embeddings: max|d| {d_b1:.3g} > {TOL_BATCH1}")
    print(f"main path: kernel vs plain path max|d| {d_ref:.3g} (<= {TOL_REF_PATH}); "
          f"batch-1 vs padded max|d| {d_b1:.3g} (<= {TOL_BATCH1})", flush=True)
    return waves, emb, plain_emb


def run_fused_scoring(card: str, tmp: Path, nmr: str, deg: str, waves: list,
                      k1_emb: torch.Tensor, plain_emb: torch.Tensor) -> None:
    """The fused path (``attention_impl="fused_qkv"``) on the same files:
    K4 in every block, no K1; then one file at T' = 1,023 (K4) and one at
    T' = 1,433 (past MAX_FUSED_T: K1), each against the plain path."""
    total_s = (N_NMR + N_DEG) * SECONDS
    nomad = Nomad(device="cuda", config=Wav2Vec2Config.base(attention_impl="fused_qkv"))
    out = tmp / "fused"
    out.mkdir()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    nomad.predict("dir", nmr, deg, str(out))
    torch.cuda.synchronize()
    counts = read_launches()
    batches = nomad.engine.batches
    report["launches"]["scoring_fused"] = counts
    want = launches_want(k4=12 * batches, k5=26 * batches)
    if counts != want or batches == 0:
        fail(f"fused path: launch counts {counts} for {batches} batches (want {want})")
    check_csvs(out, "fused API")
    emb, passes = timed_passes(nomad, waves)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pass_s = float(np.median(passes))
    d_plain = (emb - plain_emb).abs().max().item()
    d_k1 = (emb - k1_emb).abs().max().item()
    d_b1 = batch1_error(nomad, waves, emb)
    report["fused_path"] = {
        "files": N_NMR + N_DEG, "audio_s": total_s, "batches": batches, "pass_s": passes,
        "wav_s_per_s_pass": total_s / pass_s, "peak_mem_gb": peak_gb, "card": card,
        "vs_plain_path_emb": d_plain, "vs_k1_path_emb": d_k1, "batch1_vs_padded_emb": d_b1,
    }
    print(f"fused path: {batches} batches, launches {counts}; device pass {pass_s:.3f} s = "
          f"{total_s / pass_s:.1f} wav-s/s; peak memory {peak_gb:.2f} GB  [{card}]; max|d| "
          f"{d_plain:.3g} vs plain, {d_k1:.3g} vs K1 path (<= {TOL_REF_PATH}); batch-1 vs "
          f"padded {d_b1:.3g} (<= {TOL_BATCH1})", flush=True)
    if not torch.isfinite(emb).all() or max(d_plain, d_k1) > TOL_REF_PATH or d_b1 > TOL_BATCH1:
        fail(f"fused path embeddings: {d_plain:.3g} vs plain, {d_k1:.3g} vs K1 path, "
             f"{d_b1:.3g} batch-1 vs padded")
    profile_run(lambda: nomad.engine.embed_waves_device(waves), "profile_fused")

    plain = Nomad(device="cuda", config=plain_config())
    rng = np.random.default_rng(99)
    for n, frames in FUSED_SINGLE_FILES:
        if fused_attention.fused_supported(frames):
            want = launches_want(k4=12, k5=26)
        else:
            want = launches_want(k1=12, k5=26)
        wave = np.rint(np.clip(speech_like(rng, n, 0.02), -1, 1) * 32767).astype(np.int16)
        reset_launches()
        one = nomad.engine.embed_waves_device([wave])
        torch.cuda.synchronize()
        counts = read_launches()
        key = f"fused_single_T{frames}"
        report["launches"][key] = counts
        d = (one - plain.engine.embed_waves_device([wave])).abs().max().item()
        report["checks"][f"{key}_vs_plain_path_emb"] = d
        print(f"fused path: one file of {n} samples (T' = {frames}): launches {counts}, "
              f"max|d| {d:.3g} vs plain (<= {TOL_REF_PATH})", flush=True)
        if counts != want or not torch.isfinite(one).all() or d > TOL_REF_PATH:
            fail(f"fused path, one file of {n} samples: launches {counts} (want {want}), "
                 f"max|d| {d:.3g} vs plain")


def run_scoring_paths(card: str) -> None:
    with tempfile.TemporaryDirectory(prefix="nomad_smoke_") as tmp:
        tmp = Path(tmp)
        nmr, deg = write_wavs(tmp)
        waves, k1_emb, plain_emb = run_main_path(card, tmp, nmr, deg)
        run_fused_scoring(card, tmp, nmr, deg, waves, k1_emb, plain_emb)


# ---------------- phase 5: the loss path ----------------


def layer_signs(nomad: Nomad, est: torch.Tensor, clean: torch.Tensor) -> list:
    """sign(estimate layer - clean layer) for the 13 terms of the loss: the
    subgradient of |.| that the path's backward takes."""
    with torch.no_grad():
        return [torch.sign(a - c) for a, c in zip(nomad.model.forward_layers(est),
                                                  nomad.model.forward_layers(clean))]


def run_loss_path(card: str, key: str, config: Wav2Vec2Config, want: dict,
                  batch: int, samples: int) -> None:
    """One loss path on ``batch`` seeded clips of ``samples`` samples: its
    launch counts per step (``want``), loss and gradient against the plain
    path, forward(x, x) == 0, warm step time, peak memory and one profiled
    step, under ``report[key]``."""
    what, step_key = key.replace("_", " "), key.replace("path", "step")
    rng = np.random.default_rng(4321)
    clean_np = np.stack([speech_like(rng, samples, 0.005) for _ in range(batch)])
    est_np = clean_np + (0.03 * rng.standard_normal(clean_np.shape)).astype(np.float32)
    clean = torch.from_numpy(clean_np).to(DEV)
    est = torch.from_numpy(est_np).to(DEV).requires_grad_()
    nomad = Nomad(device="cuda", config=config)

    def step() -> torch.Tensor:
        est.grad = None
        loss = nomad.forward(est, clean)
        loss.backward()
        return loss

    torch.cuda.synchronize()
    reset_launches()
    loss = step()
    torch.cuda.synchronize()
    counts = read_launches()
    report["launches"][step_key] = counts
    if counts != want:
        fail(f"{what}: launch counts of a step {counts} (want {want})")
    grad = est.grad.detach().clone()
    value = loss.item()
    if not (np.isfinite(value) and bool(torch.isfinite(grad).all())) or grad.shape != est.shape:
        fail(f"{what}: loss {value}, gradient finite={bool(torch.isfinite(grad).all())} "
             f"shape {tuple(grad.shape)}")
    gmax = grad.abs().max().item()
    print(f"{what}: loss {value:.6g}, max|d loss/d est| {gmax:.4g}, launches {counts}",
          flush=True)

    # the same weights on the plain path, which holds every layer's
    # [B, 12, T', T'] probabilities for its backward
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain = Nomad(device="cuda", config=plain_config())
    est_p = est.detach().clone().requires_grad_()
    loss_p = plain.forward(est_p, clean)
    loss_p.backward()
    torch.cuda.synchronize()
    plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    d_loss = abs(loss_p.item() - value) / abs(loss_p.item())
    d_grad = (est_p.grad - grad).abs().max().item() / est_p.grad.abs().max().item()
    # an element of a layer difference within rounding of 0 can take the
    # other sign of |.| on the other path, which alone moves the gradient
    # by 2/numel of that element's Jacobian row: hold the plain path's
    # gradient under the kernel path's signs
    signs = layer_signs(nomad, est.detach(), clean)
    flips = sum(int((s_ != p_).sum()) for s_, p_ in zip(signs, layer_signs(plain, est.detach(), clean)))
    est_s = est.detach().clone().requires_grad_()
    with torch.no_grad():
        ref_clean = plain.model.forward_layers(clean)
    sum((s_ * (a - c)).mean() for s_, a, c in zip(
        signs, plain.model.forward_layers(est_s), ref_clean)).backward()
    d_grad_signs = (est_s.grad - grad).abs().max().item() / est_s.grad.abs().max().item()
    zero = nomad.forward(clean, clean).item()
    report[key] = {
        "shape": [batch, samples], "loss": value, "grad_max_abs": gmax,
        "plain_loss": loss_p.item(), "loss_rel_diff": d_loss,
        "grad_rel_diff_direct": d_grad, "grad_rel_diff_same_signs": d_grad_signs,
        "sign_flips": flips, "identity_loss": zero, "plain_path_peak_mem_gb": plain_peak_gb,
    }
    print(f"{what}: vs plain path loss rel {d_loss:.3g} (<= {TOL_LOSS_REL}); gradient "
          f"max|d|/max|g| {d_grad:.3g} direct, {d_grad_signs:.3g} under one sign pattern "
          f"(<= {TOL_GRAD_REL}; {flips} layer elements change sign); forward(x, x) = {zero}; "
          f"plain path peak memory {plain_peak_gb:.2f} GB", flush=True)
    if d_loss > TOL_LOSS_REL or d_grad_signs > TOL_GRAD_REL or (flips == 0 and d_grad > TOL_GRAD_REL):
        fail(f"{what} vs plain path: loss rel {d_loss:.3g}, gradient {d_grad:.3g} direct / "
             f"{d_grad_signs:.3g} same signs ({flips} flips)")
    if zero != 0.0:
        fail(f"{what}: forward(clean, clean) = {zero}, want exactly 0")
    del plain, loss_p, est_p, est_s, ref_clean, signs
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, host = [], []
    for _ in range(LOSS_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        host.append(time.perf_counter() - t0)  # the host's enqueue, before the wait
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = float(np.median(times))
    report[key] |= {"step_s": times, "step_median_s": step_s, "host_enqueue_s": host,
                    "peak_mem_gb": peak_gb, "card": card}
    print(f"{what}: warm step (forward + backward) median {step_s * 1e3:.2f} ms over "
          f"{LOSS_STEPS} (host enqueue median {np.median(host) * 1e3:.2f} ms), peak memory "
          f"{peak_gb:.2f} GB  [{card}]", flush=True)
    profile_run(step, f"profile_{step_key}")


def run_loss_paths(card: str) -> None:
    report.setdefault("launches", {})
    run_loss_path(card, "loss_path", Wav2Vec2Config.base(),
                  launches_want(k1=24, k2=12, k3=12, k5=52), LOSS_BATCH, LOSS_SAMPLES)
    # the fused path: K4 in both forwards, K1 + K2 + K3 in the backward's
    # recompute of the estimate's blocks
    run_loss_path(card, "loss_path_fused", Wav2Vec2Config.base(attention_impl="fused_qkv"),
                  launches_want(k1=12, k2=12, k3=12, k4=24, k5=52), LOSS_BATCH, LOSS_SAMPLES)
    # 10 s clips: K2 and K3 at [24, 499, 12, 64]
    run_loss_path(card, "loss_path_10s", Wav2Vec2Config.base(),
                  launches_want(k1=24, k2=12, k3=12, k5=52), LOSS10_BATCH, LOSS10_SAMPLES)


def main() -> None:
    parser = argparse.ArgumentParser(description="Smoke run of nomad_tpu_torch on one CUDA card")
    parser.add_argument("--only-loss", action="store_true",
                        help="phases 1 and 5 only; ends with the report line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this smoke runs on a CUDA card")
    set_exact_precision()
    card = card_info()
    if args.only_loss:
        run_loss_paths(card)
        print("report: " + json.dumps(report, default=float))
        return
    build_kernels()
    print("kernels vs plain versions on the card:", flush=True)
    check_kernels()
    run_scoring_paths(card)
    run_loss_paths(card)

    rows = []
    for name, src, replaces in (
        ("flash_attention_fwd", "nomad_tpu_torch/csrc/flash_attention.cu",
         "nomad_tpu/ops/flash_attention.py:37"),
        ("flash_attention_bwd_dq", "nomad_tpu_torch/csrc/flash_attention_bwd.cu",
         "nomad_tpu/ops/flash_attention.py:182"),
        ("flash_attention_bwd_dkv", "nomad_tpu_torch/csrc/flash_attention_bwd.cu",
         "nomad_tpu/ops/flash_attention.py:222"),
        ("fused_qkv_attention_fwd", "nomad_tpu_torch/csrc/fused_attention.cu",
         "nomad_tpu/ops/fused_attention.py:93"),
        ("layernorm_fwd", "nomad_tpu_torch/csrc/layernorm.cu", "nomad_tpu/ops/layernorm.py:31"),
    ):
        k = report["kernels"][name]
        m = k["main"]
        by_path = {path: c[name] for path, c in report["launches"].items()}
        row = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(v["max_abs_err"] for v in k.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        }
        if "train" in k:  # K2/K3: the loss crop above, [24, 499] (10 s clips) beside it
            row |= {f"train_{f}": k["train"][f]
                    for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        rows.append(row)
    print("report: " + json.dumps(report, default=float))
    print("kernels: " + "; ".join(
        f"{r['name']} max|d| {r['max_abs_err']:.3g} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f})"
        for r in rows))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
