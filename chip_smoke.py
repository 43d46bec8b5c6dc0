"""Smoke run of nomad_tpu_torch on one CUDA card: build, check, time, score.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from nomad_tpu_torch/csrc with nvcc and
     print ptxas' registers, shared memory and spills;
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes, and time kernel, plain version and one PyTorch
     call computing the same function (a yardstick the port never calls),
     beside the least time the card could take (bound);
  4. the main path at full wav2vec 2.0 BASE width with seeded weights:
     ``python -m nomad_tpu_torch --mode dir`` on 8 + 100 seeded 10 s WAVs,
     then ``Nomad(device="cuda").predict`` in process with the kernel
     launch counts read around it; embeddings held against the plain path
     on the same card and against batch-1 runs; warm throughput, pass time
     and peak memory; one warm pass under torch.profiler (device time by
     kernel group, the device's idle share);
  5. the kernels' JSON line, the card line, and the last line
     ``{"ok": true, "device": {...}}``.
Exits non-zero, and prints no result, without a CUDA card or outside a
checkout of the repository. Every measurement is also printed as one
JSON object on the line that starts with "report: ".
"""

from __future__ import annotations

import json
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
from nomad_tpu_torch.ops import _build, flash_attention, layernorm

ROOT = Path(__file__).resolve().parent
# H100 SXM data-sheet peaks (at the 700 W limit): HBM rate, f32 without
# tensor cores ("exact" forbids TF32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
SR = 16000
N_NMR, N_DEG, SECONDS = 8, 100, 10.0
TOL_LN, TOL_FLASH = 1e-5, 2e-5  # f32, sums in another order than the plain version
TOL_REF_PATH, TOL_BATCH1 = 1e-4, 1e-5

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
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
                print(f"  ptxas[{name}]: {line.strip()}")


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


# ---------------- phase 4: the main path ----------------


def write_wavs(root: Path) -> tuple[str, str]:
    rng = np.random.default_rng(1234)
    n = int(SECONDS * SR)
    t = np.arange(n) / SR
    dirs = []
    for sub, count in (("nmr", N_NMR), ("deg", N_DEG)):
        p = root / sub
        p.mkdir()
        for i in range(count):
            f0 = rng.uniform(90, 250)
            env = np.clip(np.sin(2 * np.pi * rng.uniform(0.5, 2) * t), 0, 1)
            x = 0.2 * np.sin(2 * np.pi * f0 * t) * env
            x += (0.005 if sub == "nmr" else rng.uniform(0.01, 0.1)) * rng.standard_normal(n)
            write_wav(str(p / f"{sub}_{i:03d}.wav"), x.astype(np.float32), SR, bits=16)
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
    ("layernorm_fwd", ("layernorm_fwd_kernel",)),
    ("convolution", ("conv", "fprop", "implicit", "winograd", "cudnn")),
    ("matmul", ("gemm", "gemv", "cutlass", "sm90_xmma", "ampere")),
)


def profile_pass(nomad: Nomad, waves: list) -> None:
    """One warm device pass under torch.profiler: device time by kernel
    group, and the device's busy share of the pass's wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        nomad.engine.embed_waves_device(waves)
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
    }
    report["profile"] = prof_info
    if not spans:
        print("profile: the profiler recorded no device activity (idle share not measured)")
        return
    print(f"profile: pass {wall_us / 1e3:.1f} ms under the profiler, device busy {busy / 1e3:.1f} ms, "
          f"idle share {prof_info['device_idle_share']:.3f}; device time by group: " + ", ".join(
              f"{g} {t:.1f} ms ({t * 1e3 / total:.1%})"
              for g, t in prof_info["device_ms_by_group"].items()), flush=True)


def run_main_path(card: str) -> None:
    with tempfile.TemporaryDirectory(prefix="nomad_smoke_") as tmp:
        tmp = Path(tmp)
        nmr, deg = write_wavs(tmp)
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
        flash_attention.launches = 0
        layernorm.launches = 0
        t0 = time.perf_counter()
        nomad.predict("dir", nmr, deg, str(api_out))
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        counts = {"flash_attention_fwd": flash_attention.launches,
                  "layernorm_fwd": layernorm.launches}
        batches = nomad.engine.batches
        report["launches"] = counts
        report["checks"]["batches_per_pass"] = batches
        if counts["flash_attention_fwd"] != 12 * batches or counts["layernorm_fwd"] != 26 * batches \
                or batches == 0:
            fail(f"launch counts {counts} for {batches} batches (want 12 and 26 per batch)")
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
        passes = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            emb = nomad.engine.embed_waves_device(waves)
            torch.cuda.synchronize()
            passes.append(time.perf_counter() - t0)
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
        profile_pass(nomad, waves)

        # the same weights on the plain path (plain attention and LayerNorm)
        ref = Nomad(device="cuda", config=Wav2Vec2Config.base(attention_impl="ref",
                                                                layernorm_impl="ref"))
        ref_emb = ref.engine.embed_waves_device(waves)
        d_ref = (emb - ref_emb).abs().max().item()
        report["checks"]["kernel_vs_plain_path_emb"] = d_ref
        if not torch.isfinite(emb).all() or d_ref > TOL_REF_PATH:
            fail(f"kernel path vs plain path embeddings: max|d| {d_ref:.3g} > {TOL_REF_PATH}")
        del ref
        # batch-1 vs the padded batches: two files of the full batch of 96,
        # two of the 12-file tail that runs padded to 16
        d_b1 = 0.0
        n = len(waves)
        for i in (0, n // 2, n - 2, n - 1):
            one = nomad.engine.embed_waves_device([waves[i]])
            d_b1 = max(d_b1, (one[0] - emb[i]).abs().max().item())
        report["checks"]["batch1_vs_padded_emb"] = d_b1
        if d_b1 > TOL_BATCH1:
            fail(f"batch-1 vs padded-batch embeddings: max|d| {d_b1:.3g} > {TOL_BATCH1}")
        print(f"main path: kernel vs plain path max|d| {d_ref:.3g} (<= {TOL_REF_PATH}); "
              f"batch-1 vs padded max|d| {d_b1:.3g} (<= {TOL_BATCH1})", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this smoke runs on a CUDA card")
    set_exact_precision()
    card = card_info()
    build_kernels()
    print("kernels vs plain versions on the card:", flush=True)
    check_kernels()
    run_main_path(card)

    rows = []
    for name, src, replaces in (
        ("flash_attention_fwd", "nomad_tpu_torch/csrc/flash_attention.cu",
         "nomad_tpu/ops/flash_attention.py:37"),
        ("layernorm_fwd", "nomad_tpu_torch/csrc/layernorm.cu", "nomad_tpu/ops/layernorm.py:31"),
    ):
        k = report["kernels"][name]
        m = k["main"]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": report["launches"][name],
            "max_abs_err": max(v["max_abs_err"] for v in k.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        })
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
