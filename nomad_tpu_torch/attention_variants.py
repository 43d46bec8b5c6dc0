"""Where the attention kernels spend their time on the card: diagnostic
variants.

    python -m nomad_tpu_torch.attention_variants

Builds copies of ``csrc/fused_attention.cu``, ``csrc/flash_attention.cu``
and ``csrc/flash_attention_bwd.cu`` (and of the headers they include) with
one part switched off, each by a text substitution that must match the
current source, into ``build/nomad_tpu_torch/variants/`` (nvcc, as
``ops/_build.py`` builds the real kernels), and times each against the
unchanged kernel at the paths' shapes with CUDA events:

* K4 ``phase1``: the projections only (the key loop runs over no key);
* K4 ``phase2``: the key loop only (no projection);
* K4 ``phase1_no_cluster``: the projections launched without the cluster
  attribute (implicit clusters of one block), which prices the cluster
  scheduling;
* K1 ``two_blocks``: K1 held to 2 blocks per SM by its shared memory, K4's
  occupancy;
* K2 + K3 ``two_blocks``: both held to 2 blocks per SM by their shared
  memory (the plan gives 3), which prices the occupancy;
* K2 + K3 ``rows16``: 16-row blocks at the loss crop (the plan takes 32),
  one row a thread: 2.9 waves of the card instead of 1.94;
* K2 + K3 ``no_resident_loads``: the tile's loads of its resident rows
  taken out of the column loop (wrong sums), which prices half of the
  score loop's shared-memory loads.

Each entry is called with ``bf16_io`` 0 (the f32 flavours). The variants
compute nothing useful and are never loaded by the port.
Prints one JSON object with the times (ms) and the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

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
    "k1": ("flash_attention.cu", []),
    "k1_two_blocks": ("flash_attention.cu", [
        ("kMinBlocks = 3;", "kMinBlocks = 2;"),
        ("kSmemBytes = sizeof(Smem);", "kSmemBytes = 113664;")]),
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
HEADERS = ("attention_tile.cuh", "attention_bwd_tile.cuh")


def build() -> dict:
    """Each variant's library, built in parallel."""
    root = _build.BUILD_DIR / "variants"
    procs = {}
    for name, (src, subs) in VARIANTS.items():
        texts = {f: (_build.CSRC / f).read_text() for f in (src, *HEADERS)}
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("attention_variants: needs a CUDA card")
    dev = torch.device("cuda")
    libs = build()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    g = torch.Generator().manual_seed(0)
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
           torch.cuda.get_device_name(0), "ms": {}}
    h, dm = 12, 768
    for b, t, lens in shapes:
        x = torch.randn(b, t, dm, generator=g).to(dev)
        params = [a.to(dev) for _ in range(3) for a in (
            torch.randn(dm, dm, generator=g) / dm**0.5, 0.1 * torch.randn(dm, generator=g))]
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        plan = fused_attention.fused_launch_plan(t, b, h)
        o = torch.empty(b, t, h, 64, device=dev)
        for name in ("k4", "k4_phase1", "k4_phase2", "k4_phase1_no_cluster"):
            fn = libs[name].nomad_fused_qkv_attention_fwd
            fn.argtypes = [p] * 9 + [i] * 4 + [ll] * 3 + [ctypes.c_float] + [i] * 5 + [p]
            args = (x.data_ptr(), *(a.data_ptr() for a in params), lengths.data_ptr(),
                    o.data_ptr(), b, t, h, dm, *o.stride()[:3], 0.125, plan.cluster,
                    plan.rows_per_block, plan.tensors_per_block, plan.smem_bytes, 0, stream)
            if fn(*args):
                raise RuntimeError(f"{name} [{b}, {t}]: launch refused")
            out["ms"][f"{name} [{b}, {t}, {dm}]"] = time_ms(lambda: fn(*args))
    b, t, lens = shapes[0]
    q, k, v = torch.randn(b, t, 3, h, 64, generator=g).to(dev).unbind(2)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    o, lse = torch.empty(b, t, h, 64, device=dev), torch.empty(b, h, t, device=dev)
    for name in ("k1", "k1_two_blocks"):
        fn = libs[name].nomad_flash_attention_fwd
        fn.argtypes = [p] * 6 + [i] * 4 + [ll] * 12 + [ctypes.c_float, i, i, p]
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b, t, h, 64, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o.stride()[:3], 0.125, K1_SMEM[name], 0, stream)
        if fn(*args):
            raise RuntimeError(f"{name}: launch refused")
        out["ms"][f"{name} [{b}, {t}, {h}, 64]"] = time_ms(lambda: fn(*args))
    # K2 + K3 at the 10 s clips' [24, 499] and the loss crop's [32, 50]
    for b, t in ((24, 499), (32, 50)):
        q, k, v = torch.randn(b, t, 3, h, 64, generator=g).to(dev).unbind(2)
        lengths = torch.full((b,), t, dtype=torch.int32, device=dev)
        o, lse = flash_attention.mha_flash(q, k, v, lengths)
        do, di, lengths = flash_attention._bwd_args(
            q, k, v, o, lse, torch.randn(b, t, h, 64, generator=g).to(dev), lengths)
        dq, dk, dv = (torch.empty(b, t, h, 64, device=dev) for _ in range(3))
        plan = flash_attention.flash_bwd_launch_plan(t, b, h)["dq"]
        for name in ("k23", "k23_two_blocks", "k23_rows16", "k23_no_resident_loads"):
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
