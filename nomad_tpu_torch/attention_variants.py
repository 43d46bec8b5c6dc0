"""Where K1 and K4 spend their time on the card: diagnostic variants.

    python -m nomad_tpu_torch.attention_variants

Builds copies of ``csrc/fused_attention.cu`` and ``csrc/flash_attention.cu``
with one part switched off, each by a text substitution that must match the
current source, into ``build/nomad_tpu_torch/variants/`` (nvcc, as
``ops/_build.py`` builds the real kernels), and times each against the
unchanged kernel at the paths' shapes with CUDA events:

* K4 ``phase1``: the projections only (the key loop runs over no key);
* K4 ``phase2``: the key loop only (no projection);
* K4 ``phase1_no_cluster``: the projections launched without the cluster
  attribute (implicit clusters of one block), which prices the cluster
  scheduling;
* K1 ``two_blocks``: K1 held to 2 blocks per SM by its shared memory, K4's
  occupancy.

The variants compute nothing useful and are never loaded by the port.
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
        ("if (max_active_clusters(cluster) == 0) return", "if (false) return")]),
    "k1": ("flash_attention.cu", []),
    "k1_two_blocks": ("flash_attention.cu", [
        ("kMinBlocks = 3;", "kMinBlocks = 2;"),
        ("kSmemBytes = sizeof(Smem);", "kSmemBytes = 113664;")]),
}
K1_SMEM = {"k1": flash_attention.FLASH_SMEM_BYTES, "k1_two_blocks": 113664}


def build() -> dict:
    """Each variant's library, built in parallel."""
    root = _build.BUILD_DIR / "variants"
    header = (_build.CSRC / "attention_tile.cuh").read_text()
    procs = {}
    for name, (src, subs) in VARIANTS.items():
        text = (_build.CSRC / src).read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in csrc/{src}")
            text = text.replace(old, new)
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "attention_tile.cuh").write_text(header)
        (d / src).write_text(text)
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
            fn.argtypes = [p] * 9 + [i] * 4 + [ll] * 3 + [ctypes.c_float] + [i] * 4 + [p]
            args = (x.data_ptr(), *(a.data_ptr() for a in params), lengths.data_ptr(),
                    o.data_ptr(), b, t, h, dm, *o.stride()[:3], 0.125, plan.cluster,
                    plan.rows_per_block, plan.tensors_per_block, plan.smem_bytes, stream)
            if fn(*args):
                raise RuntimeError(f"{name} [{b}, {t}]: launch refused")
            out["ms"][f"{name} [{b}, {t}, {dm}]"] = time_ms(lambda: fn(*args))
    b, t, lens = shapes[0]
    q, k, v = torch.randn(b, t, 3, h, 64, generator=g).to(dev).unbind(2)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    o, lse = torch.empty(b, t, h, 64, device=dev), torch.empty(b, h, t, device=dev)
    for name in ("k1", "k1_two_blocks"):
        fn = libs[name].nomad_flash_attention_fwd
        fn.argtypes = [p] * 6 + [i] * 4 + [ll] * 12 + [ctypes.c_float, i, p]
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b, t, h, 64, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o.stride()[:3], 0.125, K1_SMEM[name], stream)
        if fn(*args):
            raise RuntimeError(f"{name}: launch refused")
        out["ms"][f"{name} [{b}, {t}, {h}, 64]"] = time_ms(lambda: fn(*args))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
