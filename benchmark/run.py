"""Run one cell of the benchmark on the card and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace 0|1

Set-up builds the system and the cell's traffic from the seed and warms
up every shape the cell uses; the window then measures for ``--seconds``
(``--trace 1`` under ``torch.profiler``); the check compares what the
window produced with the plain reference. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
standard error). Without a CUDA card, or with fewer cards than the cell
asks for, it exits with 2 and prints no result; so too when JAX or the
JAX package is loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import sys
import time

from benchmark import harness, trace
from benchmark.harness import Run, cell_metrics, forbidden_modules, load_metric_reader


class RunError(RuntimeError):
    pass


def _guard(when: str) -> None:
    bad = forbidden_modules()
    if bad:
        raise RunError(f"{when}: modules {bad} are loaded (JAX or the JAX package)")


def run_cell(cell: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             workload=None, config=None, traffic=None, spec=None, chips: int = 1) -> dict:
    """One run; returns the result object. ``device="cpu"``, with small
    ``workload``/``config``/``traffic`` dicts, is for the harness's own
    tests: the benchmark's command runs on the card only."""
    import torch

    run = Run(cell, seed, seconds, traced, device, workload, config, traffic)
    entry = harness.load_module("entries", run.workload["entry"])
    metrics_spec = cell_metrics(cell, traced, spec)
    try:
        with run.phase("cuda_init"):
            torch.zeros(1, device=device)
        entry.setup(run)
        run.sync()
        setup_s = time.time() - run.t_process
        _guard("end of set-up")
        with trace.traced(run):
            entry.window(run)
        _guard("window closed")
        dev = (harness.device_info(chips) if device == "cuda"
               else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
        if run.trace_summary is not None:
            dev.update(busy_s=run.trace_summary.busy_s, window_s=run.trace_summary.window_s)
        entry.release(run)
        if device == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        numbers = entry.compare(run)
        run.phases["check"] = time.perf_counter() - t
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)
    limits = run.workload["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = run.failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                      for c in checks.values())
    metrics = {}
    for m in metrics_spec:
        if traced:
            value = load_metric_reader(m["name"]).read(run)
        else:
            value = setup_s if m["name"] == "setup_s" else run.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if run.trace_summary is not None:
        result["breakdown"] = run.trace_summary.breakdown()
    result["setup_split_s"] = dict(run.phases, setup_s=setup_s)
    result["checks"] = checks  # the compared numbers come last
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    chips = harness.load_json("workloads", args.workload).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: {torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              f"CUDA card(s), the cell asks for {chips}; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    print(f"card: {harness.power_limit()}", file=sys.stderr, flush=True)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          chips=chips)
    except RunError as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    print("set-up split (s): " + json.dumps(result["setup_split_s"]), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
