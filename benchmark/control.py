"""The readings that a cell's limits are set from, on the card: for each
seed, set-up, a short window at the cell's own load, and the check's
numbers for the system and for the control (the reference in TF32 in the
system's place). One process for all seeds.

    python3 -m benchmark.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]
        [--control-seeds <n> ...] [--fault <name>]

``--fault`` plants one of ``faults.py``'s faults in the system first.
Prints one JSON line per seed and a last line with each number's largest
system reading and smallest control reading."""

from __future__ import annotations

import argparse
import json
import shutil
import sys

from benchmark import faults, harness


def readings(cell: str, seed: int, seconds: float, control: bool) -> dict:
    import torch

    run = harness.Run(cell, seed, seconds, False)
    entry = harness.load_module("entries", run.workload["entry"])
    try:
        entry.setup(run)
        entry.window(run)
        entry.release(run)
        torch.cuda.empty_cache()
        out = {"seed": seed, "system": entry.compare(run), "failed": run.failed,
               "attempted": run.attempted}
        if control:
            out["control"] = entry.compare(run, control=True)
        return out
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", default=None, choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    print(f"card: {harness.power_limit()}", file=sys.stderr, flush=True)
    if args.fault:
        faults.FAULTS[args.fault]()
    rows = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        row = readings(args.workload, seed, args.seconds, seed in args.control_seeds)
        rows.append(row)
        print("reading: " + json.dumps(row), flush=True)
    summary = {"fault": args.fault, "system_max": {}, "control_min": {}}
    for row in rows:
        for k, v in row["system"].items():
            summary["system_max"][k] = max(v, summary["system_max"].get(k, v))
        for k, v in row.get("control", {}).items():
            summary["control_min"][k] = min(v, summary["control_min"].get(k, v))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
