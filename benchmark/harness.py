"""The parts of a run that every cell shares: finding a cell's files by
name, the run's context, the import guard, the device's description and
the result line."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"
# whole top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "nomad_tpu")
# where the program's builds and kernel caches live: fixed paths inside the
# checkout, so that every run after a cell's first loads what it built
CACHE_DIRS = {"NOMAD_TPU_TORCH_CACHE_DIR": ROOT / "build" / "benchmark" / "nomad_tpu_torch",
              "TRITON_CACHE_DIR": ROOT / "build" / "benchmark" / "triton"}


def process_start() -> float:
    """The wall-clock time at which this process started (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (``nomad_tpu_torch`` is not ``nomad_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    for var, path in CACHE_DIRS.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def load_json(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json`` (kind: configs, workloads,
    traffic/mixes)."""
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (kind: entries, traffic)."""
    return importlib.import_module(f"benchmark.{kind}.{name}")


def load_metric_reader(name: str):
    """The reader of the per-layer metric ``name``:
    ``benchmark/metrics/<name>.py``, whose ``read(run)`` returns the value
    or None when the run has nothing to read."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path.relative_to(ROOT)} for metric {name}")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics._{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(cell: str, trace: bool, spec: dict | None = None) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    (``trace`` False) or its per-layer ones, from ``BENCHMARK.json``."""
    spec = spec if spec is not None else json.loads(BENCHMARK_JSON.read_text())
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    e2e_names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e_names else [])]


class Run:
    """One run of one cell: its files, its arguments and what its phases
    leave for the metric readers and the check."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", workload: dict | None = None,
                 config: dict | None = None, traffic: dict | None = None):
        self.t_process = process_start()
        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), float(seconds), trace
        self.workload = workload or load_json("workloads", cell)
        self.config = config or load_json("configs", self.workload["config"])
        self.traffic = traffic or load_json("traffic/mixes", self.workload["traffic"])
        self.device = device
        self.tmp = Path(tempfile.mkdtemp(prefix=f"bench-{cell}-"))
        self.phases: dict = {}      # set-up phase -> seconds
        self.e2e: dict = {}         # end-to-end metric -> value
        self.counters: dict = {}    # what the window counted, for the readers
        self.trace_summary = None   # trace.Summary of the traced window
        self.attempted = self.failed = 0
        self.window_s = None
        self.state: dict = {}       # the entry's own

    def phase(self, name: str):
        return _Phase(self, name)

    def sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()


class _Phase:
    def __init__(self, run: Run, name: str):
        self.run, self.name = run, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.run.sync()
        self.run.phases[self.name] = self.run.phases.get(self.name, 0.0) + (
            time.perf_counter() - self.t0)


def device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def power_limit() -> str:
    """The card's name and power limit from nvidia-smi, or why not."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"
