"""Wall-clock spans and device traces (counterpart of
``nomad_tpu.utils.profiling``).

  * :class:`Stopwatch` / :func:`timed`: aggregating span recorder with a
    process-global registry (``GLOBAL``; :func:`report` prints a table).
    Spans time the host: around asynchronous CUDA work they measure the
    enqueue unless the span waits for the device. The scoring engine
    records ``engine.native_ingest``, ``engine.submit`` and
    ``engine.collect``; ``serve``'s ``stats`` op reports them.
  * :func:`trace`: a ``torch.profiler`` trace of the host and, when a card
    is present, the device, written to ``log_dir`` (TensorBoard / Chrome
    trace format).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass


@dataclass
class _Span:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    bytes: int = 0
    items: int = 0


class Stopwatch:
    """Aggregating span recorder. Thread-safe."""

    def __init__(self):
        self._spans: dict[str, _Span] = defaultdict(_Span)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, items: int = 0, nbytes: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self._spans[name]
                s.count += 1
                s.total_s += dt
                s.max_s = max(s.max_s, dt)
                s.items += items
                s.bytes += nbytes

    def stats(self) -> dict[str, dict]:
        with self._lock:
            out = {}
            for name, s in sorted(self._spans.items()):
                d = {
                    "count": s.count,
                    "total_s": round(s.total_s, 4),
                    "mean_ms": round(1e3 * s.total_s / max(s.count, 1), 3),
                    "max_ms": round(1e3 * s.max_s, 3),
                }
                if s.items:
                    d["items_per_s"] = round(s.items / max(s.total_s, 1e-9), 1)
                if s.bytes:
                    d["MB_per_s"] = round(s.bytes / 1e6 / max(s.total_s, 1e-9), 1)
                out[name] = d
            return out

    def report(self) -> str:
        lines = [f"{'span':<32} {'count':>6} {'total_s':>9} {'mean_ms':>9}"]
        for name, d in self.stats().items():
            lines.append(f"{name:<32} {d['count']:>6} {d['total_s']:>9} {d['mean_ms']:>9}")
        return "\n".join(lines)

    def reset(self):
        with self._lock:
            self._spans.clear()


GLOBAL = Stopwatch()


def timed(name: str, items: int = 0, nbytes: int = 0):
    """``with timed('engine.submit', items=B):`` records into ``GLOBAL``."""
    return GLOBAL.span(name, items=items, nbytes=nbytes)


def report() -> str:
    return GLOBAL.report()


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` trace of the enclosed work into ``log_dir``; a
    no-op when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ):
        yield
