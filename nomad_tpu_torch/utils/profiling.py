"""Spans of the port (counterpart of ``nomad_tpu.utils.profiling``).

  * :class:`Stopwatch` / :func:`timed`: aggregating span recorder with a
    process-global registry (``GLOBAL``; ``stats()`` sums each span's
    count, time, items and bytes). Spans time the host: around
    asynchronous CUDA work they measure the enqueue unless the span waits
    for the device. ``serve``'s ``stats`` op reports the aggregates.
  * While a ``torch.profiler`` records (``torch.autograd._profiler_enabled()``,
    the one check a span makes when it does not), a span also opens a
    ``record_function`` range, so that the profiler's trace shows it beside
    the device's operations on one clock, and appends a record to an
    in-memory log (``events()``): ``name``, ``start_ns`` and ``end_ns``
    (``time.time_ns()``: the epoch nanoseconds of the kineto events),
    ``parent`` (the enclosing span's name), ``call`` (the sequence number
    of the outermost span, which its spans share), ``items`` and ``bytes``.
    At each of its two ends, where the current CUDA stream has nothing
    queued, the span launches one empty kernel on it (``_mark_idle_device``):
    an idle gap of the device's trace then lies within one span, and the
    trace's labelling of each gap by the host range at its midpoint names
    that span, where one gap from the end of a call to the next call's
    first batch would otherwise take a single label.
    ``device_timer`` times work on a CUDA device with a pair of events on
    its current stream; the pair enters the log as a record of ``call``,
    ``device_ms`` and the caller's counts once ``resolve()`` finds it done
    (``events()`` waits for it).

Spans of a scoring call (``Nomad.predict``), in order:

  ``predict``                 the whole call, the outermost span
  ``predict.resolve``         argument checks, both sets' path listings
  ``engine.probe``            ``native_probe`` of every file
  ``engine.plan``             the batch plan
  ``engine.host_batch``       each batch's pinned allocation; its padding
                              rows and Python fallback decode
  ``engine.native_ingest``    the C++ decode into the pinned batch
  ``engine.submit``           H2D copy and the forward's enqueue
  ``engine.collect``          the stack of the embeddings' rows (enqueue)
  ``engine.encode``           the wire codec's frame (``wire_codec="on"``)
  ``engine.device_wait``      profiling only: the wait for the embeddings
  ``predict.d2h``             the distance matrix's copy to the host
  ``predict.tables``          ``build_result_tables``
  ``predict.write_results``   the two CSVs

and, profiling on a CUDA device only, one ``engine.batch`` device record
per batch (from the H2D copy to the forward's last operation; ``rows``,
``bsz``, ``blen``, ``samples``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from dataclasses import dataclass

import torch

profiling_active = torch.autograd._profiler_enabled


def _mark_idle_device() -> None:
    """Launch one empty kernel on the current CUDA stream if the stream is
    idle (profiling only: it ends the device's idle gap at this instant)."""
    if torch.cuda.is_initialized() and torch.cuda.current_stream().query():
        torch.cuda._sleep(0)


@dataclass
class _Span:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    bytes: int = 0
    items: int = 0


class Stopwatch:
    """Aggregating span recorder and, while profiling, the span log.
    Thread-safe: each thread nests its own spans. The profiler records
    the thread that started it, so a worker thread's spans keep only their
    aggregates."""

    def __init__(self):
        self._spans: dict[str, _Span] = defaultdict(_Span)
        self._lock = threading.Lock()
        self._log: list[dict] = []
        self._pending: list[tuple] = []  # (start event, end event, record)
        self._local = threading.local()
        self._calls = itertools.count(1)

    @contextlib.contextmanager
    def span(self, name: str, items: int = 0, nbytes: int = 0):
        if profiling_active():
            with self._logged(name, items, nbytes):
                yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._add(name, time.perf_counter() - t0, items, nbytes)

    @contextlib.contextmanager
    def _logged(self, name: str, items: int, nbytes: int):
        stack = self._stack()
        parent = stack[-1] if stack else None
        rec = {"name": name, "parent": parent and parent["name"],
               "call": parent["call"] if parent else next(self._calls),
               "items": items, "bytes": nbytes}
        stack.append(rec)
        t0 = time.perf_counter()
        rec["start_ns"] = time.time_ns()
        try:
            with torch.profiler.record_function(name):
                _mark_idle_device()
                yield
                _mark_idle_device()
        finally:
            rec["end_ns"] = time.time_ns()
            self._add(name, time.perf_counter() - t0, items, nbytes)
            stack.pop()
            with self._lock:
                self._log.append(rec)

    def _stack(self) -> list:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def _add(self, name: str, dt: float, items: int, nbytes: int) -> None:
        with self._lock:
            s = self._spans[name]
            s.count += 1
            s.total_s += dt
            s.max_s = max(s.max_s, dt)
            s.items += items
            s.bytes += nbytes

    def device_timer(self, device: torch.device):
        """While profiling on a CUDA device: record a timing event on the
        device's current stream and return ``stop(name, **counts)``, which
        records the closing event and keeps the pair until ``resolve``.
        Otherwise None, and nothing is recorded."""
        if device.type != "cuda" or not profiling_active():
            return None
        stack = self._stack()
        call = stack[-1]["call"] if stack else None
        start = torch.cuda.Event(enable_timing=True)
        start.record()

        def stop(name: str, **counts) -> None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            with self._lock:
                self._pending.append((start, end, {"name": name, "call": call, **counts}))

        return stop

    def resolve(self, wait: bool = False) -> None:
        """Move the event pairs the device has passed into the log, as
        ``device_ms`` records; with ``wait``, every pair."""
        with self._lock:
            pending, self._pending = self._pending, []
        done, left = [], []
        for start, end, rec in pending:
            if wait:
                end.synchronize()
            elif not end.query():
                left.append((start, end, rec))
                continue
            done.append(rec | {"device_ms": start.elapsed_time(end)})
        with self._lock:
            self._log.extend(done)
            self._pending[:0] = left

    def events(self) -> list[dict]:
        """The log: a record for each span closed and each device interval
        timed while profiling (waits for the device's pending ones)."""
        self.resolve(wait=True)
        with self._lock:
            return list(self._log)

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

    def reset(self):
        with self._lock:
            self._spans.clear()
            self._log.clear()
            self._pending.clear()


GLOBAL = Stopwatch()


def timed(name: str, items: int = 0, nbytes: int = 0):
    """``with timed('engine.submit', items=B):`` records into ``GLOBAL``."""
    return GLOBAL.span(name, items=items, nbytes=nbytes)
