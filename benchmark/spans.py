"""What the readers of the program's own spans share: the span log of the
traced window (``nomad_tpu_torch.utils.profiling.GLOBAL.events()``, written
only while the profiler records) and the device's idle seconds by the
innermost span the host was in (``trace.Summary.idle_by_host``, whose
labels are the spans' ``record_function`` names). Each returns None where
the run has nothing to read: no trace, or a program that keeps no log."""

from __future__ import annotations


def program_log(run):
    """The program's span log for a traced run, else None."""
    if run.trace_summary is None:
        return None
    from nomad_tpu_torch.utils import profiling

    events = getattr(profiling.GLOBAL, "events", None)
    return events() if events is not None else None


def idle_ms_per_call(run, spans: tuple):
    """The device's idle ms under ``spans`` per completed ``predict`` call,
    where the log holds the calls' spans."""
    log, calls = program_log(run), run.counters.get("calls")
    if not calls or not any(r["name"] == "predict" for r in log or ()):
        return None
    idle = run.trace_summary.idle_by_host
    return 1e3 * sum(idle.get(s, 0.0) for s in spans) / calls
