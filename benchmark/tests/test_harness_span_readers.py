"""The readers of the program's spans on a fake traced run: a
``trace.Summary`` with labelled idle gaps and a span log in place of the
program's; None where the run has nothing to read."""

from types import SimpleNamespace

import pytest

from benchmark.harness import load_metric_reader
from benchmark.trace import Summary
from nomad_tpu_torch.utils import profiling

READERS = ("step.device_ms_per_wav_s.score", "ingest.idle_ms_per_call.score",
           "engine.results_idle_ms_per_call.score")
IDLE = {"python": 0.4, "gaps under 50 us": 0.05, "predict.resolve": 0.02,
        "engine.probe": 0.03, "engine.plan": 0.001, "engine.host_batch": 0.004,
        "engine.native_ingest": 0.5, "engine.submit": 0.007, "predict.d2h": 0.01,
        "predict.tables": 0.002, "predict.write_results": 0.9, "aten::copy_": 0.02}
LOG = [{"name": "predict", "parent": None, "call": c} for c in (1, 2)] + [
    {"name": "engine.batch", "call": c, "device_ms": ms, "rows": 96}
    for c, ms in ((1, 300.0), (1, 450.0), (2, 310.0), (2, 440.0))]


def _run(counters, log=LOG, traced=True):
    summary = Summary(30.0, 33.0, {"convolution": 20.0}, IDLE) if traced else None
    return SimpleNamespace(trace_summary=summary, counters=counters), SimpleNamespace(
        events=lambda: list(log))


def _read(monkeypatch, name, run, program):
    monkeypatch.setattr(profiling, "GLOBAL", program)
    return load_metric_reader(name).read(run)


def test_the_readers_on_a_traced_run(monkeypatch):
    run, program = _run({"calls": 2, "audio_s": 2500.0})
    assert _read(monkeypatch, READERS[0], run, program) == pytest.approx(1500.0 / 2500.0)
    assert _read(monkeypatch, READERS[1], run, program) == pytest.approx(
        1e3 * (0.02 + 0.03 + 0.001 + 0.004 + 0.5) / 2)
    assert _read(monkeypatch, READERS[2], run, program) == pytest.approx(
        1e3 * (0.01 + 0.002 + 0.9) / 2)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["untraced", "no log", "empty log", "no calls"])
def test_the_readers_give_none_where_nothing_is_read(monkeypatch, name, case):
    counters = {} if case == "no calls" else {"calls": 2, "audio_s": 2500.0}
    run, program = _run(counters, log=[] if case == "empty log" else LOG,
                        traced=case != "untraced")
    if case == "no log":  # a program that keeps no span log, as before it had one
        program = SimpleNamespace(_spans={})
    assert _read(monkeypatch, name, run, program) is None
