"""The port's spans (``nomad_tpu_torch/utils/profiling.py``): host-clock
aggregates always; while a torch profiler records, ``record_function``
ranges on the trace's clock and a log of records, and on the card each
engine batch's device time. The file imports nothing of JAX, so the whole
of it also runs on the card:

    python -m pytest --noconftest tests/test_torch_spans.py
"""

import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nomad_tpu_torch import api as tapi
from nomad_tpu_torch.io import native, write_wav
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config, init_weights
from nomad_tpu_torch.utils import profiling

torch.set_num_threads(2)

EMB = 16
# the spans of one ``predict`` call through the native ingest
PREDICT_SPANS = {"predict", "predict.resolve", "engine.probe", "engine.plan",
                 "engine.host_batch", "engine.native_ingest", "engine.submit",
                 "engine.collect", "engine.device_wait", "predict.d2h", "predict.tables",
                 "predict.write_results"}
MS = 1_000_000  # ns


def _refuse(*args, **kwargs):
    raise AssertionError("a tracing call with the profiler off")


@pytest.fixture
def no_tracing(monkeypatch):
    """``record_function``, CUDA events and synchronisation raise."""
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", _refuse)


def _user_ranges(prof, names) -> list:
    return [e for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name() in names
            and e.device_type() == torch.autograd.DeviceType.CPU]


def _wavs(root: Path, n_deg: int, seconds: tuple, seed: int) -> tuple[str, str]:
    rng = np.random.default_rng(seed)
    nmr, deg = root / "nmr", root / "deg"
    nmr.mkdir()
    deg.mkdir()
    for i in range(3):
        write_wav(str(nmr / f"ref{i}.wav"), 0.2 * rng.standard_normal(int(16000 * seconds[0])),
                  16000)
    for i in range(n_deg):
        n = int(16000 * rng.uniform(*seconds[1:]))
        write_wav(str(deg / f"deg{i}.wav"), 0.3 * rng.standard_normal(n), 16000)
    return str(nmr), str(deg)


def _seeded_nomad(config: Wav2Vec2Config, device: str) -> tapi.Nomad:
    model = init_weights(NomadModel(config, emb_dim=EMB), seed=0)
    return tapi.Nomad(device=device, config=config, emb_dim=EMB, params=model.state_dict())


@pytest.fixture(scope="module")
def tiny_nomad():
    return _seeded_nomad(Wav2Vec2Config.tiny(), "cpu")


@pytest.fixture(scope="module")
def tiny_wavlm():
    return _seeded_nomad(Wav2Vec2Config.wavlm_large(
        conv_dim=(32, 32, 32), conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2), hidden_size=64,
        num_layers=2, num_heads=4, ffn_dim=128, pos_conv_kernel=16, pos_conv_groups=4,
        relative_position_buckets=32), "cpu")


@pytest.fixture(scope="module")
def wav_tree(tmp_path_factory):
    return _wavs(tmp_path_factory.mktemp("spans"), 5, (0.3, 0.1, 0.5), seed=25)


def _results(tmp_path: Path, name: str) -> str:
    out = tmp_path / name
    out.mkdir()
    return str(out)


def test_spans_with_the_profiler_off_keep_only_the_aggregates(no_tracing):
    sw = profiling.Stopwatch()
    with sw.span("a", items=10, nbytes=1000):
        with sw.span("b"):
            time.sleep(0.002)
    with sw.span("a", items=5):
        pass
    stats = sw.stats()
    assert list(stats) == ["a", "b"] and stats["a"]["count"] == 2 and stats["b"]["count"] == 1
    assert stats["a"]["total_s"] >= 0.002 and {"items_per_s", "MB_per_s"} <= set(stats["a"])
    assert (sw._spans["a"].items, sw._spans["a"].bytes) == (15, 1000)
    assert sw.events() == []
    # a CUDA device is no reason to record events while no profiler runs
    assert sw.device_timer(torch.device("cuda")) is None


def test_spans_under_the_profiler_are_ranges_on_its_clock():
    sw = profiling.Stopwatch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with sw.span("outer", items=3):
            torch.ones(4).sum()
            with sw.span("inner", nbytes=8):
                time.sleep(0.002)
        with sw.span("outer"):
            pass
    log = sw.events()
    assert [(r["name"], r["parent"], r["call"], r["items"], r["bytes"]) for r in log] == [
        ("inner", "outer", 1, 0, 8), ("outer", None, 1, 3, 0), ("outer", None, 2, 0, 0)]
    assert sw.stats()["outer"]["count"] == 2 and sw.stats()["inner"]["count"] == 1
    ranges = _user_ranges(prof, {"outer", "inner"})
    assert sorted(e.name() for e in ranges) == ["inner", "outer", "outer"]
    for rec in log:
        evt = min((e for e in ranges if e.name() == rec["name"]),
                  key=lambda e: abs(e.start_ns() - rec["start_ns"]))
        assert abs(evt.start_ns() - rec["start_ns"]) < MS
        assert abs(evt.start_ns() + evt.duration_ns() - rec["end_ns"]) < MS
    inner, first = log[0], log[1]
    assert first["start_ns"] <= inner["start_ns"] < inner["end_ns"] <= first["end_ns"]
    assert inner["end_ns"] - inner["start_ns"] >= 2 * MS


class _FakeEvent:
    """A CUDA event's timing interface on the host clock."""

    def __init__(self, enable_timing=False):
        self.t, self.done = None, False

    def record(self):
        self.t = time.perf_counter()

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


def test_events_resolve_device_pairs_and_reset_clears(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    sw = profiling.Stopwatch()
    with profile(activities=[ProfilerActivity.CPU]):
        with sw.span("call"):
            stop = sw.device_timer(torch.device("cuda"))
            time.sleep(0.002)
            stop("engine.batch", rows=3, samples=1200)
        assert sw.device_timer(torch.device("cpu")) is None
    sw.resolve()  # the device has not passed the pair: it stays pending
    assert [r["name"] for r in sw._log] == ["call"] and len(sw._pending) == 1
    log = sw.events()  # waits for it
    batch = log[-1]
    assert {k: batch[k] for k in ("name", "call", "rows", "samples")} == {
        "name": "engine.batch", "call": 1, "rows": 3, "samples": 1200}
    assert batch["device_ms"] >= 2.0 and not sw._pending
    log.clear()  # a copy
    assert len(sw.events()) == 2
    sw.reset()
    assert sw.events() == [] and sw.stats() == {}


def test_predict_with_the_profiler_off_records_nothing(tiny_nomad, wav_tree, tmp_path,
                                                       no_tracing):
    profiling.GLOBAL.reset()
    tiny_nomad.predict("dir", *wav_tree, results_path=_results(tmp_path, "out"))
    assert profiling.GLOBAL.events() == []
    stats = profiling.GLOBAL.stats()
    assert stats["predict"]["count"] == 1 and stats["engine.submit"]["count"] >= 1
    assert "engine.device_wait" not in stats and "predict.d2h" in stats


def test_predict_logs_its_span_tree_under_one_call(tiny_nomad, wav_tree, tmp_path):
    plain = tiny_nomad.predict("dir", *wav_tree, results_path=_results(tmp_path, "plain"))
    profiling.GLOBAL.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = tiny_nomad.predict("dir", *wav_tree, results_path=_results(tmp_path, "traced"))
    log = profiling.GLOBAL.events()
    # without the native library the batches are assembled on worker threads,
    # which the profiler does not record
    want = PREDICT_SPANS if native.available() else PREDICT_SPANS - {
        "engine.probe", "engine.native_ingest", "engine.host_batch"}
    assert {r["name"] for r in log} == want
    assert len({r["call"] for r in log}) == 1
    assert [r["name"] for r in log if r["parent"] is None] == ["predict"]
    assert all(r["parent"] == "predict" for r in log if r["name"] != "predict")
    root = log[-1]
    assert all(root["start_ns"] <= r["start_ns"] <= r["end_ns"] <= root["end_ns"] for r in log)
    assert {e.name() for e in _user_ranges(prof, want)} == want
    for p, t in zip(plain, traced, strict=True):
        assert p.index == t.index and p.columns == t.columns
        assert p.values.dtype == t.values.dtype and np.array_equal(p.values, t.values)
    for name in ("nomad_avg.csv", "nomad_scores.csv"):
        assert (tmp_path / "plain" / name).read_bytes() == (tmp_path / "traced" / name).read_bytes()


@pytest.mark.cuda
def test_engine_batches_device_time_is_the_traces_busy_time(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the batches' device time is read from CUDA events")
    from benchmark import trace

    nomad = _seeded_nomad(Wav2Vec2Config.base(), "cuda")
    # two full batches of ~10 s files (96 rows each), as the scoring cells
    # batch: at small batches the device waits for the host's launches inside
    # a batch, which its events count and the trace's busy time does not
    tree = _wavs(tmp_path, 192, (3.0, 9.0, 10.0), seed=26)
    with monkeypatch.context() as m:  # the profiler off: no event, range or wait
        for name, obj in (("record_function", torch.profiler), ("Event", torch.cuda),
                          ("synchronize", torch.cuda), ("synchronize", torch.cuda.Stream)):
            m.setattr(obj, name, _refuse)
        plain = nomad.predict("dir", *tree, results_path=_results(tmp_path, "plain"))
    profiling.GLOBAL.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        traced = nomad.predict("dir", *tree, results_path=_results(tmp_path, "traced"))
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    summary = trace.summarize(prof, window_s)
    batches = [r for r in profiling.GLOBAL.events() if r["name"] == "engine.batch"]
    device_s = sum(r["device_ms"] for r in batches) / 1e3
    seen = (device_s, summary.busy_s, summary.idle_by_host, summary.by_group)
    assert len(batches) == nomad.engine.transfer_stats()["batches"] // 2 > 0, seen
    assert abs(device_s - summary.busy_s) <= 0.05 * summary.busy_s, seen
    assert sum(r["samples"] for r in batches) == sum(
        native.native_probe(str(p))[1] for d in tree for p in Path(d).iterdir())
    # the spans' ends split the device's idle gaps: each stage takes its own label
    idle = summary.idle_by_host
    assert idle.get("engine.probe", 0) > 0 and idle.get("predict.write_results", 0) > 0, seen
    assert idle.get("python", 0) < 0.05 * sum(idle.values()), seen
    assert np.array_equal(plain[1].values, traced[1].values)


def test_rel_bias_span_with_the_profiler_off_keeps_only_its_aggregate(tiny_wavlm, tiny_nomad,
                                                                      no_tracing):
    """One ``model.rel_bias`` a WavLM forward, none a BASE one; with the
    profiler off no range, event or log record; the CPU's plain attention
    launches no K1r."""
    from nomad_tpu_torch.ops import flash_attention

    profiling.GLOBAL.reset()
    launches = flash_attention.launches_rel
    wav = torch.zeros(2, 4000)
    with torch.no_grad():
        tiny_wavlm.model(wav)
        tiny_wavlm.model(wav[:, :3000])
        tiny_nomad.model(wav)
    stats = profiling.GLOBAL.stats()
    assert stats["model.rel_bias"]["count"] == 2 and profiling.GLOBAL.events() == []
    assert flash_attention.launches_rel == launches


def test_rel_bias_span_under_the_profiler_in_predict(tiny_wavlm, wav_tree, tmp_path):
    """In a traced ``predict`` each engine batch's forward builds its bias
    table once, inside ``engine.submit``, as a range on the trace's clock."""
    tiny_wavlm.predict("dir", *wav_tree, results_path=_results(tmp_path, "warm"))
    profiling.GLOBAL.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tiny_wavlm.predict("dir", *wav_tree, results_path=_results(tmp_path, "traced"))
    log = profiling.GLOBAL.events()
    rel = [r for r in log if r["name"] == "model.rel_bias"]
    assert len(rel) == tiny_wavlm.engine.transfer_stats()["batches"] // 2 > 0
    assert all(r["parent"] == "engine.submit" and r["end_ns"] > r["start_ns"] for r in rel)
    assert len(_user_ranges(prof, {"model.rel_bias"})) == len(rel)
