"""Directory scoring: whole ``Nomad.predict('dir', nmr_dir, deg_dir,
results_path)`` calls back to back, a closed loop with one client, through
the engine's native ingest with the file cache off (the default).

End-to-end: ``score_wav_s_per_s``, the seconds of degraded audio that the
calls completed in the window scored, over the wall time from the first
call's start to the last call's return. The check compares the raw
distance matrix of every call (before ``predict`` rounds it), every
degraded file against every NMR, with the reference's, and each returned table with the
rounding of its matrix."""

from __future__ import annotations

import gc
import time


from .. import system
from ..harness import load_module
from . import scoring

SR = 16000


def _call(run) -> tuple:
    st = run.state
    avg, dm = st["nomad"].predict("dir", st["corpus"]["nmr_dir"], st["corpus"]["deg_dir"],
                                  results_path=st["results"])
    return avg.values[:, 0].copy(), dm.values.copy()


def _counters(nomad) -> dict:
    from nomad_tpu_torch.utils.profiling import GLOBAL

    span = GLOBAL._spans.get("engine.native_ingest")
    return {"transfer": nomad.engine.transfer_stats(),
            "ingest_s": span.total_s if span else 0.0}


def setup(run) -> None:
    with run.phase("weights"):
        sd = system.nomad_weights(run, run.config)
        nomad = system.make_nomad(run, run.config, sd)
    with run.phase("traffic"):
        corpus = load_module("traffic", run.traffic["kind"]).make(run, run.traffic)
    results = run.tmp / "results"
    results.mkdir()
    run.state.update(sd=sd, nomad=nomad, corpus=corpus, results=str(results),
                     scored=scoring.capture_score_matrix(nomad))
    with run.phase("warmup"):
        _call(run)
    run.state["scored"].clear()


def window(run) -> None:
    st = run.state
    before = _counters(st["nomad"])
    tables = []
    t0 = time.perf_counter()
    while True:
        run.attempted += 1
        try:
            tables.append(_call(run))
        except Exception as e:  # noqa: BLE001 - a failed call is counted, not fatal
            run.failed += 1
            del st["scored"][len(tables):]
            print(f"predict failed: {type(e).__name__}: {e}", flush=True)
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0
    after = _counters(st["nomad"])
    corpus = st["corpus"]
    deg = sum(n for _, n in corpus["deg"])
    nmr = sum(n for _, n in corpus["nmr"])
    calls = len(tables)
    st["tables"] = tables
    run.e2e["score_wav_s_per_s"] = calls * deg / SR / run.window_s
    tb, ta = before["transfer"], after["transfer"]
    run.counters.update(
        calls=calls,
        files=[n for _, n in corpus["deg"] + corpus["nmr"]],
        audio_s=calls * (deg + nmr) / SR,
        samples_real=calls * (deg + nmr),
        samples_sent=(ta["h2d_bytes_int16"] - tb["h2d_bytes_int16"]) / 2
        + (ta["h2d_bytes_f32"] - tb["h2d_bytes_f32"]) / 4,
        ingest_s=after["ingest_s"] - before["ingest_s"])


def release(run) -> None:
    run.state.pop("nomad", None)
    gc.collect()


def compare(run, control: bool = False) -> dict:
    st = run.state
    deg = [path for path, _ in st["corpus"]["deg"]]
    scored = st["scored"]
    if not scored:
        return {"dm_gap": float("inf"), "table_gap": float("inf")}
    return {"dm_gap": scoring.dm_gap(run, scored, deg, control),
            "table_gap": 0.0 if control else scoring.table_gap(scored, st["tables"])}
