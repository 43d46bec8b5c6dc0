"""Every file the benchmark names loads by name, every per-layer metric
has its reader, and a cell is added by adding files alone."""

import json
import re
import shutil

import pytest

from benchmark import harness
from benchmark.harness import BENCH, BENCHMARK_JSON, load_json, load_metric_reader, load_module
from benchmark.tests import tiny

SPEC = json.loads(BENCHMARK_JSON.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files_load(cfg):
    data = json.loads((harness.ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] == load_json("configs", cfg["name"])["name"]
    assert data["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_workload_files_load(cell):
    w = load_json("workloads", cell["name"])
    assert (w["config"], w["traffic"], w["why"]) == (cell["config"], cell["traffic"], cell["why"])
    entry = load_module("entries", w["entry"])
    assert all(callable(getattr(entry, f)) for f in ("setup", "window", "release", "compare"))
    mix = load_json("traffic/mixes", w["traffic"])
    assert callable(load_module("traffic", mix["kind"]).make)
    assert set(w["limits"]) and all(v >= 0 for v in w["limits"].values())
    reported = harness.cell_metrics(cell["name"], False, SPEC)
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    assert harness.cell_metrics(cell["name"], True, SPEC)


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_load(metric):
    assert callable(load_metric_reader(metric["name"]).read)
    moves = {m["name"]: m for m in SPEC["end_to_end"]}[metric["moves"]]
    assert set(metric["workloads"]) <= set(moves.get("workloads", metric["workloads"]))


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A throwaway configuration, traffic mix, cell and per-layer metric,
    each a new file, run on the CPU without an edit to any file."""
    added = [BENCH / "configs" / "throwaway-tiny.json",
             BENCH / "traffic" / "mixes" / "throwaway-corpus.json",
             BENCH / "workloads" / "throwaway-cell.json",
             BENCH / "metrics" / "throwaway.files_per_call.py"]
    assert not any(p.exists() for p in added)
    spec = json.loads(BENCHMARK_JSON.read_text())
    spec["workloads"].append({"name": "throwaway-cell", "config": "throwaway-tiny",
                              "traffic": "throwaway-corpus", "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("throwaway-cell")
    spec["per_layer"].append({"name": "throwaway.files_per_call", "unit": "files",
                              "better": "higher", "source": "program_counter", "layer": "engine",
                              "moves": "score_wav_s_per_s", "workloads": ["throwaway-cell"]})
    try:
        added[0].write_text(json.dumps(tiny.NOMAD | {"name": "throwaway-tiny", "reduced": []}))
        added[1].write_text(json.dumps(tiny.TRAFFIC["score-corpus"]))
        added[2].write_text(json.dumps(load_json("workloads", "score-corpus") | {
            "name": "throwaway-cell", "config": "throwaway-tiny",
            "traffic": "throwaway-corpus"}))
        added[3].write_text("def read(run):\n    return len(run.counters['files'])\n")
        from benchmark.run import run_cell

        for traced in (False, True):
            out = run_cell("throwaway-cell", 2**31 + 5, 0.5, traced, device="cpu", spec=spec)
            assert out["correct"], out["checks"]
            if traced:
                assert out["metrics"]["throwaway.files_per_call"]["value"] == 9
            else:
                assert set(out["metrics"]) == {"score_wav_s_per_s", "setup_s"}
    finally:
        for p in added:
            p.unlink(missing_ok=True)
        shutil.rmtree(BENCH / "metrics" / "__pycache__", ignore_errors=True)
