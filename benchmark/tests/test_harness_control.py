"""On the card: each cell's control (the reference in TF32 in the
system's place) fails the cell's limits while the system passes them, at
the cells' widths and a size a test run holds. ``python -m pytest
benchmark/tests -m cuda`` on the card; here they skip."""

import copy
import shutil

import pytest

from benchmark import harness
from benchmark.harness import load_json

SMALL = {
    "score-corpus": {"groups": [
        {"dir": "deg", "count": 24, "seconds": [1.5, 20.0], "noise": [0.01, 0.1]},
        {"dir": "nmr", "count": 10, "seconds": [2.0, 4.0], "noise": 0.005}]},
    "loss-10s": {"batch": 4, "pool": 2},
    "se-train": {"count": 96},
}


def _readings(cell: str, seed: int) -> tuple:
    import torch

    w = load_json("workloads", cell)
    traffic = copy.deepcopy(load_json("traffic/mixes", w["traffic"])) | SMALL[cell]
    config = copy.deepcopy(load_json("configs", w["config"]))
    if cell == "se-train":
        config["recipe"]["train_bs"] = 8
    run = harness.Run(cell, seed, 3.0, False, "cuda", config=config, traffic=traffic)
    entry = harness.load_module("entries", w["entry"])
    try:
        entry.setup(run)
        entry.window(run)
        entry.release(run)
        torch.cuda.empty_cache()
        return entry.compare(run), entry.compare(run, control=True), w["limits"]
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_and_the_system_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32, which only the card has")
    harness.set_cache_dirs()
    system, control, limits = _readings(cell, 2**31 + 99)
    assert all(system[k] <= limits[k] for k in limits), (system, limits)
    assert any(control[k] > limits[k] for k in limits), (control, limits)
