"""Each cell's check fails a run whose timed path is broken underneath:
the tiny cell on the CPU, the chip's look skipped, once for each fault
the cell can have; and passes the sound run. The SE faults break the step
from the first call, and again only from the window's first step on (the
tiny cell's epoch 0, set-up's, has three steps)."""

import pytest

from benchmark import faults
from benchmark.run import run_cell
from benchmark.tests import tiny

WINDOW = {"after": 3}  # sound through set-up's epoch 0 of the tiny cell
CASES = [(None, "score-corpus", {}), ("altered_answer", "score-corpus", {}),
         (None, "loss-10s", {}), ("half_batch_loss", "loss-10s", {}),
         (None, "se-train", {}), ("half_batch_step", "se-train", {}),
         ("unchanged_state", "se-train", {}), ("half_batch_step", "se-train", WINDOW),
         ("unchanged_state", "se-train", WINDOW)]


@pytest.mark.parametrize("fault,cell,kw", CASES,
                         ids=[f"{c}-{f or 'sound'}{'-window' if kw else ''}" for f, c, kw in CASES])
def test_check_fails_each_fault(fault, cell, kw, monkeypatch):
    from nomad_tpu_torch.api import Nomad
    from nomad_tpu_torch.training.se import SpeechEnhancement

    for owner, attr in ((Nomad, "score_matrix"), (Nomad, "loss_fn"),
                        (SpeechEnhancement, "train_step")):
        monkeypatch.setattr(owner, attr, getattr(owner, attr))  # restored after the test
    if fault:
        faults.FAULTS[fault](**kw)
    out = run_cell(cell, 2**31 + 11, 1.0, False, device="cpu", **tiny.cell(cell))
    assert out["correct"] is (fault is None), out["checks"]
    if kw:  # only the window's steps are broken, so only its numbers see it
        failed = {k for k, c in out["checks"].items() if not c["value"] <= c["limit"]}
        assert failed and all(k.startswith("window_") for k in failed), out["checks"]
