"""The NOMAD loss as a trainer applies it: ``Nomad.forward(estimate,
clean)`` and ``.backward()`` into an estimate that requires grad, on a pool
of batches used in turn, each step reading its loss value as a trainer
logging it does. A closed loop.

End-to-end: ``loss_step_ms``, the window's wall time over the steps it
completed (whole steps until ``--seconds`` have passed and each batch of
the pool has had one). The check compares, for every batch of the pool, the last loss
the window read and the last gradient it left in the estimate with the
reference's."""

from __future__ import annotations

import gc
import math
import time


from .. import reference, system
from ..harness import load_module
from ..reference import wav2vec2 as ref_w2v


def _step(run, i: int) -> float:
    st = run.state
    est, clean = st["pool"][i % len(st["pool"])]
    est = est.detach().requires_grad_(True)
    loss = st["nomad"].forward(est, clean)
    loss.backward()
    value = loss.item()
    st["last"][i % len(st["pool"])] = (value, est.grad)
    return value


def setup(run) -> None:
    with run.phase("weights"):
        sd = system.nomad_weights(run, run.config)
        nomad = system.make_nomad(run, run.config, sd)
    with run.phase("traffic"):
        pool = load_module("traffic", run.traffic["kind"]).make(run, run.traffic)
    run.state.update(sd=sd, nomad=nomad, pool=pool, last={})
    with run.phase("warmup"):
        for i in range(run.workload.get("warmup_steps", 2)):
            _step(run, i)
    run.state["last"].clear()


def window(run) -> None:
    st = run.state
    steps = 0
    t0 = time.perf_counter()
    while True:
        run.attempted += 1
        if not math.isfinite(_step(run, steps)):
            run.failed += 1
        steps += 1
        if time.perf_counter() - t0 >= run.seconds and steps >= len(st["pool"]):
            break
    run.window_s = time.perf_counter() - t0
    run.e2e["loss_step_ms"] = 1e3 * run.window_s / steps
    b, n = st["pool"][0][0].shape
    run.counters.update(steps=steps, batch=b, samples=n)


def release(run) -> None:
    run.state.pop("nomad", None)
    gc.collect()


def compare(run, control: bool = False) -> dict:
    """``loss_gap``: the widest relative gap of a batch's loss;
    ``grad_gap``: the widest ||g - g_ref|| / ||g_ref|| of a batch's
    gradient."""
    st = run.state
    p, w = st["sd"], run.config["wav2vec2"]
    rows = run.workload["check"]["rows"]
    loss_gap = grad_gap = 0.0
    for i, (est, clean) in enumerate(st["pool"]):
        if ("ref", i) not in st:
            with reference.precision(tf32=False):
                st["ref", i] = ref_w2v.loss_and_grad(p, w, est, clean, rows)
        ref_loss, ref_grad = st["ref", i]
        if control:
            with reference.precision(tf32=True):
                loss, grad = ref_w2v.loss_and_grad(p, w, est, clean, rows)
        elif i in st["last"]:
            loss, grad = st["last"][i]
        else:
            loss, grad = float("nan"), None
        if grad is None or not math.isfinite(loss):
            return {"loss_gap": float("inf"), "grad_gap": float("inf")}
        loss_gap = max(loss_gap, abs(loss - ref_loss) / abs(ref_loss))
        grad_gap = max(grad_gap, float((grad - ref_grad).norm() / ref_grad.norm()))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap}
