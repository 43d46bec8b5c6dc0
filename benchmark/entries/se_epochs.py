"""The speech-enhancement demo's training: ``SpeechEnhancement.train(seed=
epoch)`` epochs back to back, each ``train_step`` over
``PairedAudioDataset.batches`` (its decode threads), exactly as
``training_loop`` calls it. The lossnet is the frozen NOMAD of the
configuration's ``lossnet``; both networks' weights come from the seed.

Set-up builds the trainer and runs epoch 0; the window runs epochs 1, 2,
... on that same object. A wrapper on the instance's ``train_step``
records two stages of three steps each: the first three steps of epoch 0
(the start, from the seed's weights) and the window's first three steps
(from the state that set-up hands to the window, snapshotted at its end:
the U-Net's parameters and running statistics and Adam's moments and step
count). For each stage it keeps the losses, Adam's first moments after
the stage's first step (from which the first gradient follows) and the
U-Net's state after its third step. The reference follows each stage from
its starting state and reads the stage's batches itself, by the dataset's
rule. End-to-end: ``se_step_ms``, the window's wall time over the steps of
the epochs it completed."""

from __future__ import annotations

import gc
import math
import os
import time

import numpy as np
import torch

from .. import reference, system, weights
from ..harness import load_json, load_module
from ..reference import wav, wav2vec2 as ref_w2v, waveunet as ref_unet

RECORDED = 3
STAGES = ("start", "window")
PREFIX = {"start": "", "window": "window_"}


def lossnet_config(run) -> dict:
    ln = run.config["lossnet"]
    return ln if isinstance(ln, dict) else load_json("configs", ln)


def _book(mark: int, epoch: int) -> dict:
    """What a stage records: its steps are those after the ``mark``-th."""
    return {"mark": mark, "epoch": epoch, "losses": []}


def _wrap(se, rec: dict) -> None:
    inner = se.train_step
    named = list(se.unet.named_parameters())

    def train_step(noisy, clean):
        t0 = time.perf_counter()
        loss = inner(noisy, clean)
        rec["host_s"].append(time.perf_counter() - t0)
        rec["steps"] += 1
        for book in rec["books"].values():
            k = rec["steps"] - book["mark"]
            if 1 <= k <= RECORDED:
                book["losses"].append(loss)
            if k == 1:
                book["exp_avg"] = {n: se.optimizer.state[p]["exp_avg"].clone() for n, p in named
                                   if "exp_avg" in se.optimizer.state.get(p, {})}
            if k == RECORDED:
                book["after"] = {n: t.detach().clone() for n, t in se.unet.state_dict().items()}
        return loss

    se.train_step = train_step


def _snapshot(se) -> dict:
    """The trainer's state as it stands: the U-Net's state dict, and Adam's
    moments and step count by parameter name."""
    adam = {}
    for n, p in se.unet.named_parameters():
        s = se.optimizer.state.get(p, {})
        if "exp_avg" in s:
            adam[n] = (s["exp_avg"].clone(), s["exp_avg_sq"].clone(), int(s["step"]))
    return {"state": {n: t.detach().clone() for n, t in se.unet.state_dict().items()},
            "adam": adam}


def setup(run) -> None:
    from nomad_tpu_torch.training.se import SpeechEnhancement

    cfg, u = run.config, run.config["waveunet"]
    ln = lossnet_config(run)
    with run.phase("weights"):
        sd = system.nomad_weights(run, ln)
        nomad = system.make_nomad(run, ln, sd)
        usd = weights.seeded(ref_unet.param_shapes(u["n_layers"], u["channels_interval"]),
                             run.seed, run.device, stream=1)
    with run.phase("traffic"):
        pairs = load_module("traffic", run.traffic["kind"]).make(run, run.traffic)
    r = cfg["recipe"]
    se_cfg = {f"{kind}_{split}_dir": pairs[f"{kind}_dir"] for kind in ("noisy", "clean")
              for split in ("train", "valid", "test")}
    se_cfg.update(train_bs=r["train_bs"], lr=r["lr"], nomad_weight=r["nomad_weight"],
                  loss_dropout=r["loss_dropout"], n_layers=u["n_layers"],
                  target_sr=r["target_sr"])
    with run.phase("weights"):
        se = SpeechEnhancement(se_cfg, device=run.device, nomad=nomad)
        se.unet.load_state_dict(usd, strict=True)
    rec = {"host_s": [], "steps": 0, "books": {"start": _book(0, 0)}}
    _wrap(se, rec)
    run.state.update(sd=sd, usd=usd, se=se, pairs=pairs, rec=rec, lossnet=ln)
    with run.phase("warmup"):
        se.train(seed=0)  # epoch 0: the start's steps, and every shape warmed
        run.state["snap"] = _snapshot(se)  # the state the window starts from


def window(run) -> None:
    st = run.state
    se, rec = st["se"], st["rec"]
    rec["host_s"] = []
    first = rec["steps"]
    epoch = 1
    rec["books"]["window"] = _book(first, epoch)
    t0 = time.perf_counter()
    while True:
        run.attempted += 1
        loss = se.train(seed=epoch)
        if not math.isfinite(loss):
            run.failed += 1
        epoch += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0
    steps = rec["steps"] - first
    run.e2e["se_step_ms"] = 1e3 * run.window_s / steps
    r, u = run.config["recipe"], run.config["waveunet"]
    run.counters.update(steps=steps, epochs=epoch - 1, host_s=list(rec["host_s"]),
                        batch=r["train_bs"], samples=r["fixed_len"],
                        n_layers=u["n_layers"], channels_interval=u["channels_interval"])


def release(run) -> None:
    run.state.pop("se", None)
    gc.collect()


def _batches(run, epoch: int) -> list:
    """The first ``RECORDED`` batches from epoch ``epoch`` on, read and cut
    by the reference: the noisy files in sorted order, shuffled by
    ``default_rng(epoch)``, each cut or zero-padded to the recipe's length."""
    pairs, r = run.state["pairs"], run.config["recipe"]
    names = sorted(os.listdir(pairs["noisy_dir"]))
    n, bs = r["fixed_len"], r["train_bs"]

    def fix(x):
        return np.pad(x, (0, n - len(x))) if len(x) < n else x[:n]

    out = []
    while len(out) < RECORDED:
        idx = np.arange(len(names))
        np.random.default_rng(epoch).shuffle(idx)
        for s in range(0, len(idx), bs):
            if len(out) == RECORDED:
                break
            rows = [names[i] for i in idx[s:s + bs]]
            out.append(tuple(torch.from_numpy(np.stack([
                fix(wav.read_pcm16(os.path.join(pairs[d], name))[0]) for name in rows]))
                .to(run.device) for d in ("noisy_dir", "clean_dir")))
        epoch += 1
    return out


def _initial(run, stage: str) -> tuple:
    """A stage's starting state: (U-Net state by name, Adam's state or None)."""
    st = run.state
    if stage == "start":
        return st["usd"], None
    return st["snap"]["state"], st["snap"]["adam"]


def reference_steps(run, stage: str, tf32: bool) -> dict:
    """The reference's three steps of ``stage`` from its starting state:
    losses, first gradient, state after."""
    st, r, u = run.state, run.config["recipe"], run.config["waveunet"]
    shapes = ref_unet.param_shapes(u["n_layers"], u["channels_interval"])
    init, adam_state = _initial(run, stage)
    params = {k: v.clone() for k, v in init.items() if not shapes[k][1].startswith("stat")}
    stats = {k: v.clone() for k, v in init.items() if shapes[k][1].startswith("stat")}
    adam = ref_unet.Adam(params, r["lr"], tuple(r["betas"]), r["eps"], state=adam_state)
    losses, first = [], None
    with reference.precision(tf32=tf32):
        for noisy, clean in _batches(run, st["rec"]["books"][stage]["epoch"]):
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            est = ref_unet.forward_train(leaves, stats, u["n_layers"], noisy)
            loss = torch.mean((est - clean) ** 2) + r["nomad_weight"] * ref_w2v.nomad_loss(
                st["sd"], st["lossnet"]["wav2vec2"], est, clean)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            losses.append(float(loss.detach()))
            first = grads if first is None else first
            adam.step(params, grads)
    return {"losses": losses, "grad": first, "after": params | stats}


def _recorded(run, stage: str) -> dict | None:
    """The system's three steps of ``stage`` as the wrapper recorded them;
    the first gradient from Adam's first moments before and after the
    stage's first step, m1 = beta1 m0 + (1 - beta1) g."""
    book, b1 = run.state["rec"]["books"].get(stage), run.config["recipe"]["betas"][0]
    if book is None or len(book["losses"]) < RECORDED or "after" not in book:
        return None
    _, adam_state = _initial(run, stage)
    m0 = {k: s[0] for k, s in (adam_state or {}).items()}
    grad = {k: (m - b1 * m0[k] if k in m0 else m) / (1 - b1)
            for k, m in book["exp_avg"].items()}
    return {"losses": [float(x) for x in book["losses"]], "grad": grad, "after": book["after"]}


def _norm_gap(got: dict, ref: dict, keys: list) -> float:
    """The widest |‖got‖ - ‖ref‖| over the leaves ``keys``, each against the
    larger of its reference norm and the median leaf's."""
    norms = {k: float(ref[k].norm()) for k in keys}
    med = float(np.median(list(norms.values())))
    return max(abs(float(got[k].norm()) - norms[k]) / max(norms[k], med) for k in keys)


def _gaps(run, stage: str, control: bool) -> dict:
    st = run.state
    key = f"ref_{stage}"
    if key not in st:
        st[key] = reference_steps(run, stage, tf32=False)
    ref = st[key]
    got = reference_steps(run, stage, tf32=True) if control else _recorded(run, stage)
    if got is None:
        return {"loss_gap": float("inf"), "grad_gap": float("inf"), "change_gap": float("inf")}
    gnorm = {k: float(g.norm()) for k, g in ref["grad"].items()}
    med = float(np.median(list(gnorm.values())))
    kept = [k for k, n in gnorm.items() if n >= 1e-3 * med]
    stats = [k for k in ref["after"] if k not in ref["grad"]]
    if any(k not in got["grad"] for k in kept):
        grad_gap = float("inf")
    else:
        grad_gap = _norm_gap(got["grad"], ref["grad"], kept)
    init, _ = _initial(run, stage)
    d_got = {k: got["after"][k] - init[k] for k in kept + stats}
    d_ref = {k: ref["after"][k] - init[k] for k in kept + stats}
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
            "grad_gap": grad_gap,
            "change_gap": _norm_gap(d_got, d_ref, kept + stats)}


def compare(run, control: bool = False) -> dict:
    """For each stage, the start (no prefix) and the window (``window_``):
    ``loss_gap``, the widest relative gap of its three steps' losses;
    ``grad_gap``, of its first gradient's leaf norms; ``change_gap``, of
    the leaf norms of the change of parameters and running statistics over
    its three steps. Leaves whose reference gradient is under 1/1000 of
    the median leaf's (the convolution biases ahead of a batch norm) are
    left out of the last two."""
    return {PREFIX[stage] + k: v for stage in STAGES
            for k, v in _gaps(run, stage, control).items()}
