"""What the per-layer metric readers share: model-step FLOPs over the
window against the f32 peak, kernels' roofline shares from the trace, the
device's idle share. Each returns None where the run has nothing to read;
a share is in percent."""

from __future__ import annotations

import statistics

from . import counts


def idle_share(run):
    s = run.trace_summary
    if s is None or s.busy_s <= 0:
        return None  # no device in the trace
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def _nomad(run) -> dict:
    """The wav2vec 2.0 configuration: the SE cell's lossnet, else the cell's."""
    return run.state.get("lossnet") or run.config


def _w(run) -> dict:
    return _nomad(run)["wav2vec2"]


def _emb(run) -> int:
    return _nomad(run)["emb_dim"]


def forward_flops(n: int, w: dict, emb: int) -> float:
    return sum(counts.wav2vec2_forward_flops(n, w, emb).values())


def mfu(run, flops: float):
    if not run.window_s or flops <= 0:
        return None
    return 100.0 * flops / (run.window_s * counts.F32_FLOPS)


def scoring_flops(run) -> float:
    """Every file of the completed calls, forward once."""
    c, w, e = run.counters, _w(run), _emb(run)
    return c["calls"] * sum(forward_flops(n, w, e) for n in c["files"])


def loss_flops(run) -> float:
    c = run.counters
    return c["steps"] * c["batch"] * counts.loss_step_flops(c["samples"], _w(run), _emb(run))


def se_flops(run) -> float:
    c = run.counters
    return c["steps"] * counts.se_step_flops(c["batch"], c["samples"], c["n_layers"],
                                             c["channels_interval"], _w(run), _emb(run))


def roofline(run, needed_ms: float, group: str):
    """The least time the work needs over the group's device time."""
    s = run.trace_summary
    if s is None or s.group_s(group) <= 0:
        return None
    return 100.0 * needed_ms / 1e3 / s.group_s(group)


def k1_needed_ms(run, files: list, times: int) -> float:
    """The attention forward of each file over its own frames, every
    layer, ``times`` over."""
    w = _w(run)
    h, d = w["num_heads"], w["hidden_size"] // w["num_heads"]
    per = sum(counts.flash_bound(1, f, h, d, f)[0] for f in (counts.frames(n, w)[-1] for n in files))
    return times * w["num_layers"] * per


def k23_needed_ms(run, rows: int, n: int, times: int) -> float:
    w = _w(run)
    h, d = w["num_heads"], w["hidden_size"] // w["num_heads"]
    f = counts.frames(n, w)[-1]
    b = counts.flash_bwd_bounds(1, f, h, d, f, 1)
    return times * rows * w["num_layers"] * (b["dq"][0] + b["dkv"][0])


def median_ms(values):
    values = [v for v in values if v is not None]
    return 1e3 * statistics.median(values) if values else None
