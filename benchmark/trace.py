"""The traced window: ``torch.profiler`` over the device and the host,
reduced to the device's busy time, device time by kernel and by layer,
and the device's idle gaps labelled by what the host was doing.

``KERNEL_GROUPS`` and ``kernel_group`` are frozen copies of
``chip_smoke.py``'s: a kernel's layer by the first match of its name."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

# kernel name -> layer of the model, first match wins (cuDNN's implicit-GEMM
# convolutions carry "gemm" in their names too, so convolutions go first)
KERNEL_GROUPS = (
    ("flash_attention_f32_bf16io_fwd", ("flash_fwd_bf16_kernel<__nv_bfloat16, 3",)),
    ("flash_attention_bf16io_fwd", ("flash_fwd_bf16_kernel<__nv_bfloat16",
                                    "flash_fwd_fold_bf16_kernel<__nv_bfloat16")),
    ("flash_attention_bwd_f32_bf16io", ("flash_bwd_dq_bf16_kernel<__nv_bfloat16, 3",
                                        "flash_bwd_dkv_bf16_kernel<__nv_bfloat16, 3")),
    ("flash_attention_bwd_bf16io", ("flash_bwd_dq_bf16_kernel<__nv_bfloat16",
                                    "flash_bwd_dkv_bf16_kernel<__nv_bfloat16",
                                    "flash_bwd_fold_bf16_kernel<__nv_bfloat16")),
    ("layernorm_fwd_bf16io", ("layernorm_fwd_kernel<__nv_bfloat16",)),
    ("flash_attention_fwd", ("flash_fwd_kernel",)),
    ("flash_attention_bf16_fwd", ("flash_fwd_bf16_kernel", "flash_fwd_fold_bf16_kernel")),
    ("fused_qkv_attention_f32_bf16io_fwd", ("fused_qkv_fwd_bf16_kernel<6", "pack_kernel<3")),
    ("fused_qkv_attention_high3_fwd", ("fused_qkv_fwd_bf16_kernel<3", "pack_kernel<2")),
    ("fused_qkv_attention_bf16_fwd", ("fused_qkv_fwd_bf16_kernel", "pack_kernel<1")),
    ("fused_qkv_attention_fwd", ("fused_qkv_fwd_kernel",)),
    ("flash_attention_bwd", ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
    ("flash_attention_bwd_bf16", ("flash_bwd_dq_bf16_kernel", "flash_bwd_dkv_bf16_kernel",
                                  "flash_bwd_fold_bf16_kernel")),
    ("layernorm_fwd", ("layernorm_fwd_kernel",)),
    ("convolution", ("conv", "fprop", "implicit", "winograd", "cudnn")),
    ("matmul", ("gemm", "gemv", "cutlass", "sm90_xmma", "ampere", "nvjet")),
)


def kernel_group(name: str) -> str:
    name = name.lower()
    return next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)),
                "memcpy/memset" if "memcpy" in name or "memset" in name else "elementwise/other")


class Summary:
    """What the readers take from a traced window: ``busy_s`` (the union
    of the device's operations), ``window_s`` (the host clock around the
    window), ``by_group`` (device seconds by ``kernel_group``) and
    ``idle_by_host`` (idle device seconds by the host operation running in
    each gap)."""

    def __init__(self, busy_s, window_s, by_group, idle_by_host):
        self.busy_s, self.window_s = busy_s, window_s
        self.by_group, self.idle_by_host = by_group, idle_by_host

    def group_s(self, group: str) -> float:
        return self.by_group.get(group, 0.0)

    def breakdown(self) -> dict:
        top = sorted(self.by_group.items(), key=lambda x: -x[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[g, s] for g, s in top], "idle_gaps": [[h, s] for h, s in gaps]}


@contextlib.contextmanager
def traced(run):
    """Profile the enclosed window when ``run.trace``; leave its summary in
    ``run.trace_summary``."""
    if not run.trace:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if run.device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    run.sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield
        run.sync()
        window_s = time.perf_counter() - t0
    t = time.perf_counter()
    run.trace_summary = summarize(prof, window_s)
    run.phases["trace_reduction"] = time.perf_counter() - t


def summarize(prof, window_s: float) -> Summary:
    """Reduce the raw kineto events (not ``prof.events()``, whose event
    tree takes minutes to build for a window of a million host ops)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    by_group = defaultdict(float)
    for evt in prof.profiler.kineto_results.events():
        dur = evt.duration_ns()
        if dur <= 0:
            continue
        start = evt.start_ns()
        if evt.device_type() == cuda:
            if evt.is_user_annotation():
                continue  # a range, not an operation
            dev.append((start, start + dur))
            by_group[kernel_group(evt.name())] += dur / 1e9
        else:
            host.append((start, start + dur, evt))
    busy, gaps, end = 0, [], None
    for s, e in sorted(dev):  # the union of the device's busy intervals
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return Summary(busy / 1e9, window_s, dict(by_group), _label_gaps(gaps, host))


SHORT_GAP_NS = 50_000


def _label_gaps(gaps: list, host: list) -> dict:
    """Idle seconds by the innermost host operation running at each gap's
    midpoint ("python" where none is); gaps under ``SHORT_GAP_NS`` (the
    launch gaps between kernels) together under one label. One sweep:
    host spans pushed in order of start, those ended popped from the top,
    so the top is the latest-starting span that covers the midpoint."""
    host.sort(key=lambda h: h[0])
    out = defaultdict(float)
    stack, i = [], 0
    for s, e in gaps:  # in order of start, so of midpoint
        if e - s < SHORT_GAP_NS:
            out[f"gaps under {SHORT_GAP_NS // 1000} us"] += (e - s) / 1e9
            continue
        mid = (s + e) // 2
        while i < len(host) and host[i][0] <= mid:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out[stack[-1][2].name() if stack else "python"] += (e - s) / 1e9
    return dict(out)
