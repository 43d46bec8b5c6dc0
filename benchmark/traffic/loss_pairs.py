"""(estimate, clean) batches for the NOMAD loss, made on the device.

Mix parameters: ``batch``, ``samples``, ``pool`` (batches used in turn),
``clean_noise``, ``estimate_noise`` [low, high]. The clean rows are
speech-like (a voiced tone under a syllable-rate envelope plus white
noise); an estimate is its clean row plus white noise of an amplitude drawn
per row. Returns a list of (estimate, clean) [batch, samples] float32."""

from __future__ import annotations

import math

import torch

SR = 16000


def make(run, mix: dict) -> list:
    dev = run.device
    g = torch.Generator(device=dev).manual_seed(run.seed % (1 << 63))
    b, n = mix["batch"], mix["samples"]
    t = torch.arange(n, device=dev, dtype=torch.float32) / SR
    out = []
    for _ in range(mix["pool"]):
        u = torch.rand(b, 3, generator=g, device=dev)
        f0 = 90 + 160 * u[:, :1]
        rate = 0.5 + 1.5 * u[:, 1:2]
        env = torch.clamp(torch.sin(2 * math.pi * rate * t), 0, 1)
        clean = 0.2 * torch.sin(2 * math.pi * f0 * t) * env
        clean += mix["clean_noise"] * torch.randn(b, n, generator=g, device=dev)
        lo, hi = mix["estimate_noise"]
        amp = lo + (hi - lo) * u[:, 2:3]
        est = clean + amp * torch.randn(b, n, generator=g, device=dev)
        out.append((est.contiguous(), clean.contiguous()))
    return out
