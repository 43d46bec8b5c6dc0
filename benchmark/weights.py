"""Seeded weights, made on the device in one draw and handed to both the
system under test and the reference.

Every weight of a shape list is cut from one normal draw of a
``torch.Generator`` on the device: weights scaled by 1 / sqrt(fan_in)
(LeCun normal), biases by 0.02, norm scales 1 + 0.1 n and shifts 0.1 n;
running statistics start at mean 0 and variance 1."""

from __future__ import annotations

import math

import torch

SCALE = {"bias": 0.02, "norm_weight": 0.1, "norm_bias": 0.1}


def seeded(shapes: dict, seed: int, device, stream: int = 0) -> dict:
    """name -> tensor, from ``shapes`` (name -> (shape, role)); ``stream``
    gives a second network of one seed draws of its own."""
    g = torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    total = sum(math.prod(s) for s, _ in shapes.values())
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, pos = {}, 0
    for name, (shape, role) in shapes.items():
        n = math.prod(shape)
        x = flat[pos:pos + n].view(shape)
        pos += n
        if role == "weight":
            x = x * (1.0 / math.sqrt(n // shape[0]))
        elif role == "norm_weight":
            x = 1.0 + SCALE[role] * x
        elif role == "stat_mean":
            x = torch.zeros_like(x)
        elif role == "stat_var":
            x = torch.ones_like(x)
        else:
            x = SCALE[role] * x
        out[name] = x.contiguous()
    return out
