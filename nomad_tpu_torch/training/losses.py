"""Training losses with torch's semantics (counterpart of
``nomad_tpu.training.losses``), and the epoch mean of step losses."""

from __future__ import annotations

import numpy as np
import torch


def pairwise_distance(a, b, eps: float = 1e-6):
    """``F.pairwise_distance``: ||a - b + eps||_2, eps added elementwise
    before the norm (the gradient stays finite at a == b)."""
    d = a - b + eps
    return torch.sqrt((d * d).sum(dim=-1))


def triplet_margin_loss(anchor, positive, negative, margin: float = 0.2):
    """``nn.TripletMarginLoss(margin, p=2, reduction='mean')``, the
    reference's criterion."""
    d_ap = pairwise_distance(anchor, positive)
    d_an = pairwise_distance(anchor, negative)
    return torch.clamp(d_ap - d_an + margin, min=0.0).mean()


def epoch_mean(losses: list) -> float:
    """The mean of an epoch's 0-dim step losses, still on the device: one
    copy to the host at the end, summed in float64 as the JAX package sums
    its Python floats; 0.0 for no step."""
    if not losses:
        return 0.0
    return float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
