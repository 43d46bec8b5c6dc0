"""Pairwise Euclidean distances (counterpart of ``nomad_tpu.ops.distance``).

``cdist`` is the centred Gram form in f32 that the JAX package uses:
both inputs are centred on the pooled mean (distances are translation
invariant, and the norms then scale with the spread of the point cloud),
then d = sqrt(max(0, |a|^2 + |b|^2 - 2 a.b)) with one ``torch.matmul``.

The Gram form cancels where two rows nearly coincide: identical
embeddings read up to ~1e-3 apart in f32 instead of 0. So the pairs whose
Gram value lies within ``NEAR`` of their centred norms are recomputed
directly as |a - b|^2, which reads exactly 0 for identical rows. Pairs
outside that band are left as the Gram form computed them.

``center`` takes the centre from outside: a block of a larger matrix
(``parallel.sharded_cdist``) is centred as the whole is, so it holds the
whole matrix's values.
"""

from __future__ import annotations

import torch

NEAR = 1e-2


def cdist_center(a, b):
    """The pooled mean that ``cdist`` centres a and b on."""
    return (a.mean(dim=0) + b.mean(dim=0)) * 0.5


def cdist(a, b, center=None):
    """Distance matrix between the rows of a [N, D] and b [M, D], f32;
    centred on ``cdist_center(a, b)`` unless ``center`` is given."""
    a = torch.as_tensor(a).to(torch.float32)
    b = torch.as_tensor(b).to(device=a.device, dtype=torch.float32)
    if center is None:
        center = cdist_center(a, b)
    a = a - center
    b = b - center
    a2 = (a * a).sum(dim=-1, keepdim=True)  # [N, 1]
    b2 = (b * b).sum(dim=-1, keepdim=True).T  # [1, M]
    sq = torch.clamp(a2 + b2 - 2.0 * torch.matmul(a, b.T), min=0.0)
    i, j = torch.nonzero(sq <= NEAR * (a2 + b2), as_tuple=True)
    if i.numel():
        diff = a[i] - b[j]
        sq[i, j] = (diff * diff).sum(dim=-1)
    return torch.sqrt(sq)


def cdist_diag(a, b):
    """Paired distances |a_i - b_i| (the full-reference mode) in f32."""
    d = torch.as_tensor(a).to(torch.float32) - torch.as_tensor(b).to(torch.float32)
    return torch.sqrt(torch.clamp((d * d).sum(dim=-1), min=0.0))
