"""Multi-head self-attention for the wav2vec2 encoder.

Counterpart of ``nomad_tpu.ops.attention``. Two implementations behind
one switch:

  * ``kernel`` — the differentiable flash attention
                 (``ops/flash_attention.py``: kernel K1 forward, K1b at
                 precision "default", K2 + K3 backward on the card). The
                 default; the projection-fused path
                 (``ops/fused_attention.py``, K4) is the model's other
                 kernel path.
  * ``ref``    — the plain version of ``mha_xla``: einsum scores with an
                 additive -1e9 key mask, softmax in f32. Kept so that a
                 run can hold the kernel path against it. At precision
                 "default" both einsums take bf16-rounded operands, as
                 ``mha_xla`` under ``jax.default_matmul_precision("default")``
                 (the normalised weights are rounded, not exp(s - m)), and
                 their gradients are the products of the rounded cotangent
                 and operands, as JAX transposes a DEFAULT product
                 (``precision.matmul_bf16``).

``mha_dropout`` is the training path under attention dropout, the plain
counterpart of the JAX package's ``mha_xla_dropout``: ``mha_ref`` with
dropout on the softmax weights, at the same precisions (the dropped and
rescaled weights are rounded at "default"). The JAX package computes it
outside any Pallas kernel, and so does the port.

q is pre-scaled by 1/sqrt(head_dim) before QK^T, as in torch
``F.multi_head_attention_forward``.

WavLM's gated relative-position bias (``rel``: a gate [B, H, T] and a
table [H, 2T - 1], ``flash_attention.relative_bias``) is added to every
score after QK^T and before the key mask: the plain paths take its [B, H,
T, T] expansion as ``bias``; ``kernel`` runs K1r
(``flash_attention.FlashAttentionRel``), at "highest" or "high" only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .flash_attention import FlashAttention, FlashAttentionRel, relative_bias
from .precision import is_bf16, matmul_bf16

NEG_INF = -1e9  # additive key mask; exp underflows to exactly 0 in f32


class BatchRows(NamedTuple):
    """A rank's rows of a data-parallel batch that stacks ``groups`` groups
    of ``size`` rows (the trainer's [A; P; N]): rows ``start:stop`` of
    each group."""

    groups: int
    size: int
    start: int
    stop: int

    def take(self, x):
        """This rank's rows of a tensor over the whole batch (dim 0): a view
        when they are all of it."""
        rest = x.shape[1:]
        return x.view(self.groups, self.size, *rest)[:, self.start:self.stop].reshape(-1, *rest)


def dropout(x, rate: float, generator=None, rows: Optional[BatchRows] = None):
    """flax ``nn.Dropout``: keep each element with probability 1 - rate
    and scale it by 1/(1 - rate), else 0; the identity with no generator
    (deterministic) or at rate 0. The mask comes from ``generator``, on
    x's device, from a float32 uniform whatever x's dtype (a bf16 uniform
    has 8 mantissa bits: at rate 0.1 it would keep 230/256); the kept
    values are scaled in x's dtype. With ``rows`` (x holds a rank's rows,
    dim 0, of a data-parallel batch) the mask of the whole batch is drawn
    and the rank keeps its rows, so that every rank applies the masks of
    the single-process step, as the JAX package's sharded step does."""
    if generator is None or rate == 0.0:
        return x
    shape = x.shape if rows is None else (rows.groups * rows.size, *x.shape[1:])
    keep = torch.rand(shape, generator=generator, device=x.device, dtype=torch.float32) >= rate
    if rows is not None:
        keep = rows.take(keep)
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _scores(q, k, precision):
    """q [B, T, H, D] . k [B, T, H, D]^T -> [B, H, T, T] in f32. Off
    "default" bf16 operands are upcast first (exactly): ``mha_xla``'s
    einsum sums them into f32 (``preferred_element_type``), where a bf16
    einsum would round each score."""
    if is_bf16(precision):
        return matmul_bf16(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())


def _attend(weights, v, precision):
    """weights [B, H, T, T] . v [B, T, H, D] -> [B, T, H, D] in f32 (bf16
    operands upcast off "default", as ``_scores``); the callers round it
    once to v's dtype."""
    if is_bf16(precision):
        return matmul_bf16(weights, v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
    return torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float())


def _softmax_weights(q, k, key_mask, precision, bias=None):
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = _scores(q * scale, k, precision).to(torch.float32)
    if bias is not None:
        scores = scores + bias
    if key_mask is not None:
        add = torch.where(key_mask, 0.0, NEG_INF).to(torch.float32)
        scores = scores + add[:, None, None, :]
    return torch.softmax(scores, dim=-1)


def mha_ref(q, k, v, key_mask=None, precision="highest", bias=None):
    """Attention on [B, T, H, D]; key_mask: optional bool [B, T], True =
    valid key; bias: an optional f32 score bias broadcast to [B, H, T, T].
    Differentiable. precision "default" rounds the operands of
    both products to bf16, and those of their gradients' products. The
    softmax runs in f32; the weights and the output take v's dtype, as
    ``mha_xla``'s ``.astype(v.dtype)``."""
    weights = _softmax_weights(q, k, key_mask, precision, bias).to(v.dtype)
    return _attend(weights, v, precision).to(v.dtype)


def mha_dropout(q, k, v, key_mask, rate: float, generator, precision="highest",
                rows: Optional[BatchRows] = None, bias=None):
    """``mha_ref`` with dropout on the softmax weights after the key mask
    (fairseq's placement): where(keep, w / (1 - rate), 0). ``rows``: as
    ``dropout``'s."""
    weights = dropout(_softmax_weights(q, k, key_mask, precision, bias), rate, generator,
                      rows).to(v.dtype)
    return _attend(weights, v, precision).to(v.dtype)


def mha(q, k, v, key_mask=None, impl: str = "kernel", precision: str = "highest", rel=None):
    """impl 'kernel' | 'ref'; precision 'highest' | 'high' (f32) | 'default'
    (bf16 products: K1b on the card). The kernel reads key_mask as the
    prefix mask the model builds (arange(T) < lengths), i.e. as valid key
    counts. ``rel``: (gate, table) of the relative-position bias, or None."""
    if impl == "ref":
        return mha_ref(q, k, v, key_mask, precision, None if rel is None else relative_bias(*rel))
    if impl != "kernel":
        raise ValueError(f"unknown attention impl {impl!r}: expected 'kernel' or 'ref'")
    b, t = q.shape[:2]
    if key_mask is None:
        lengths = torch.full((b,), t, dtype=torch.int32, device=q.device)
    else:
        lengths = key_mask.sum(dim=-1, dtype=torch.int32)
    if rel is not None:
        return FlashAttentionRel.apply(q, k, v, *rel, lengths, precision)
    return FlashAttention.apply(q, k, v, lengths, precision)
