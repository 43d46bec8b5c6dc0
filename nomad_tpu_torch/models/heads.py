"""NOMAD heads over the wav2vec2 backbone (counterpart of
``nomad_tpu.models.heads``).

``NomadModel.forward`` is the scoring embedding: masked mean-pool over
time -> ReLU -> Linear 768->256 -> L2 normalize. ``forward_layers`` returns
the 12 block outputs plus the lossnet embedding, the 13 inputs of
``nomad_loss``. ``forward_features`` is Origw2v, the raw mean-pooled
backbone features (the ``eval_w2v`` ablation). Each takes
``deterministic``/``generator`` (and a data-parallel rank's ``rows``) for
training's dropout. Quirk Q7: the lossnet embedding is a separate Linear that the
NOMAD checkpoint never populates, as in the reference; both heads exist so
that the weight bridge is complete and loads strictly.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import precision as prec_ops
from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Model, masked_mean


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    """torch F.normalize semantics: x / max(||x||, eps)."""
    norm = torch.sqrt((x * x).sum(dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


class NomadModel(nn.Module):
    def __init__(self, config: Wav2Vec2Config = Wav2Vec2Config(), emb_dim: int = 256,
                 masked_pool: bool = True):
        super().__init__()
        self.config = config
        self.emb_dim = emb_dim
        # with lengths, only valid frames pool, so padded batches match
        # unpadded batch-1 inference; False (or lengths=None) pools over the
        # padded axis (quirk Q6)
        self.masked_pool = masked_pool
        self.backbone = Wav2Vec2Model(config)
        self.embedding = nn.Linear(config.hidden_size, emb_dim)
        self.lossnet_embedding = nn.Linear(config.hidden_size, emb_dim)

    def _pool(self, res):
        lengths = res["frame_lengths"] if self.masked_pool else None
        return masked_mean(res["x"].to(torch.float32), lengths)

    def _embed(self, head, res):
        """The head on the f32 pool, then L2 normalize in f32. Under
        ``dtype=bfloat16`` the head is the JAX package's
        ``nn.Dense(dtype=bfloat16)`` (bf16 operands, bf16 out,
        ``precision.linear``), cast to f32 before the norm."""
        x = torch.relu(self._pool(res))
        if self.config.dtype == torch.bfloat16:
            e = prec_ops.linear(x.to(torch.bfloat16), head.weight, head.bias, "high")
        else:
            e = head(x)
        return l2_normalize(e.to(torch.float32))

    def forward(self, wav, lengths=None, deterministic: bool = True, generator=None,
                rows=None):
        """[B, T] waveforms (+ [B] valid sample counts) -> [B, emb_dim]."""
        res = self.backbone(wav, lengths, deterministic, generator, rows)
        return self._embed(self.embedding, res)

    def forward_layers(self, wav, lengths=None, deterministic: bool = True, generator=None):
        """The 12 block outputs [B, T', C] + the lossnet embedding [B, emb]."""
        res = self.backbone(wav, lengths, deterministic, generator)
        return list(res["layers"]) + [self._embed(self.lossnet_embedding, res)]

    def forward_features(self, wav, lengths=None, deterministic: bool = True, generator=None):
        """Origw2v: the raw mean-pooled backbone features [B, hidden]."""
        return self._pool(self.backbone(wav, lengths, deterministic, generator))


def nomad_loss(ref_layers, test_layers, frame_lengths=None):
    """Sum over layers of the mean absolute difference (reference
    ``nomad.py:260-282``). Without frame_lengths every element counts,
    padded frames included, as torch ``F.l1_loss`` does; with them the
    [B, T, C] layers average over valid frames only."""
    total = 0.0
    for ref, test in zip(ref_layers, test_layers, strict=True):
        diff = (test.to(torch.float32) - ref.to(torch.float32)).abs()
        if frame_lengths is not None and diff.ndim == 3:
            mask = (torch.arange(diff.shape[1], device=diff.device)[None, :]
                    < frame_lengths[:, None]).to(diff.dtype)[:, :, None]
            total = total + (diff * mask).sum() / (mask.sum() * diff.shape[-1])
        else:
            total = total + diff.mean()
    return total


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init in place: lecun-normal weights (truncated normal, std
    sqrt(1/fan_in) / .8796, cut at 2 std, flax's default) for every Linear
    and Conv1d, zero biases; norms keep their unit scales and zero shifts
    from construction. Deterministic for a seed on any device, since it
    draws on the CPU."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d)):
            w = mod.weight
            fan_in = w[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            cpu = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(cpu, std=std, a=-2 * std, b=2 * std, generator=g)
            w.copy_(cpu)
            if mod.bias is not None:
                mod.bias.zero_()
    return model
