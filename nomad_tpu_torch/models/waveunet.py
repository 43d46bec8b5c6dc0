"""Wave-U-Net of the speech-enhancement demo (counterpart of
``nomad_tpu.models.waveunet``), channels-first ``[B, C, T]``.

The architecture of the reference SE model: ``n_layers`` encoder levels of
Conv1d(k=15, pad=7) + batch norm + LeakyReLU(0.1), each decimated by
``[..., ::2]``; a middle level of the same; a decoder of linear x2
upsampling (``align_corners=True``), the skip concatenated after it, and
Conv1d(k=5, pad=2) + batch norm + LeakyReLU; then the input concatenated,
Conv1d(k=1) and tanh.

Batch norm is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, not
torch's: in training it normalises with the biased batch variance and
updates its running statistics with that same variance,
``ra = 0.9 · ra + 0.1 · batch`` (torch's ``BatchNorm1d`` would update the
running variance with the unbiased one). Its parameters are
``weight``/``bias`` and its buffers ``mean``/``var``, flax's names, so the
weight bridge (``convert/waveunet.py``) maps them one to one.

The weights start from ``models.init_weights(seed=0)``: lecun-normal conv
kernels and zero biases, as flax's defaults; norms at scale 1, bias 0,
mean 0, var 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .heads import init_weights


def interpolate_linear_x2(x: torch.Tensor) -> torch.Tensor:
    """``F.interpolate(scale_factor=2, mode='linear', align_corners=True)``
    on [B, C, T], as the JAX package computes it: output i reads input
    coordinate i·(T−1)/(2T−1), a blend of its two neighbours."""
    t = x.shape[-1]
    t_out = 2 * t
    pos = torch.arange(t_out, dtype=torch.float32, device=x.device) * (t - 1) / (t_out - 1)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.clamp(lo + 1, max=t - 1)
    w = pos - lo.to(torch.float32)
    return x.index_select(-1, lo) * (1.0 - w) + x.index_select(-1, hi) * w


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of [B, C, T]."""

    momentum, eps = 0.9, 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            # flax's statistics, differentiable: E[x²] − E[x]², clipped at 0
            mean = x.mean(dim=(0, 2))
            var = torch.clamp((x * x).mean(dim=(0, 2)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


class ConvBNLeaky(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel: int, padding: int):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, features, kernel, padding=padding)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the bias added apart, as flax's nn.Conv adds it: ahead of a batch
        # norm its gradient is a sum over [B, T] that is 0 analytically, and
        # the conv's own bias reduction (CPU) leaves ~10x flax's f32 residue
        x = F.conv1d(x, self.conv.weight, padding=self.conv.padding) + self.conv.bias[:, None]
        return F.leaky_relu(self.bn(x), negative_slope=0.1)


class WaveUNet(nn.Module):
    """[B, T] or [B, 1, T] waveforms -> the same shape, in (−1, 1).
    ``train()`` normalises with batch statistics and updates the running
    ones; ``eval()`` uses the running ones."""

    def __init__(self, n_layers: int = 12, channels_interval: int = 24):
        super().__init__()
        self.n_layers = n_layers
        ci = channels_interval
        enc_out = [i * ci for i in range(1, n_layers + 1)]
        enc_in = [1] + enc_out[:-1]
        for i in range(n_layers):
            self.add_module(f"down_{i}", ConvBNLeaky(enc_in[i], enc_out[i], 15, 7))
        self.middle = ConvBNLeaky(n_layers * ci, n_layers * ci, 15, 7)
        dec_out = enc_out[::-1]
        dec_in = [n_layers * ci] + dec_out[:-1]  # the upsampled level, before its skip
        for i in range(n_layers):
            skip = enc_out[n_layers - i - 1]
            self.add_module(f"up_{i}", ConvBNLeaky(dec_in[i] + skip, dec_out[i], 5, 2))
        self.out_conv = nn.Conv1d(ci + 1, 1, 1)
        init_weights(self, seed=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        squeeze_back = x.ndim == 3
        if squeeze_back:
            x = x[:, 0, :]
        inp = x[:, None, :]  # [B, 1, T]
        o, skips = inp, []
        for i in range(self.n_layers):
            o = getattr(self, f"down_{i}")(o)
            skips.append(o)
            o = o[:, :, ::2]
        o = self.middle(o)
        for i in range(self.n_layers):
            o = torch.cat([interpolate_linear_x2(o), skips[self.n_layers - i - 1]], dim=1)
            o = getattr(self, f"up_{i}")(o)
        o = torch.tanh(self.out_conv(torch.cat([o, inp], dim=1)))[:, 0, :]
        return o[:, None, :] if squeeze_back else o
