"""The Wave-U-Net (Stoller, Ewert and Dixon, arXiv:1806.03185) of the NOMAD
speech-enhancement demo, its batch norm and Adam, in plain PyTorch.

``n_layers`` encoder levels of a width-15 convolution, batch norm and
LeakyReLU(0.1), each decimated by two; a middle level of the same; decoder
levels that upsample by two (linear, corners aligned), concatenate the
skip and run a width-5 convolution, batch norm and LeakyReLU; the input
concatenated, a width-1 convolution and tanh. The batch norm is flax's
(momentum 0.9, eps 1e-5): in training it normalises with E[x^2] - E[x]^2
and moves the running statistics by 0.1 of the batch's. Adam is
``torch.optim.Adam``'s update (beta 0.9 / 0.999, eps 1e-8), written out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MOMENTUM, EPS = 0.9, 1e-5


def param_shapes(n_layers: int, ci: int) -> dict:
    """Name -> (shape, role): roles ``weight``, ``bias``, ``norm_weight``,
    ``norm_bias``, ``stat_mean``, ``stat_var`` (the running statistics)."""
    enc = [i * ci for i in range(1, n_layers + 1)]
    s = {}

    def level(name, c_in, c_out, k):
        s[name + ".conv.weight"] = ((c_out, c_in, k), "weight")
        s[name + ".conv.bias"] = ((c_out,), "bias")
        for part, role in (("weight", "norm_weight"), ("bias", "norm_bias"),
                           ("mean", "stat_mean"), ("var", "stat_var")):
            s[f"{name}.bn.{part}"] = ((c_out,), role)

    for i in range(n_layers):
        level(f"down_{i}", ([1] + enc[:-1])[i], enc[i], 15)
    level("middle", n_layers * ci, n_layers * ci, 15)
    dec = enc[::-1]
    dec_in = [n_layers * ci] + dec[:-1]
    for i in range(n_layers):
        level(f"up_{i}", dec_in[i] + enc[n_layers - i - 1], dec[i], 5)
    s["out_conv.weight"] = ((1, ci + 1, 1), "weight")
    s["out_conv.bias"] = ((1,), "bias")
    return s


def _level(p, stats, name, x, pad):
    x = F.conv1d(x, p[name + ".conv.weight"], padding=pad) + p[name + ".conv.bias"][:, None]
    mean = x.mean(dim=(0, 2))
    var = torch.clamp((x * x).mean(dim=(0, 2)) - mean * mean, min=0.0)
    with torch.no_grad():
        stats[name + ".bn.mean"] = MOMENTUM * stats[name + ".bn.mean"] + (1 - MOMENTUM) * mean
        stats[name + ".bn.var"] = MOMENTUM * stats[name + ".bn.var"] + (1 - MOMENTUM) * var
    mul = torch.rsqrt(var + EPS) * p[name + ".bn.weight"]
    x = (x - mean[:, None]) * mul[:, None] + p[name + ".bn.bias"][:, None]
    return F.leaky_relu(x, 0.1)


def forward_train(p: dict, stats: dict, n_layers: int, wav: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B, T] in training mode; ``stats`` (the running
    statistics, by name) is updated in place."""
    inp = wav[:, None, :]
    o, skips = inp, []
    for i in range(n_layers):
        o = _level(p, stats, f"down_{i}", o, 7)
        skips.append(o)
        o = o[:, :, ::2]
    o = _level(p, stats, "middle", o, 7)
    for i in range(n_layers):
        up = F.interpolate(o, scale_factor=2, mode="linear", align_corners=True)
        o = _level(p, stats, f"up_{i}", torch.cat([up, skips[n_layers - i - 1]], dim=1), 2)
    o = F.conv1d(torch.cat([o, inp], dim=1), p["out_conv.weight"], p["out_conv.bias"])
    return torch.tanh(o)[:, 0, :]


class Adam:
    """torch.optim.Adam's update on a dict of tensors."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 state: dict | None = None):
        """``state``: name -> (m, v, step) to start from; fresh without."""
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0
        for k, (m, v, t) in (state or {}).items():
            self.m[k], self.v[k], self.t = m.clone(), v.clone(), t

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / bc2 ** 0.5 + self.eps
            params[k].sub_(self.lr / bc1 * self.m[k] / denom)
