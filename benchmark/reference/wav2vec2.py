"""wav2vec 2.0 BASE with the NOMAD heads, in plain PyTorch, on unpadded
waveforms.

The architecture of Baevski et al. (arXiv:2006.11477, fairseq
``wav2vec_small``) as NOMAD (Ragano, Skoglund and Hines, arXiv:2309.16284)
runs it: seven convolutions without bias, a GroupNorm of one channel per
group after the first, GELU after each; LayerNorm and the projection to the
model width; the grouped positional convolution (its even kernel's last
frame dropped) added through GELU, a LayerNorm, then post-LN transformer
blocks (softmax attention, an FFN with GELU). The scoring embedding is the
time mean of the last block, ReLU, a linear head and an L2 normalisation;
the loss embedding the same through a second head. The NOMAD loss sums the
mean absolute difference of the twelve block outputs and of the loss
embedding.

The weights are a dict of tensors under the names ``param_shapes`` gives.
Each function takes a batch of waveforms of one length, without padding or
masks; a file is its own batch of one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BB = "backbone."


def param_shapes(w: dict, emb_dim: int) -> dict:
    """Name -> (shape, role) of every weight. ``w`` holds the widths: conv_dim,
    conv_kernel, hidden_size, num_layers, ffn_dim, pos_conv_kernel,
    pos_conv_groups. Roles: ``weight`` (fan-in scaled), ``bias``,
    ``norm_weight``, ``norm_bias``."""
    s = {}
    c_in = 1
    for i, (c, k) in enumerate(zip(w["conv_dim"], w["conv_kernel"])):
        s[f"{BB}feature_encoder.conv_{i}.weight"] = ((c, c_in, k), "weight")
        c_in = c
    c0, d, f = w["conv_dim"][0], w["hidden_size"], w["ffn_dim"]
    s[f"{BB}feature_encoder.group_norm.weight"] = ((c0,), "norm_weight")
    s[f"{BB}feature_encoder.group_norm.bias"] = ((c0,), "norm_bias")
    s[f"{BB}feature_layer_norm.weight"] = ((c_in,), "norm_weight")
    s[f"{BB}feature_layer_norm.bias"] = ((c_in,), "norm_bias")
    s[f"{BB}post_extract_proj.weight"] = ((d, c_in), "weight")
    s[f"{BB}post_extract_proj.bias"] = ((d,), "bias")
    g, k = w["pos_conv_groups"], w["pos_conv_kernel"]
    s[f"{BB}encoder.pos_conv.conv.weight"] = ((d, d // g, k), "weight")
    s[f"{BB}encoder.pos_conv.conv.bias"] = ((d,), "bias")
    s[f"{BB}encoder.layer_norm.weight"] = ((d,), "norm_weight")
    s[f"{BB}encoder.layer_norm.bias"] = ((d,), "norm_bias")
    for i in range(w["num_layers"]):
        pre = f"{BB}encoder.layers.{i}."
        for name, (o, n) in (("q_proj", (d, d)), ("k_proj", (d, d)), ("v_proj", (d, d)),
                             ("out_proj", (d, d)), ("fc1", (f, d)), ("fc2", (d, f))):
            s[pre + name + ".weight"] = ((o, n), "weight")
            s[pre + name + ".bias"] = ((o,), "bias")
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            s[pre + name + ".weight"] = ((d,), "norm_weight")
            s[pre + name + ".bias"] = ((d,), "norm_bias")
    for head in ("embedding", "lossnet_embedding"):
        s[head + ".weight"] = ((emb_dim, d), "weight")
        s[head + ".bias"] = ((emb_dim,), "bias")
    return s


def frame_count(n: int, w: dict) -> int:
    """Frames of the last convolution for ``n`` samples."""
    for k, st in zip(w["conv_kernel"], w["conv_stride"]):
        n = (n - k) // st + 1
    return n


def _ln(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], eps)


def _linear(x, p, name):
    return F.linear(x, p[name + ".weight"], p[name + ".bias"])


def block_outputs(p: dict, w: dict, wav: torch.Tensor) -> list:
    """[B, T] waveforms -> the outputs [B, T', D] of every block."""
    eps = w.get("layer_norm_eps", 1e-5)
    x = wav[:, None, :]
    for i, (k, st) in enumerate(zip(w["conv_kernel"], w["conv_stride"])):
        x = F.conv1d(x, p[f"{BB}feature_encoder.conv_{i}.weight"], stride=st)
        if i == 0:
            gn = f"{BB}feature_encoder.group_norm"
            x = F.group_norm(x, x.shape[1], p[gn + ".weight"], p[gn + ".bias"], 1e-5)
        x = F.gelu(x)
    x = _ln(x.transpose(1, 2), p, f"{BB}feature_layer_norm", eps)
    x = _linear(x, p, f"{BB}post_extract_proj")
    k, g = w["pos_conv_kernel"], w["pos_conv_groups"]
    pos = F.conv1d(x.transpose(1, 2), p[f"{BB}encoder.pos_conv.conv.weight"],
                   p[f"{BB}encoder.pos_conv.conv.bias"], padding=k // 2, groups=g)
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = _ln(x + F.gelu(pos).transpose(1, 2), p, f"{BB}encoder.layer_norm", eps)
    b, t, d = x.shape
    h = w["num_heads"]
    outs = []
    for i in range(w["num_layers"]):
        pre = f"{BB}encoder.layers.{i}."
        q, kk, v = (_linear(x, p, pre + n).view(b, t, h, d // h).transpose(1, 2)
                    for n in ("q_proj", "k_proj", "v_proj"))
        att = torch.softmax(q @ kk.transpose(-1, -2) / math.sqrt(d // h), dim=-1) @ v
        att = _linear(att.transpose(1, 2).reshape(b, t, d), p, pre + "out_proj")
        x = _ln(x + att, p, pre + "self_attn_layer_norm", eps)
        y = _linear(F.gelu(_linear(x, p, pre + "fc1")), p, pre + "fc2")
        x = _ln(x + y, p, pre + "final_layer_norm", eps)
        outs.append(x)
    return outs


def head(p: dict, last: torch.Tensor, name: str) -> torch.Tensor:
    """Time mean, ReLU, the linear head ``name``, L2 normalisation."""
    e = _linear(torch.relu(last.mean(dim=1)), p, name)
    return e / torch.clamp(e.norm(dim=-1, keepdim=True), min=1e-12)


def embed(p: dict, w: dict, wav: torch.Tensor) -> torch.Tensor:
    """[B, T] -> the [B, emb] scoring embeddings."""
    return head(p, block_outputs(p, w, wav)[-1], "embedding")


def loss_layers(p: dict, w: dict, wav: torch.Tensor) -> list:
    """The block outputs and the loss embedding: the loss's inputs."""
    outs = block_outputs(p, w, wav)
    return outs + [head(p, outs[-1], "lossnet_embedding")]


def nomad_loss(p: dict, w: dict, estimate: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
    """The sum over the loss's inputs of the mean absolute difference."""
    with torch.no_grad():
        ref = loss_layers(p, w, clean)
    return sum((a - b).abs().mean() for a, b in zip(loss_layers(p, w, estimate), ref))


def loss_and_grad(p: dict, w: dict, estimate: torch.Tensor, clean: torch.Tensor,
                  rows: int) -> tuple[float, torch.Tensor]:
    """The loss of the whole [B, T] batch and its gradient with respect to
    the estimate, computed ``rows`` rows at a time: each element's mean
    is over the batch, so a block of n rows weighs n / B."""
    bsz = estimate.shape[0]
    total, grad = 0.0, torch.empty_like(estimate)
    for s in range(0, bsz, rows):
        est = estimate[s:s + rows].detach().clone().requires_grad_(True)
        part = nomad_loss(p, w, est, clean[s:s + rows]) * (est.shape[0] / bsz)
        (g,) = torch.autograd.grad(part, est)
        total += float(part.detach())
        grad[s:s + rows] = g
    return total, grad


def distances(deg: torch.Tensor, nmr: torch.Tensor) -> torch.Tensor:
    """Euclidean distances [N, M] between the rows of deg and nmr, in float64."""
    return torch.cdist(deg.double(), nmr.double())
