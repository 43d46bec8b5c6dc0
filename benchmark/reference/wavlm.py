"""WavLM Large with the NOMAD heads, in plain PyTorch, on unpadded
waveforms.

The architecture of Chen et al., "WavLM: Large-Scale Self-Supervised
Pre-Training for Full Stack Speech Processing" (arXiv:2110.13900), as
Hugging Face's ``WavLMModel`` runs ``microsoft/wavlm-large``'s config
(``feat_extract_norm`` "layer", ``do_stable_layer_norm`` true):

  * seven convolutions (bias per ``conv_bias``), each followed by a
    LayerNorm over the channels of every frame and GELU;
  * the feature LayerNorm, the projection to the model width, and the
    grouped positional convolution (its even kernel's last frame dropped)
    added through GELU, with no LayerNorm before the blocks;
  * the relative positions: for each key-minus-query offset its bucket
    (``relative_position_bucket``) and the table r[h, offset] = E[bucket, h]
    of block 0's embedding E, shared by every block;
  * pre-LN blocks: u = LN(x); the gate of each query row and head from u's
    head slice (a Linear(head_dim, 8), the sigmoids of the sums of its two
    halves, a (b c_h - 1) + 2); scores (q / sqrt(head_dim)) . k + gate_i
    r[h, j - i], softmax, x + out_proj(P . v); then x + fc2(GELU(fc1(LN(x))));
  * the encoder LayerNorm after the last block.

NOMAD's scoring embedding is the time mean of that LayerNorm's output,
ReLU, a linear head and an L2 normalisation; its loss sums the mean
absolute difference of the 24 block outputs (fairseq's ``layer_results``)
and of the loss embedding (a second head on the same pool).

Departures from the published model: the positional convolution's weight
norm is composed into one kernel (the weights are seeded, not loaded); no
dropout, no layerdrop, no attention mask (a file is its own batch of one,
unpadded); the buckets are computed on the CPU, in float32 as the published
code computes them, and the table moved to the waveform's device.

The weights are a dict of tensors under the names ``param_shapes`` gives;
``w`` holds the widths of a configuration file's ``wavlm`` group.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .wav2vec2 import head

BB = "backbone."


def param_shapes(w: dict, emb_dim: int) -> dict:
    """Name -> (shape, role) of every weight (roles as ``weights.seeded``
    reads them)."""
    s = {}
    c_in = 1
    for i, (c, k) in enumerate(zip(w["conv_dim"], w["conv_kernel"])):
        s[f"{BB}feature_encoder.conv_{i}.weight"] = ((c, c_in, k), "weight")
        if w["conv_bias"]:
            s[f"{BB}feature_encoder.conv_{i}.bias"] = ((c,), "bias")
        s[f"{BB}feature_encoder.layer_norm_{i}.weight"] = ((c,), "norm_weight")
        s[f"{BB}feature_encoder.layer_norm_{i}.bias"] = ((c,), "norm_bias")
        c_in = c
    d, f, h = w["hidden_size"], w["ffn_dim"], w["num_heads"]
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
                             ("out_proj", (d, d)), ("fc1", (f, d)), ("fc2", (d, f)),
                             ("gru_rel_pos_linear", (8, d // h))):
            s[pre + name + ".weight"] = ((o, n), "weight")
            s[pre + name + ".bias"] = ((o,), "bias")
        s[pre + "gru_rel_pos_const"] = ((h,), "norm_weight")  # 1 + 0.1 n: HF starts it at 1
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            s[pre + name + ".weight"] = ((d,), "norm_weight")
            s[pre + name + ".bias"] = ((d,), "norm_bias")
        if i == 0:
            s[pre + "rel_attn_embed.weight"] = ((w["num_buckets"], h), "weight")
    for name in ("embedding", "lossnet_embedding"):
        s[name + ".weight"] = ((emb_dim, d), "weight")
        s[name + ".bias"] = ((emb_dim,), "bias")
    return s


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """The published bucketing of key-minus-query offsets: the sign takes
    half of the buckets; of each half, offsets below a quarter of the
    buckets are their own bucket, larger ones fall on a log scale that
    reaches the half's last bucket at ``max_distance``. float32 arithmetic,
    truncated to an integer, as the published code computes it."""
    half = num_buckets // 2
    max_exact = half // 2
    buckets = (relative_position > 0).to(torch.long) * half
    distance = torch.abs(relative_position)
    if_large = torch.log(distance.float() / max_exact)
    if_large = if_large / math.log(max_distance / max_exact) * (half - max_exact)
    if_large = torch.min((max_exact + if_large).to(torch.long),
                         torch.full_like(distance, half - 1))
    return buckets + torch.where(distance < max_exact, distance, if_large)


def relative_table(p: dict, w: dict, t: int, device) -> torch.Tensor:
    """r [H, 2t - 1]: block 0's bucket embedding at each offset -(t-1) .. t-1."""
    idx = relative_position_bucket(torch.arange(1 - t, t), w["num_buckets"],
                                   w["max_bucket_distance"])
    return p[f"{BB}encoder.layers.0.rel_attn_embed.weight"][idx.to(device)].t()


def _ln(x, p, name, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], eps)


def _linear(x, p, name):
    return F.linear(x, p[name + ".weight"], p[name + ".bias"])


def _encode(p: dict, w: dict, wav: torch.Tensor) -> tuple[list, torch.Tensor]:
    """[B, T] waveforms -> (the outputs [B, T', D] of every block, the
    encoder's LayerNorm of the last)."""
    eps = w["layer_norm_eps"]
    x = wav[:, None, :]
    for i, st in enumerate(w["conv_stride"]):
        fe = f"{BB}feature_encoder."
        x = F.conv1d(x, p[f"{fe}conv_{i}.weight"], p.get(f"{fe}conv_{i}.bias"), stride=st)
        x = F.gelu(_ln(x.transpose(1, 2), p, f"{fe}layer_norm_{i}").transpose(1, 2))
    x = _ln(x.transpose(1, 2), p, f"{BB}feature_layer_norm", eps)
    x = _linear(x, p, f"{BB}post_extract_proj")
    k, g = w["pos_conv_kernel"], w["pos_conv_groups"]
    pos = F.conv1d(x.transpose(1, 2), p[f"{BB}encoder.pos_conv.conv.weight"],
                   p[f"{BB}encoder.pos_conv.conv.bias"], padding=k // 2, groups=g)
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos).transpose(1, 2)
    b, t, d = x.shape
    h = w["num_heads"]
    r = relative_table(p, w, t, x.device)
    q_idx, k_idx = torch.arange(t, device=x.device)[:, None], torch.arange(t, device=x.device)
    rel = r[:, k_idx[None, :] - q_idx + t - 1]  # [H, T, T]: r[h, j - i]
    outs = []
    for i in range(w["num_layers"]):
        pre = f"{BB}encoder.layers.{i}."
        u = _ln(x, p, pre + "self_attn_layer_norm", eps)
        q, kk, v = (_linear(u, p, pre + n).view(b, t, h, d // h).transpose(1, 2)
                    for n in ("q_proj", "k_proj", "v_proj"))
        proj = _linear(u.view(b, t, h, d // h).transpose(1, 2), p, pre + "gru_rel_pos_linear")
        gate_a, gate_b = torch.sigmoid(proj.view(b, h, t, 2, 4).sum(-1)).chunk(2, dim=-1)
        const = p[pre + "gru_rel_pos_const"].view(1, h, 1, 1)
        gate = gate_a * (gate_b * const - 1.0) + 2.0  # [B, H, T, 1]
        scores = (q / math.sqrt(d // h)) @ kk.transpose(-1, -2) + gate * rel
        att = torch.softmax(scores, dim=-1) @ v
        x = x + _linear(att.transpose(1, 2).reshape(b, t, d), p, pre + "out_proj")
        y = _ln(x, p, pre + "final_layer_norm", eps)
        x = x + _linear(F.gelu(_linear(y, p, pre + "fc1")), p, pre + "fc2")
        outs.append(x)
    return outs, _ln(x, p, f"{BB}encoder.layer_norm", eps)


def block_outputs(p: dict, w: dict, wav: torch.Tensor) -> list:
    """[B, T] waveforms -> the outputs [B, T', D] of every block."""
    return _encode(p, w, wav)[0]


def embed(p: dict, w: dict, wav: torch.Tensor) -> torch.Tensor:
    """[B, T] -> the [B, emb] scoring embeddings."""
    return head(p, _encode(p, w, wav)[1], "embedding")


def loss_layers(p: dict, w: dict, wav: torch.Tensor) -> list:
    """The block outputs and the loss embedding: the loss's inputs."""
    outs, last = _encode(p, w, wav)
    return outs + [head(p, last, "lossnet_embedding")]


def nomad_loss(p: dict, w: dict, estimate: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
    """The sum over the loss's inputs of the mean absolute difference."""
    with torch.no_grad():
        ref = loss_layers(p, w, clean)
    return sum((a - b).abs().mean() for a, b in zip(loss_layers(p, w, estimate), ref))


def loss_and_grad(p: dict, w: dict, estimate: torch.Tensor, clean: torch.Tensor,
                  rows: int) -> tuple[float, torch.Tensor]:
    """The loss of the whole [B, T] batch and its gradient with respect to
    the estimate, ``rows`` rows at a time (a block of n rows weighs n / B)."""
    bsz = estimate.shape[0]
    total, grad = 0.0, torch.empty_like(estimate)
    for s in range(0, bsz, rows):
        est = estimate[s:s + rows].detach().clone().requires_grad_(True)
        part = nomad_loss(p, w, est, clean[s:s + rows]) * (est.shape[0] / bsz)
        (g,) = torch.autograd.grad(part, est)
        total += float(part.detach())
        grad[s:s + rows] = g
    return total, grad
