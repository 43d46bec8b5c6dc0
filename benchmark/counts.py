"""Operation counts and roofline bounds: the work a cell's inputs need,
counted from the configuration and each input's own length (never the
padded one), whatever implements it.

``bound``, ``flash_bound`` and ``flash_bwd_bounds`` are frozen copies of
``chip_smoke.py``'s functions of the same names (H100 SXM data-sheet peaks);
the model counts are new here."""

from __future__ import annotations

# H100 SXM data-sheet peaks at the 700 W limit: HBM rate, f32 without the
# tensor cores (the "exact" precision forbids TF32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def bound(nbytes: float, flops: float, peak_flops: float = F32_FLOPS) -> tuple[float, str]:
    """(least time in ms, what bounds it) for the bytes and operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound(b: int, t: int, h: int, d: int, keys: int, peak_flops: float = F32_FLOPS,
                io_bytes: int = 4, pv_passes: int = 1) -> tuple[float, str]:
    """The attention forward of b rows of t queries over ``keys`` valid
    keys in all: all t query rows written, keys past each bound never
    read. q, k, v and O ``io_bytes`` an element, LSE and lengths 4."""
    flops = 2.0 * (1 + pv_passes) * h * d * t * keys
    nbytes = io_bytes * (2 * b * t * h * d + 2 * keys * h * d) + 4.0 * (b * h * t + b)
    return bound(nbytes, flops, peak_flops)


def flash_bwd_bounds(b: int, t: int, h: int, d: int, keys: int, live: int,
                     peak_flops: float = F32_FLOPS, io_bytes: int = 4,
                     out_bytes: int | None = None, passes: int = 1) -> dict:
    """Per kernel of the attention backward: every (query row, valid key)
    pair costs the dQ kernel 6*D FLOP (s, dP, dQ) and the dK/dV kernel 8*D
    (s, dP, dK, dV). Bytes: the valid keys' k and v, q, dO, LSE and Di of
    the ``live`` rows that have a key, and the outputs, each once."""
    pairs = t * keys
    row = float(io_bytes) * h * d
    out_row = float(io_bytes if out_bytes is None else out_bytes) * h * d
    reads = 2 * keys * row + 2 * live * t * row + 2 * live * h * t * 4.0
    return {"dq": bound(reads + b * t * out_row, 2.0 * (2 + passes) * h * d * pairs, peak_flops),
            "dkv": bound(reads + 2 * b * t * out_row, 2.0 * (2 + 2 * passes) * h * d * pairs,
                         peak_flops)}


def frames(n: int, w: dict) -> list:
    """Frames after each convolution of the frontend for n samples."""
    out = []
    for k, s in zip(w["conv_kernel"], w["conv_stride"]):
        n = (n - k) // s + 1
        out.append(n)
    return out


def wav2vec2_forward_flops(n: int, w: dict, emb_dim: int) -> dict:
    """FLOPs of one forward of one waveform of n samples, by part: the
    frontend's convolutions, the feature projection, the positional
    convolution, the blocks' products and the attention's two products
    (over the file's own frames), and the head."""
    fr = frames(n, w)
    c_in, conv = 1, 0.0
    for c, k, t in zip(w["conv_dim"], w["conv_kernel"], fr):
        conv += 2.0 * c_in * k * c * t
        c_in = c
    t, d, f = fr[-1], w["hidden_size"], w["ffn_dim"]
    return {
        "frontend": conv,
        "proj": 2.0 * t * c_in * d,
        "pos_conv": 2.0 * t * d * (d // w["pos_conv_groups"]) * w["pos_conv_kernel"],
        "blocks": w["num_layers"] * 2.0 * t * (4 * d * d + 2 * d * f),
        "attention": w["num_layers"] * 4.0 * t * t * d,
        "head": 2.0 * d * emb_dim,
    }


def loss_step_flops(n: int, w: dict, emb_dim: int) -> float:
    """FLOPs that one row of the NOMAD loss and its gradient to the
    estimate need: the clean and the estimate forwards, and the backward of
    every product to its input (as many FLOPs as its forward; the
    attention's four products of the backward twice its forward), no
    weight gradient."""
    p = wav2vec2_forward_flops(n, w, emb_dim)
    fwd = sum(p.values())
    return 2 * fwd + (fwd - p["attention"]) + 2 * p["attention"]


def waveunet_levels(n: int, n_layers: int, ci: int) -> list:
    """(c_in, c_out, kernel, length) of every convolution of the Wave-U-Net
    on n samples, the first (which reads the input) first."""
    enc = [i * ci for i in range(1, n_layers + 1)]
    lengths = [n]
    for _ in range(n_layers):
        lengths.append((lengths[-1] + 1) // 2)
    out = [(([1] + enc[:-1])[i], enc[i], 15, lengths[i]) for i in range(n_layers)]
    out.append((n_layers * ci, n_layers * ci, 15, lengths[n_layers]))
    dec, length = enc[::-1], lengths[n_layers]
    dec_in = [n_layers * ci] + dec[:-1]
    for i in range(n_layers):
        length *= 2
        out.append((dec_in[i] + enc[n_layers - i - 1], dec[i], 5, length))
    out.append((ci + 1, 1, 1, length))
    return out


def se_step_flops(batch: int, n: int, n_layers: int, ci: int, w: dict, emb_dim: int) -> float:
    """FLOPs of one SE train step: the U-Net's forward and backward
    (weight gradients everywhere, input gradients past the first
    convolution) and the loss's clean and estimate forwards with the
    backward to the estimate."""
    unet = 0.0
    for i, (c_in, c_out, k, t) in enumerate(waveunet_levels(n, n_layers, ci)):
        fwd = 2.0 * c_in * k * c_out * t
        unet += fwd * (2 if i == 0 else 3)
    return batch * (unet + loss_step_flops(n, w, emb_dim))
