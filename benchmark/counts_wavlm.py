"""Operation counts and roofline bounds of WavLM Large's scoring forward
and of K1r, from a configuration's ``wavlm`` group and each input's own
length (never the padded one), whatever implements them. The frontend's
convolutions and the attention's two products are counted as
``counts.py`` counts wav2vec 2.0 BASE's."""

from __future__ import annotations

from . import counts

GATE_OUTPUTS = 8  # the gate's Linear(head_dim, 8) per head


def forward_flops(n: int, w: dict, emb_dim: int) -> dict:
    """FLOPs of one forward of one waveform of n samples, by part: the
    frontend's convolutions, the feature projection, the positional
    convolution, the blocks' products, the attention's two products over
    the file's own frames, the gates (their Linear per head slice) and the
    bias (a product and a sum a score), and the head."""
    p = counts.wav2vec2_forward_flops(n, w, emb_dim)
    t, d, h, layers = counts.frames(n, w)[-1], w["hidden_size"], w["num_heads"], w["num_layers"]
    p["gates"] = layers * 2.0 * t * d * GATE_OUTPUTS
    p["rel_bias"] = layers * 2.0 * h * t * t
    return p


def scoring_flops(files: list, calls: int, w: dict, emb_dim: int) -> float:
    """Every file of the completed calls, forward once."""
    return calls * sum(sum(forward_flops(n, w, emb_dim).values()) for n in files)


def k1r_bound(b: int, t: int, h: int, d: int, keys: int) -> tuple[float, str]:
    """K1r over b rows of t queries and ``keys`` valid keys in all: K1's
    work (``counts.flash_bound``), and one product and one sum a score, the
    gate [b, h, t] and the table [h, 2t - 1] read once."""
    flops = 2.0 * 2 * h * d * t * keys + 2.0 * h * t * keys
    nbytes = 4 * (2 * b * t * h * d + 2 * keys * h * d) + 4.0 * (b * h * t + b)
    nbytes += 4.0 * (b * h * t + h * (2 * t - 1))
    return counts.bound(nbytes, flops)


def k1r_needed_ms(files: list, calls: int, w: dict) -> float:
    """K1r's least time for each file over its own frames, every layer,
    every call."""
    h, d = w["num_heads"], w["hidden_size"] // w["num_heads"]
    per = sum(k1r_bound(1, f, h, d, f)[0] for f in (counts.frames(n, w)[-1] for n in files))
    return calls * w["num_layers"] * per


def layernorm_bytes(n: int, w: dict) -> float:
    """Bytes every LayerNorm of one forward of n samples reads and writes
    once (f32 in, f32 out): one after each frontend convolution at its
    width, the feature LayerNorm, two a block and the encoder's after the
    stack at the model width."""
    fr = counts.frames(n, w)
    rows_by_width = [(f, c) for f, c in zip(fr, w["conv_dim"])]
    rows_by_width.append((fr[-1], w["conv_dim"][-1]))
    rows_by_width.append(((2 * w["num_layers"] + 1) * fr[-1], w["hidden_size"]))
    return sum(2.0 * 4 * rows * width for rows, width in rows_by_width)


def layernorm_needed_ms(files: list, calls: int, w: dict) -> float:
    """The LayerNorms' least time (bytes at the HBM rate) for every file of
    the completed calls."""
    return calls * sum(layernorm_bytes(n, w) for n in files) / counts.HBM_BYTES_PER_S * 1e3
