"""wav2vec 2.0 BASE backbone in PyTorch (counterpart of
``nomad_tpu.models.wav2vec2``).

Architecture: a 7-layer strided conv feature encoder (512 channels, no
bias, a GroupNorm(512) after layer 0 only, GELU after every layer; total
stride 320), LayerNorm(512) + Linear 512->768, a grouped positional conv
(k=128, groups=16) + GELU added to its input, LayerNorm, then 12 post-LN
transformer blocks (d=768, 12 heads, FFN 3072, GELU).

Exact masking, as in the JAX package: files are padded to bucket lengths
and batched, and the padded compute stays equal to the unpadded one. Conv
frame counts use the exact floor arithmetic, GroupNorm statistics are
masked, padded frames are re-zeroed after every bias and norm, and
attention skips padded keys. With ``lengths=None`` the padding takes part
everywhere (the reference's training semantics, quirk Q6).

Layout: modules take and return JAX's [B, T, C]; the conv stack runs in
PyTorch's [B, C, T] inside ``ConvFeatureEncoder``. Attention and every
LayerNorm go through ``ops`` (the hand-written CUDA kernels on the card,
their plain versions on the CPU). Which kernel each ``attention_impl``
takes on the card:

  * 'kernel'    — projections by ``nn.Linear``, attention K1 forward
                  (``csrc/flash_attention.cu``), K2 + K3 backward; at an
                  attention island of "default" K1b, K2b + K3b.
  * 'fused_qkv' — projections and attention in one kernel up to 1,024
                  frames, the out-projection one product: at an attention
                  island of "high" K4h (``csrc/fused_attention_bf16.cu``,
                  the TPU kernel's "high3"), at "highest" K4
                  (``csrc/fused_attention.cu``, f32), the backward
                  recomputing through K1 + K2 + K3; at "default" ("fast")
                  K4b (``csrc/fused_attention_bf16.cu``), the backward
                  through K1b + K2b + K3b. Longer inputs take the 'kernel'
                  path at the same precision (the JAX package's shape
                  rule).
  * 'ref'       — the plain versions, for holding the others against.

Every LayerNorm is K5 with ``layernorm_impl`` 'kernel', the plain version
with 'ref'.

Precision islands, as the JAX package places and resolves them from the
root ``matmul_precision``: the conv frontend at ``frontend_prec``,
``post_extract_proj`` at ``featproj_prec``, the positional conv at
``posconv_prec``; in each block the q/k/v/out projections at
``attn_prec``, the attention products at ``attn_score_prec`` (K1b on the
card at "default"), fc1 at ``ffn1_prec`` and fc2 at ``ffn2_prec``. The
fused path runs its whole attention sublayer (projections, both attention
products, out-projection) at ``attn_prec``, as the JAX package's fused
kernel has one mode ("balanced" keeps K4h, the "high" of "exact"). The
tail split (``encoder_tail_start``, ``encoder_tail_precision``) gives
every block from the tail's start on one island for all four; each block
resolves its islands once, when it is built.
``ops/precision.py`` says what each value means on the card; "high" and
"highest" are f32 ("exact") but inside the fused kernel, where "high"
is the TPU kernel's "high3".
``Wav2Vec2Config.balanced()`` and ``.fast()`` are the JAX package's
recipes. Gradients and dropout work under every island: a bf16 island's
backward rounds the operands of its products as JAX transposes them
(``ops/precision.py``), and the attention's backward at "default" is
K2b + K3b on the card.

``encoder_dtype=torch.bfloat16`` (the JAX package's ``encoder_dtype``,
which the trainer's ``fast_bf16`` sets) runs the block stack on bf16
activations: the stack's input is cast after the encoder LayerNorm, its
dropout and the mask, as the JAX package casts it; the products are bf16
in and out (``ops/precision.py``), GELU, dropout, the residual adds and
the masks run in bf16, the block LayerNorms are K5's bf16-I/O flavour and
the attention the bf16-I/O flavour of its island's kernels (K1b, K2b and
K3b at "default", K1-bf16, K2-bf16 and K3-bf16 at "high" or "highest";
f32 statistics and softmax inside). The fused path takes the bf16-I/O
flavour of K4b or K4h, or K4-bf16 at "highest", and, as the JAX package
hands its fused path the raw f32
parameters, the f32 products of ``precision.linear_raw_weights`` around
it. The two LayerNorms outside the stack stay f32, and the heads pool
in f32. Every island and every ``attention_impl`` takes it.

``dtype=torch.bfloat16`` (the JAX package's ``dtype``) runs the whole
backbone on bf16 activations, and the stack too unless ``encoder_dtype``
says otherwise: the waveform is rounded to bf16 at the input, each
convolution takes bf16 and gives bf16 (``precision.conv1d``: the f32
convolution of the upcast operands rounded once, the bias added in bf16),
the GroupNorm keeps f32 statistics and rounds its output once, GELU and
the masks run in bf16, both LayerNorms outside the stack are K5's
bf16-I/O flavour, the feature projection is a bf16 product, and the
scoring heads are flax's bf16 ``nn.Dense`` on the f32 pool, cast to f32
before the L2 norm.

Training (``deterministic=False``) applies dropout where the JAX package
does: after ``post_extract_proj``, after the encoder LayerNorm, on the
attention output, after the FFN's GELU (``activation_dropout``) and after
``fc2``; with ``attention_dropout > 0`` attention runs the plain
``mha_dropout`` on every ``attention_impl``, ``fused_qkv`` included. The
masks come from a ``torch.Generator``: the model draws one seed for the
frontend and one per block from it, and each block seeds its own
generator on the device, so that a block recomputed under ``remat``
(``torch.utils.checkpoint``) draws the masks it drew in the forward.
``remat_policy="dots"`` is ``jax.checkpoint_policies.dots_saveable`` as a
selective checkpoint: the outputs of the products (``mm``, ``addmm``,
``bmm``, ``baddbmm`` in every overload, those inside ``ops/precision.py``'s
autograd Functions included, and ``convolution``) are kept, everything else
is recomputed, the ctypes kernels K1 and K5 too, as JAX recomputes a
``pallas_call``. A
data-parallel rank passes ``rows`` (``ops.attention.BatchRows``): every
mask is drawn for the global batch and the rank keeps its rows, so the
ranks apply the single-process step's masks.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops import precision as prec_ops
from ..ops.attention import dropout, mha, mha_dropout
from ..ops.fused_attention import fused_qkv_attention
from ..ops.layernorm import layer_norm

ATTENTION_IMPLS = ("kernel", "fused_qkv", "ref")
LAYERNORM_IMPLS = ("kernel", "ref")
REMAT_POLICIES = ("full", "dots")
SEED_BOUND = 1 << 62  # seeds drawn for the frontend's and each block's masks
# the products remat_policy="dots" keeps, as dots_saveable keeps dot_general
# and conv_general_dilated (every overload: mm.dtype is the bf16 product)
_aten = torch.ops.aten
DOT_OPS = frozenset((_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm, _aten.convolution))
# the islands' fields, outermost first (the root, ``matmul_precision``,
# takes no None)
ISLAND_FIELDS = ("frontend_precision", "encoder_precision", "attn_precision", "ffn_precision",
                 "attn_score_precision", "ffn1_precision", "ffn2_precision",
                 "posconv_precision", "featproj_precision")
PRECISION_FIELDS = ("matmul_precision",) + ISLAND_FIELDS + ("encoder_tail_precision",)
DTYPES = (torch.float32, torch.bfloat16)
# the JAX package's recipes (nomad_tpu/models/wav2vec2.py:191-226):
# "balanced" (round-4 recipe C1) runs the positional conv, the attention
# products and fc1 in one bf16 pass; "fast" the whole encoder, with the
# frontend at "high"
BALANCED_ISLANDS = {"posconv_precision": "default", "attn_score_precision": "default",
                    "ffn1_precision": "default"}
FAST_ISLANDS = {"frontend_precision": "high", "encoder_precision": "default"}
PRECISION_ISLANDS = {"exact": {}, "balanced": BALANCED_ISLANDS, "fast": FAST_ISLANDS}


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    layer_norm_eps: float = 1e-5
    dropout: float = 0.1  # residual and input dropout (fairseq ``dropout``)
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    # fairseq BASE pretrains with layerdrop 0.05; 0 here, and anything else
    # is refused, as the JAX package refuses it
    layerdrop: float = 0.0
    # activation dtype of the whole backbone: torch.float32 or
    # torch.bfloat16 (the JAX package's ``dtype``; see the module docstring)
    dtype: torch.dtype = torch.float32
    # no autograd through the conv frontend (a frozen convnet): it runs
    # under no_grad, its output detached
    frontend_stop_gradient: bool = False
    # recompute each encoder block in the backward (torch.utils.checkpoint):
    # 'full' recomputes the whole block, 'dots' keeps the products' outputs
    # and recomputes the rest (JAX's dots_saveable)
    remat: bool = False
    remat_policy: str = "full"
    # 'kernel': the flash-attention / LayerNorm kernels (their plain
    # versions on the CPU). 'fused_qkv' (attention only): the
    # projection-fused kernel K4h (K4b at a "default" attention island, K4
    # at "highest").
    # 'ref': the plain versions everywhere, for holding the kernel paths
    # against them on the card.
    attention_impl: str = "kernel"
    layernorm_impl: str = "kernel"
    # precision of the products and convolutions, per island as in the JAX
    # package: "highest" | "high" (f32 on the card) | "default" (one bf16
    # pass); ops/precision.py maps them. ``matmul_precision`` is the root;
    # an island's None inherits the enclosing island.
    matmul_precision: str = "high"
    frontend_precision: str | None = None  # conv frontend, feature projection, pos-conv
    encoder_precision: str | None = None  # every product of the blocks
    attn_precision: str | None = None  # q/k/v/out projections and the attention's products
    ffn_precision: str | None = None  # fc1 and fc2
    attn_score_precision: str | None = None  # the attention's two products
    ffn1_precision: str | None = None
    ffn2_precision: str | None = None
    posconv_precision: str | None = None
    featproj_precision: str | None = None  # post_extract_proj
    # the blocks with index >= encoder_tail_start run every product at
    # encoder_tail_precision (replacing their attention and FFN islands);
    # -1 (or no tail precision) disables the split. Not with remat.
    encoder_tail_start: int = -1
    encoder_tail_precision: str | None = None
    # activation dtype inside the block stack: None (``dtype``'s),
    # torch.float32 or torch.bfloat16 (the trainer's fast_bf16); see the
    # module docstring
    encoder_dtype: torch.dtype | None = None

    @property
    def block_dtype(self) -> torch.dtype:
        return self.encoder_dtype if self.encoder_dtype is not None else self.dtype

    @property
    def frontend_prec(self):
        return self.frontend_precision or self.matmul_precision

    @property
    def encoder_prec(self):
        return self.encoder_precision or self.matmul_precision

    @property
    def attn_prec(self):
        return self.attn_precision or self.encoder_prec

    @property
    def ffn_prec(self):
        return self.ffn_precision or self.encoder_prec

    @property
    def attn_score_prec(self):
        return self.attn_score_precision or self.attn_prec

    @property
    def ffn1_prec(self):
        return self.ffn1_precision or self.ffn_prec

    @property
    def ffn2_prec(self):
        return self.ffn2_precision or self.ffn_prec

    @property
    def posconv_prec(self):
        return self.posconv_precision or self.frontend_prec

    @property
    def featproj_prec(self):
        return self.featproj_precision or self.frontend_prec

    @property
    def tail_split(self) -> bool:
        return self.encoder_tail_start >= 0 and self.encoder_tail_precision is not None

    def layer_islands(self, index: int) -> dict:
        """The islands of block ``index``: its attention projections'
        (``attn``), the attention's two products (``score``), fc1's and
        fc2's. A block of the tail takes ``encoder_tail_precision`` for all
        four (the JAX package's ``prec_override``)."""
        tail = self.encoder_tail_precision if (
            self.tail_split and index >= self.encoder_tail_start) else None
        return {"attn": tail or self.attn_prec, "score": tail or self.attn_score_prec,
                "ffn1": tail or self.ffn1_prec, "ffn2": tail or self.ffn2_prec}

    def __post_init__(self):
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by "
                f"num_heads {self.num_heads}"
            )
        if not (len(self.conv_dim) == len(self.conv_kernel) == len(self.conv_stride)):
            raise ValueError("conv_dim/conv_kernel/conv_stride length mismatch")
        for name, impls in (("attention_impl", ATTENTION_IMPLS),
                            ("layernorm_impl", LAYERNORM_IMPLS)):
            if getattr(self, name) not in impls:
                raise ValueError(f"{name} must be one of {impls}, got {getattr(self, name)!r}")
        for name in ("dropout", "attention_dropout", "activation_dropout"):
            if not 0.0 <= getattr(self, name) < 1.0:
                raise ValueError(f"{name} must lie in [0, 1), got {getattr(self, name)!r}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy must be one of {REMAT_POLICIES}, got {self.remat_policy!r}"
            )
        for name in PRECISION_FIELDS:
            prec_ops.check(getattr(self, name), name, allow_none=name != "matmul_precision")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {self.dtype!r}")
        if self.encoder_dtype is not None and self.encoder_dtype not in DTYPES:
            raise ValueError(f"encoder_dtype must be None, torch.float32 or torch.bfloat16, got "
                             f"{self.encoder_dtype!r}")
        # the JAX package's refusals, with its exception types
        if self.layerdrop:
            raise NotImplementedError(
                f"layerdrop {self.layerdrop!r} is not implemented (a documented divergence, "
                "as in the JAX package); set layerdrop=0")
        if self.tail_split:
            if self.remat:
                raise NotImplementedError(
                    "encoder_tail_precision with remat=True is not supported: the tail split "
                    "is a scoring-path feature, as in the JAX package")
            if self.encoder_tail_start >= self.num_layers:
                raise ValueError(
                    f"encoder_tail_start {self.encoder_tail_start} >= num_layers "
                    f"{self.num_layers}: the tail split selects no layer; set -1 to disable")

    @classmethod
    def base(cls, **kw) -> "Wav2Vec2Config":
        return cls(**kw)

    @classmethod
    def balanced(cls, **kw) -> "Wav2Vec2Config":
        """The JAX package's scoring default (round-4 recipe C1): one bf16
        pass on the positional conv, the attention products and fc1; f32
        ("high") everywhere else."""
        return cls(**(BALANCED_ISLANDS | kw))

    @classmethod
    def fast(cls, **kw) -> "Wav2Vec2Config":
        """The JAX package's round-2 recipe: one bf16 pass on every product
        of the encoder (the positional conv stays with the frontend at
        "high")."""
        return cls(**(FAST_ISLANDS | kw))

    @classmethod
    def tiny(cls, **kw) -> "Wav2Vec2Config":
        """Small config for unit tests (same topology, ~100x fewer params);
        the same widths as ``nomad_tpu``'s ``Wav2Vec2Config.tiny``."""
        defaults = dict(
            conv_dim=(32, 32, 32),
            conv_kernel=(10, 3, 2),
            conv_stride=(5, 2, 2),
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            ffn_dim=128,
            pos_conv_kernel=16,
            pos_conv_groups=4,
        )
        defaults.update(kw)
        return cls(**defaults)


def feature_frame_lengths(lengths, config: Wav2Vec2Config):
    """Sample lengths -> conv-encoder frame lengths (exact VALID-conv floor
    arithmetic: l' = (l - k)//s + 1 per layer). Ints or integer tensors."""
    l = lengths
    for k, s in zip(config.conv_kernel, config.conv_stride):
        l = (l - k) // s + 1
    return l


def _time_mask(length: int, lengths, dtype):
    """[B, length, 1] validity mask from per-item lengths."""
    idx = torch.arange(length, device=lengths.device)[None, :]
    return (idx < lengths[:, None]).to(dtype)[:, :, None]


def masked_mean(x, lengths=None):
    """Mean over time of [B, T, C]. With lengths, pools only valid frames
    (exact batch-1 parity); without, pools over the padded axis (quirk Q6)."""
    if lengths is None:
        return x.mean(dim=1)
    mask = _time_mask(x.shape[1], lengths, x.dtype)
    return (x * mask).sum(dim=1) / lengths[:, None].to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm through ``ops.layer_norm`` (kernel K5 or the plain
    version); parameters named like ``nn.LayerNorm``'s."""

    def __init__(self, features: int, eps: float = 1e-5, impl: str = "kernel"):
        super().__init__()
        self.eps = eps
        self.impl = impl
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, eps=self.eps, impl=self.impl)


class MaskedGroupNorm(nn.Module):
    """GroupNorm with num_groups == channels (per-channel instance norm over
    time) with masked statistics, so padded frames do not perturb valid
    ones; biased variance, eps 1e-5. Not ``nn.GroupNorm``, which cannot
    mask. Takes [B, C, T] (the conv stack's layout). Without autograd
    (inference/no-grad mode, or nothing requiring a gradient) it
    normalises x IN PLACE: at the scoring shape it is 6.4 GB, and its
    caller owns it. When a gradient is wanted it computes out of place
    with the same arithmetic, since autograd saved x for the products.
    A bf16 x is normalised in an f32 copy (f32 statistics) and the output
    rounded once to bf16, as the JAX package's ``MaskedGroupNorm``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, lengths=None):
        dtype = x.dtype
        x = x.to(torch.float32)
        inplace = not torch.is_grad_enabled() or not (
            x.requires_grad or self.weight.requires_grad or self.bias.requires_grad
        )
        if lengths is None:
            mean = x.mean(dim=-1, keepdim=True)
            x = x.sub_(mean) if inplace else x - mean
            var = x.square().mean(dim=-1, keepdim=True)
        else:
            mask = _time_mask(x.shape[-1], lengths, x.dtype)  # [B, T, 1]
            denom = lengths[:, None, None].to(x.dtype)
            # masked sums over time as batched mat-vec products: no [B, C, T]
            # temporary for x * mask
            mean = torch.bmm(x, mask) / denom
            x = x.sub_(mean) if inplace else x - mean
            var = torch.bmm(x.square(), mask) / denom
        rstd = torch.rsqrt(var + self.eps)
        w, b = self.weight[:, None], self.bias[:, None]
        if inplace:
            x.mul_(rstd).mul_(w).add_(b)
            if lengths is not None:
                x.mul_(mask.transpose(1, 2))
            return x.to(dtype)
        x = x * rstd * w + b
        return (x if lengths is None else x * mask.transpose(1, 2)).to(dtype)


class ConvFeatureEncoder(nn.Module):
    """fairseq ConvFeatureExtractionModel, mode='default'. [B, T] waveform
    -> ([B, T', C] features in ``dtype``, frame lengths)."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        c_in = 1
        for i, (dim, k, s) in enumerate(
            zip(config.conv_dim, config.conv_kernel, config.conv_stride)
        ):
            setattr(self, f"conv_{i}", nn.Conv1d(c_in, dim, k, stride=s, bias=False))
            c_in = dim
        self.group_norm = MaskedGroupNorm(config.conv_dim[0], eps=1e-5)

    def forward(self, wav, lengths=None):
        cfg = self.config
        x = wav.to(cfg.dtype)[:, None, :]  # [B, 1, T]
        l = lengths
        for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
            conv = getattr(self, f"conv_{i}")
            x = prec_ops.conv1d(x, conv.weight, None, cfg.frontend_prec, stride=s)
            if l is not None:
                l = (l - k) // s + 1
            if i == 0:
                x = self.group_norm(x, l)
            x = F.gelu(x)
            if l is not None:
                x.mul_(_time_mask(x.shape[-1], l, x.dtype).transpose(1, 2))
        return x.transpose(1, 2).contiguous(), l


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embedding (the fairseq weight norm composed
    into one kernel); SamePad drops the trailing frame for an even kernel."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        k = config.pos_conv_kernel
        self.kernel = k
        self.prec = config.posconv_prec
        self.conv = nn.Conv1d(
            config.hidden_size, config.hidden_size, k,
            padding=k // 2, groups=config.pos_conv_groups, bias=True,
        )

    def forward(self, x):
        c = self.conv
        y = prec_ops.conv1d(x.transpose(1, 2), c.weight, c.bias, self.prec,
                            padding=c.padding, groups=c.groups)
        if self.kernel % 2 == 0:
            y = y[:, :, :-1].contiguous()
        return F.gelu(y).transpose(1, 2)


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_saveable)


def _generator(seed, device):
    """The device generator for one seed; None (deterministic) for None."""
    return None if seed is None else torch.Generator(device=device).manual_seed(seed)


class EncoderLayer(nn.Module):
    """Post-LN transformer block (fairseq TransformerSentenceEncoderLayer,
    layer_norm_first=False); padded frames re-zeroed after the block.
    ``seed`` None is deterministic; an int seeds the block's dropout masks.
    ``index``, the block's place in the stack, selects its islands
    (``Wav2Vec2Config.layer_islands``: the tail split is static)."""

    def __init__(self, config: Wav2Vec2Config, index: int):
        super().__init__()
        self.config = config
        self.islands = config.layer_islands(index)
        d = config.hidden_size
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        self.fc1 = nn.Linear(d, config.ffn_dim)
        self.fc2 = nn.Linear(config.ffn_dim, d)
        eps, impl = config.layer_norm_eps, config.layernorm_impl
        self.self_attn_layer_norm = LayerNorm(d, eps, impl)
        self.final_layer_norm = LayerNorm(d, eps, impl)

    def forward(self, x, key_mask=None, seed=None, rows=None):
        cfg, isl = self.config, self.islands
        b, t, d = x.shape
        h = cfg.num_heads
        g = _generator(seed, x.device)
        attn_dropout = g is not None and cfg.attention_dropout > 0.0
        if cfg.attention_impl == "fused_qkv" and not attn_dropout:
            # the fused kernel has one mode for the whole attention
            # sublayer, from the attention island as in the JAX package
            # (the score island does not subdivide it): "default" is K4b,
            # "high" K4h (the TPU kernel's "high3": bf16 x 3), "highest" the
            # f32 K4. The same parameters as the unfused path: one
            # state_dict loads both
            attn = fused_qkv_attention(
                x, self.q_proj.weight, self.q_proj.bias, self.k_proj.weight,
                self.k_proj.bias, self.v_proj.weight, self.v_proj.bias,
                self.out_proj.weight, self.out_proj.bias, key_mask=key_mask, heads=h,
                precision=isl["attn"],
            )
        else:
            q, k, v = (prec_ops.linear(x, p.weight, p.bias, isl["attn"]).view(b, t, h, d // h)
                       for p in (self.q_proj, self.k_proj, self.v_proj))
            if attn_dropout:
                attn = mha_dropout(q, k, v, key_mask, cfg.attention_dropout, g,
                                   precision=isl["score"], rows=rows)
            else:
                attn = mha(q, k, v, key_mask=key_mask, impl=cfg.attention_impl,
                           precision=isl["score"])
            attn = prec_ops.linear(attn.reshape(b, t, d), self.out_proj.weight,
                                   self.out_proj.bias, isl["attn"])
        x = self.self_attn_layer_norm(x + dropout(attn, cfg.dropout, g, rows))
        y = prec_ops.linear(x, self.fc1.weight, self.fc1.bias, isl["ffn1"])
        y = dropout(F.gelu(y), cfg.activation_dropout, g, rows)
        y = prec_ops.linear(y, self.fc2.weight, self.fc2.bias, isl["ffn2"])
        x = self.final_layer_norm(x + dropout(y, cfg.dropout, g, rows))
        if key_mask is not None:
            x = x * key_mask.to(x.dtype)[:, :, None]
        return x


class TransformerEncoder(nn.Module):
    """pos-conv + LayerNorm + the post-LN blocks; returns the list of the
    blocks' outputs, each [B, T, C] in ``block_dtype`` (fairseq
    ``layer_results``)."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        self.pos_conv = PositionalConvEmbedding(config)
        self.layer_norm = LayerNorm(
            config.hidden_size, config.layer_norm_eps, config.layernorm_impl
        )
        self.layers = nn.ModuleList(EncoderLayer(config, i) for i in range(config.num_layers))

    def forward(self, x, frame_lengths=None, generator=None, seeds=None, rows=None):
        """``generator``: the input dropout's (None: deterministic);
        ``seeds``: one per block, or None; ``rows``: a data-parallel rank's
        rows of the global batch, or None."""
        key_mask = None
        if frame_lengths is not None:
            key_mask = torch.arange(x.shape[1], device=x.device)[None, :] < frame_lengths[:, None]
            x = x * key_mask.to(x.dtype)[:, :, None]
        x = dropout(self.layer_norm(x + self.pos_conv(x)), self.config.dropout, generator, rows)
        if key_mask is not None:
            x = x * key_mask.to(x.dtype)[:, :, None]
        x = x.to(self.config.block_dtype)
        remat = self.config.remat and torch.is_grad_enabled()
        outs = []
        for i, layer in enumerate(self.layers):
            seed = None if seeds is None else seeds[i]
            if remat:
                # the block seeds its own generator, so the recompute draws
                # the same masks without the default generators' states
                kw = {"context_fn": _dots_context} if self.config.remat_policy == "dots" else {}
                x = checkpoint(layer, x, key_mask, seed, rows, use_reentrant=False,
                               preserve_rng_state=False, **kw)
            else:
                x = layer(x, key_mask, seed, rows)
            outs.append(x)
        return outs


class Wav2Vec2Model(nn.Module):
    """Full backbone. Returns a dict with
      'x'             — final block output [B, T', C] (== layers[-1])
      'layers'        — list of the num_layers block outputs [B, T', C]
      'frame_lengths' — [B] valid frame counts (None when lengths is None)
    """

    def __init__(self, config: Wav2Vec2Config = Wav2Vec2Config()):
        super().__init__()
        self.config = config
        self.feature_encoder = ConvFeatureEncoder(config)
        self.feature_layer_norm = LayerNorm(
            config.conv_dim[-1], config.layer_norm_eps, config.layernorm_impl
        )
        self.post_extract_proj = nn.Linear(config.conv_dim[-1], config.hidden_size)
        self.encoder = TransformerEncoder(config)

    def forward(self, wav, lengths=None, deterministic: bool = True, generator=None,
                rows=None):
        """``deterministic=False`` applies dropout. ``generator``, a CPU
        ``torch.Generator`` (None: torch's default one), gives the seeds of
        the masks, which are drawn on the waveform's device. ``rows``: the
        global rows of a data-parallel rank's batch (``BatchRows``)."""
        cfg = self.config
        g = seeds = None
        if not deterministic:
            seeds = torch.randint(SEED_BOUND, (1 + cfg.num_layers,), generator=generator).tolist()
            g = _generator(seeds.pop(0), wav.device)
        if cfg.frontend_stop_gradient:
            with torch.no_grad():
                feats, frame_lengths = self.feature_encoder(wav, lengths)
            feats = feats.detach()
        else:
            feats, frame_lengths = self.feature_encoder(wav, lengths)
        p = self.post_extract_proj
        x = prec_ops.linear(self.feature_layer_norm(feats), p.weight, p.bias, cfg.featproj_prec)
        x = dropout(x, cfg.dropout, g, rows)
        if frame_lengths is not None:
            x = x * _time_mask(x.shape[1], frame_lengths, x.dtype)
        layers = self.encoder(x, frame_lengths, g, seeds, rows)
        return {"x": layers[-1], "layers": layers, "frame_lengths": frame_lengths}
