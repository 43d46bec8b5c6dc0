"""Operators of the port: each kernel's wrapper beside its plain version."""

from .attention import dropout, mha, mha_dropout, mha_ref
from .distance import cdist, cdist_diag
from .flash_attention import (
    FlashAttention,
    FlashAttentionRel,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
    mha_flash,
    mha_flash_rel,
    relative_bias,
)
from .fused_attention import (
    FusedQKVAttention,
    fused_qkv_attention,
    fused_qkv_attention_ref,
    fused_qkv_mha,
)
from .layernorm import layer_norm, layer_norm_bwd_ref, layer_norm_ref

__all__ = [
    "FlashAttention",
    "FlashAttentionRel",
    "FusedQKVAttention",
    "cdist",
    "cdist_diag",
    "dropout",
    "flash_attention_bwd",
    "flash_attention_bwd_ref",
    "flash_attention_ref",
    "fused_qkv_attention",
    "fused_qkv_attention_ref",
    "fused_qkv_mha",
    "layer_norm",
    "layer_norm_bwd_ref",
    "layer_norm_ref",
    "mha",
    "mha_dropout",
    "mha_flash",
    "mha_flash_rel",
    "mha_ref",
    "relative_bias",
]
