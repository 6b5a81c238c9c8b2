"""BART-family model configuration (counterpart of
``seal_tpu/models/config.py``, without jax): the same fields and presets,
with ``compute_dtype`` mapped to a torch dtype."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class BartConfig:
    vocab_size: int = 50265
    d_model: int = 1024
    encoder_layers: int = 12
    decoder_layers: int = 12
    encoder_attention_heads: int = 16
    decoder_attention_heads: int = 16
    encoder_ffn_dim: int = 4096
    decoder_ffn_dim: int = 4096
    max_position_embeddings: int = 1024
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 2
    mask_token_id: Optional[int] = 50264
    forced_bos_token_id: Optional[int] = None
    scale_embedding: bool = False
    # learned positions are offset by 2 (rows 0/1 unused), a fairseq quirk
    # the checkpoints depend on
    position_offset: int = 2
    dtype: str = "float32"  # compute dtype: "float32" | "bfloat16"
    # a training knob of the JAX package, unused here: kept so a JAX
    # config loads as BartConfig(**dataclasses.asdict(jax_cfg))
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def bart_large() -> BartConfig:
    return BartConfig()


def bart_base() -> BartConfig:
    """facebook/bart-base dimensions (HF config.json)."""
    return BartConfig(
        d_model=768,
        encoder_layers=6,
        decoder_layers=6,
        encoder_attention_heads=12,
        decoder_attention_heads=12,
        encoder_ffn_dim=3072,
        decoder_ffn_dim=3072,
    )


def bart_tiny(vocab_size: int = 128) -> BartConfig:
    """A small config for tests and CPU-runnable demos."""
    return BartConfig(
        vocab_size=vocab_size,
        d_model=32,
        encoder_layers=2,
        decoder_layers=2,
        encoder_attention_heads=4,
        decoder_attention_heads=4,
        encoder_ffn_dim=64,
        decoder_ffn_dim=64,
        max_position_embeddings=64,
        mask_token_id=None,
    )
