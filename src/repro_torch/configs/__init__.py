"""Config registry: ``get_config(name)`` + reduced ``smoke_config(name)`` —
a copy of the JAX package's, pure Python."""
from __future__ import annotations

import dataclasses

from .base import ArchConfig, ShapeCell, SHAPES, shape_cells
from . import (arctic_480b, granite_3_2b, kimi_k2_1t, linear_esn,
               llava_next_mistral_7b, qwen2_72b, recurrentgemma_2b,
               smollm_135m, smollm_360m, whisper_tiny, xlstm_125m)

REGISTRY = {m.CONFIG.name: m.CONFIG for m in (
    smollm_360m, smollm_135m, qwen2_72b, granite_3_2b, recurrentgemma_2b,
    xlstm_125m, arctic_480b, kimi_k2_1t, llava_next_mistral_7b, whisper_tiny,
    linear_esn,
)}

ASSIGNED = [n for n in REGISTRY if n != "linear-esn"]


def get_config(name: str) -> ArchConfig:
    return REGISTRY[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config: small layers/width/vocab/experts, runnable
    on CPU for one forward/train step."""
    cfg = REGISTRY[name]
    pat = cfg.block_pattern
    n_layers = max(len(pat), 2)
    heads = min(cfg.n_heads, 4)
    kv = min(cfg.n_kv, heads)
    while heads % kv:
        kv -= 1
    d_model = 32 * heads
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=d_model,
        n_heads=heads,
        n_kv=kv,
        d_ff=0 if cfg.d_ff == 0 else 4 * d_model,
        vocab=128,
        window=min(cfg.window, 16) if cfg.window else None,
        n_experts=8 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.n_experts else 0,
        moe_ff=2 * d_model if cfg.n_experts else 0,
        d_rnn=d_model if cfg.d_rnn else None,
        encoder_layers=2 if cfg.is_encoder_decoder else 0,
        encoder_seq=24 if cfg.is_encoder_decoder else 0,
        max_position=256,
        dtype="float32",
    )


__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "shape_cells", "REGISTRY",
           "ASSIGNED", "get_config", "smoke_config"]
