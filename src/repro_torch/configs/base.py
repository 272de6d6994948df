"""Architecture config schema + input-shape cells (assigned set)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    block_pattern: Tuple[str, ...] = ("attn",)
    qkv_bias: bool = False
    window: Optional[int] = None     # sliding/local attention window
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_ff: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25
    # recurrent
    d_rnn: Optional[int] = None
    conv_width: int = 4
    # enc-dec / frontends
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0
    input_mode: str = "tokens"       # tokens | embeddings
    max_position: int = 8192         # learned-positional capacity (enc-dec)
    # flavor
    norm: str = "rmsnorm"
    act: str = "silu"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    bidirectional_attn: bool = False
    embed_scale: bool = False
    dtype: str = "bfloat16"
    scan_layers: bool = True
    # which shape cells apply (long_500k only for sub-quadratic attention)
    supports_long_context: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.head_dim
        n = self.vocab * d  # embed
        if not self.tie_embeddings:
            n += d * self.vocab
        kinds = [self.block_pattern[i % len(self.block_pattern)]
                 for i in range(self.n_layers)]
        for k in kinds:
            if k in ("attn", "swa", "local"):
                n += d * hd * (self.n_heads + 2 * self.n_kv) + \
                    self.n_heads * hd * d
            elif k == "rglru":
                dr = self.d_rnn or d
                n += 2 * d * dr + self.conv_width * dr + 2 * dr * dr + dr + \
                    dr * d
            elif k == "mlstm":
                n += 4 * d * d + 2 * d * self.n_heads
            elif k == "slstm":
                n += 5 * d * d
            elif k == "reservoir":
                dr = self.d_rnn or d
                n += 4 * d * dr + 2 * dr
            if self.n_experts:
                n += d * self.n_experts + 3 * self.n_experts * d * self.moe_ff
                if self.dense_residual and self.d_ff:
                    n += 3 * d * self.d_ff
            elif self.d_ff:
                gated = self.act != "gelu"
                n += (3 if gated else 2) * d * self.d_ff
        if self.is_encoder_decoder:
            n += self.encoder_layers * (
                d * hd * (self.n_heads + 2 * self.n_kv) + self.n_heads * hd * d
                + 2 * d * self.d_ff)
            # decoder cross-attn
            n += self.n_layers * (d * hd * (self.n_heads + 2 * self.n_kv)
                                  + self.n_heads * hd * d)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        per_layer_moe = 3 * self.n_experts * self.d_model * self.moe_ff
        active_moe = 3 * self.top_k * self.d_model * self.moe_ff
        return full - self.n_layers * (per_layer_moe - active_moe)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def shape_cells(cfg: ArchConfig):
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        cells.append("long_500k")
    return [SHAPES[c] for c in cells]
