"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv=8, d_ff=4864, vocab=32000,
    block_pattern=("attn",), n_experts=128, top_k=2, moe_ff=4864,
    dense_residual=True,
)
