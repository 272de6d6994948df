"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384e top-8
[arXiv:2501.kimi2; unverified].  Uniform 61-layer MoE (first-dense-layer /
shared-expert variants noted in DESIGN.md but not modeled)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv=8, d_ff=2048, vocab=163840,
    block_pattern=("attn",), n_experts=384, top_k=8, moe_ff=2048,
)
