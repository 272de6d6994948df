"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-360M; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv=5, d_ff=2560, vocab=49152,
    block_pattern=("attn",), tie_embeddings=True,
)
