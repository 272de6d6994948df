"""qwen2-72b [dense] — GQA, QKV bias [arXiv:2407.10671; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_ff=29568, vocab=152064,
    block_pattern=("attn",), qkv_bias=True,
)
