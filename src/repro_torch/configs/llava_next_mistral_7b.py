"""llava-next-mistral-7b [vlm] — anyres tiling (STUB: input_specs provides
precomputed patch embeddings) [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified].  Mistral backbone: sliding-window 4096 => sub-quadratic =>
long_500k runs."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=32000,
    block_pattern=("swa",), window=4096, input_mode="embeddings",
    supports_long_context=True,
)
