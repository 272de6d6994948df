"""whisper-tiny [audio] — enc-dec, conv frontend STUB (input_specs provides
precomputed frame embeddings (B, 1500, 384)) [arXiv:2212.04356; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv=6, d_ff=1536, vocab=51865,
    block_pattern=("attn",), is_encoder_decoder=True, encoder_layers=4,
    encoder_seq=1500, norm="layernorm", act="gelu", rope_theta=0.0,
    max_position=32768 + 8,
)
