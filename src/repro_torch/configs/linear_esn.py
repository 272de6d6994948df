"""The paper's own model family: a pure Linear Reservoir LM config.

A stack of LinearReservoir mixers (diagonal complex recurrence, DPG init) +
SwiGLU FFNs — the paper's technique as a standalone sequence model, used by
examples and the reservoir-LM scaling benchmarks.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="linear-esn", family="reservoir",
    n_layers=12, d_model=768, n_heads=4, n_kv=4, d_ff=2048, vocab=50304,
    block_pattern=("reservoir",), d_rnn=1024, supports_long_context=True,
    rope_theta=0.0,
)
