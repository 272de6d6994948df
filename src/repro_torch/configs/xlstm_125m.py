"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

d_ff = 0 per assignment: blocks are self-contained (no separate FFN).
Both recurrences are diagonal-gated scans (paper technique applies).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv=4, d_ff=0, vocab=50304,
    block_pattern=("mlstm", "slstm"), supports_long_context=True,
    scan_layers=False, rope_theta=0.0,
)
