"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1:2 [arXiv:2402.19427; hf].

Pattern: (rglru, rglru, local) repeated — 26 layers.  The RG-LRU is a gated
diagonal linear recurrence: the paper's technique applies DIRECTLY (scan +
Pallas diag_scan kernel + DPG spectral init of the recurrence magnitude).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv=1, d_ff=7680, vocab=256000,
    block_pattern=("rglru", "rglru", "local"), window=2048, d_rnn=2560,
    conv_width=4, embed_scale=True, supports_long_context=True,
    scan_layers=False,
)
