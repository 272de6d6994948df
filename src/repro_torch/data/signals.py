"""Reference input signals shared by benchmarks, drivers, examples, tests.

Single source of truth for the paper's MSO (multiple superimposed
oscillators) frequency table — four near-identical copies of this list had
started to drift before it was centralized here.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ALPHAS_FREQ", "mso_series"]

# The paper's MSO-k task frequencies: MSO-k superimposes the first k sines.
ALPHAS_FREQ = [0.2, 0.331, 0.42, 0.51, 0.63, 0.74, 0.85, 0.97, 1.08, 1.19,
               1.27, 1.32]


def mso_series(k: int, t: int) -> np.ndarray:
    """sum_{i<k} sin(alpha_i * t) for t in [0, T) — the MSO-k signal."""
    ts = np.arange(t)
    return sum(np.sin(a * ts) for a in ALPHAS_FREQ[:k])
