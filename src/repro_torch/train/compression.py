"""Int8 gradient compression with error feedback (the JAX package's
``train/compression.py``).

Each gradient leaf plus its carried residual is quantized to int8 with one
absmax scale per tensor; the quantization error is kept and re-injected at
the next step (Seide et al. 2014; Karimireddy et al. 2019).
``compress_decompress_ef`` models the round trip a data-parallel all-reduce
would carry; on one device it changes only the numerics.  Rounding is
half-to-even, as ``jnp.round``, so the int8 payload is bit-equal to the JAX
package's on the same float32 input.
"""
from __future__ import annotations

import torch

from ..tree import tree_map

__all__ = ["init_ef", "quantize", "dequantize", "compress_decompress_ef"]


def init_ef(params):
    """float32 zeros shaped (and, on a mesh, placed) as each param."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def quantize(x):
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.float() * scale


def compress_decompress_ef(grads, ef_state):
    """Returns ``(decompressed grads, new ef_state)``."""
    def one(g, e):
        corrected = g.float() + e
        q, scale = quantize(corrected)
        deq = dequantize(q, scale)
        return deq.to(g.dtype), corrected - deq

    pairs = tree_map(one, grads, ef_state)
    return (tree_map(lambda pr: pr[0], pairs),
            tree_map(lambda pr: pr[1], pairs))
