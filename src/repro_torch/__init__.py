"""PyTorch/CUDA port of the diagonal linear reservoir (``repro`` is the JAX
reference it is held against).

Entry points default to the GPU: every builder, carry-over function, the
serving engine and the serving driver take ``device=None``, which means
``"cuda"``, and raise when no GPU is present unless the caller passes
``device="cpu"``.  The two hot kernels of the serving path
(``kernels.ops.diag_scan`` and ``kernels.ops.decode_fused``) are hand-written
CUDA C++ under ``csrc/``, built with ``nvcc`` at first use.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU.  A CUDA device without a GPU raises: the port
    never slides onto the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the host")
    return dev
