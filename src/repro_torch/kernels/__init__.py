"""Kernels of the port: CUDA C++ for Hopper (``csrc/``), their launchers,
the device-routed wrappers (``ops``) and the plain versions (``ref``).
Importing them builds nothing: each library is compiled with ``nvcc`` at
its first launch (``build``).

diag_scan        — the diagonal recurrence (B1) and the fused decode (B2).
flash_attention  — blocked online-softmax attention (B3).
ops              — device-routed wrappers + autograd.   ref — plain oracles.

As in the JAX namespace, ``kernels.diag_scan`` and ``kernels.flash_attention``
are the wrappers ``ops.diag_scan`` and ``ops.flash_attention``; the launcher
modules of the same names are imported by their full path
(``from repro_torch.kernels.diag_scan import decode_layout``).
"""
from . import ops, ref
from .ops import diag_scan, flash_attention

__all__ = ["ops", "ref", "diag_scan", "flash_attention"]
