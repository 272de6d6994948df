"""The kernel wrappers: one entry per kernel, routed by the tensors' device.

A CUDA tensor launches the hand-written kernel (``kernels.diag_scan``); a
CPU tensor takes the plain PyTorch version (``kernels.ref``); any other
device raises.  There is no fallback from a CUDA tensor to the plain version.
Each wrapper counts its kernel launches in its ``launches`` attribute, so a
run can show that its main path went through the kernels.

The scan is differentiable: :func:`diag_scan_lanes` is a
``torch.autograd.Function`` whose forward is the ``diag_scan`` kernel and
whose backward is the ``diag_scan_bwd`` kernel (each with its own counter),
and :func:`diag_scan` builds the complex entry on top of it, so
``torch.complex`` and ``.real``/``.imag`` carry the gradient.  Each counter
counts one per scan call, though a call may make two CUDA launches (the
chunked schedule of ``csrc/diag_scan.cu``).

Attention has one kernel, ``flash_attention_fwd`` (``kernels.
flash_attention``), with two entries: :func:`flash_attention_fwd` returns
``(out, lse)`` and is what the model's ``jnp_flash`` calls;
:func:`flash_attention` is the counterpart of the JAX package's wrapper, a
``torch.autograd.Function`` whose backward recomputes through
``ref.attention_ref``.  Both count in ``flash_attention_fwd.launches``.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import ref
from .diag_scan import (decode_fused_cuda, diag_scan_lanes_bwd_cuda,
                        diag_scan_lanes_cuda)
from .flash_attention import flash_attention_fwd_cuda

__all__ = ["diag_scan", "diag_scan_lanes", "diag_scan_bwd", "decode_fused",
           "flash_attention_fwd", "flash_attention"]

_REAL = {torch.float32: torch.float32, torch.float64: torch.float64,
         torch.complex64: torch.float32, torch.complex128: torch.float64}


def _route(*tensors) -> str:
    devices = {t.device for t in tensors if t is not None and
               hasattr(t, "device")}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs must share one device, got "
                         f"{sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device type {kind!r}")
    return kind


def _lanes(v, dtype: torch.dtype, cplx: bool):
    """Contiguous (re, im) lanes of ``v`` in the real ``dtype`` (im None for
    a real scan); differentiable."""
    if v is None:
        return None, None
    if cplx:
        v = v.to(torch.complex128 if dtype == torch.float64
                 else torch.complex64)
        return v.real.contiguous(), v.imag.contiguous()
    return v.to(dtype).contiguous(), None


def diag_scan(a, x, h0=None):
    """h_t = a_t h_{t-1} + x_t over ``x`` (B, T, N); ``a``: (N,) / (T, N) /
    (B, T, N), real or complex; ``h0``: broadcasts to (B, N).  Returns all
    states (B, T, N) in the promoted dtype (float32/64 or complex64/128),
    differentiable in ``a``, ``x`` and ``h0`` through :func:`diag_scan_lanes`
    (PyTorch's convention for complex gradients)."""
    if x.ndim != 3:
        raise ValueError(f"x must be (B, T, N), got {tuple(x.shape)}")
    _route(a, x, h0)
    out_dtype = torch.promote_types(a.dtype, x.dtype)
    if h0 is not None:
        out_dtype = torch.promote_types(out_dtype, h0.dtype)
    if out_dtype not in _REAL:
        raise TypeError(f"diag_scan takes float32/float64 or "
                        f"complex64/complex128, got {out_dtype}")
    real, cplx = _REAL[out_dtype], out_dtype.is_complex
    o_re, o_im = diag_scan_lanes(*_lanes(a, real, cplx), *_lanes(x, real, cplx),
                                 *_lanes(h0, real, cplx))
    return torch.complex(o_re, o_im) if cplx else o_re


def _scan_forward(a_re, a_im, x_re, x_im, h0_re, h0_im):
    if not x_re.is_cuda:
        args = (a_re, a_im, x_re, x_im, h0_re, h0_im)
        if _route(*args) == "cpu":
            return ref.diag_scan_lanes_ref(*args)
    # The launcher checks that every operand lies on x's card.
    out = diag_scan_lanes_cuda(a_re, a_im, x_re, x_im, h0_re, h0_im)
    if x_re.numel():                # an empty scan launches nothing
        diag_scan.launches += 1
    return out


diag_scan.launches = 0


def diag_scan_bwd(a_re, a_im, h_re, h_im, g_re, g_im, h0_re=None, h0_im=None):
    """The gradient of the lane scan (operands as in
    ``ref.diag_scan_lanes_bwd_ref``): the ``diag_scan_bwd`` kernel on CUDA,
    the plain reverse-time loop on the CPU.  Returns ``(da_re, da_im, dx_re,
    dx_im, dh0_re, dh0_im)``, ``da``/``dh0`` summed to the shapes of
    ``a_re``/``h0_re``; counts in ``diag_scan_bwd.launches``."""
    args = (a_re, a_im, h_re, h_im, g_re, g_im, h0_re, h0_im)
    if _route(*args) == "cpu":
        return ref.diag_scan_lanes_bwd_ref(*args)
    out = diag_scan_lanes_bwd_cuda(*args)
    if g_re.numel():
        diag_scan_bwd.launches += 1
    return out


diag_scan_bwd.launches = 0


class _DiagScanLanes(torch.autograd.Function):
    """The lane scan with its backward; the kernels see detached tensors."""

    @staticmethod
    def forward(ctx, a_re, a_im, x_re, x_im, h0_re, h0_im):
        h_re, h_im = _scan_forward(a_re, a_im, x_re, x_im, h0_re, h0_im)
        ctx.save_for_backward(a_re, a_im, h0_re, h0_im, h_re, h_im)
        return h_re, h_im

    @staticmethod
    @once_differentiable
    def backward(ctx, g_re, g_im):
        a_re, a_im, h0_re, h0_im, h_re, h_im = ctx.saved_tensors
        return diag_scan_bwd(a_re, a_im, h_re, h_im, g_re, g_im, h0_re,
                             h0_im)


def diag_scan_lanes(a_re, a_im, x_re, x_im, h0_re=None, h0_im=None):
    """The scan on split (re, im) lanes: ``x_*`` (B, T, N), ``a_*`` (N,) /
    (T, N) / (B, T, N), ``h0_*`` broadcasting to (B, N); the ``_im``
    operands all None for a real scan.  Returns ``(h_re, h_im)``.
    Differentiable in every operand: the forward launches the ``diag_scan``
    kernel (``diag_scan.launches``), the backward the ``diag_scan_bwd``
    kernel (``diag_scan_bwd.launches``).  When grad mode is off or no
    operand requires grad, the forward runs without the autograd
    Function (its outputs have no ``grad_fn``)."""
    if x_re.ndim != 3:
        raise ValueError(f"x must be (B, T, N), got {tuple(x_re.shape)}")
    if torch.is_grad_enabled():
        args = (a_re, a_im, x_re, x_im, h0_re, h0_im)
        if any(v is not None and v.requires_grad for v in args):
            _route(*args)
            return _DiagScanLanes.apply(*args)
    return _scan_forward(a_re, a_im, x_re, x_im, h0_re, h0_im)


def decode_fused(a_re, a_im, h_re, h_im, y0, wd_re, wd_im, wy, b_out, wh_re,
                 wh_im, mask, *, k: int, ensemble: str = "off"):
    """K-token fused closed-loop decode on realified lanes (operands as in
    ``ref.decode_fused_ref``).  Returns ``(h_re, h_im, y, ys)``."""
    args = (a_re, a_im, h_re, h_im, y0, wd_re, wd_im, wy, b_out, wh_re,
            wh_im, mask)
    if _route(*args) == "cpu":
        return ref.decode_fused_ref(*args, k=k, ensemble=ensemble)
    out = decode_fused_cuda(*args, k=k, ensemble=ensemble)
    decode_fused.launches += 1
    return out


decode_fused.launches = 0


def flash_attention_fwd(q, k, v, *, causal=True, window=None, q_offset=0,
                        kv_len=None, scale=None):
    """Blocked online-softmax attention, ``(out, lse)``: the
    ``flash_attention_fwd`` kernel on CUDA, ``ref.flash_attention_fwd_ref``
    on the CPU.  q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) with GQA, causal,
    ``window``, ``q_offset`` and ``kv_len`` masks; ``out`` in q's dtype,
    ``lse`` float32 (B, Hq, Sq).  No padding: the kernel masks its own
    ragged edges.  Not differentiable by itself."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len,
              scale=scale)
    if _route(q, k, v) == "cpu":
        return ref.flash_attention_fwd_ref(q, k, v, **kw)
    out = flash_attention_fwd_cuda(q, k, v, **kw)
    if q.numel():                   # an empty query grid launches nothing
        flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The kernel forward; the backward recomputes through the dense
    ``ref.attention_ref``, as the JAX wrapper's ``_fa_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.masks = (causal, window, q_offset)
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)[0]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        causal, window, q_offset = ctx.masks
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = ref.attention_ref(*qkv, causal=causal, window=window,
                                    q_offset=q_offset)
            grads = torch.autograd.grad(out, qkv, g)
        return (*grads, None, None, None)


def flash_attention(q, k, v, causal=True, window=None, q_offset=0):
    """Attention with GQA / causal / window / ``q_offset`` (the JAX
    package's ``kernels.ops.flash_attention`` without its TPU tile padding):
    q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D); differentiable in q, k, v."""
    _route(q, k, v)
    return _FlashAttention.apply(q, k, v, causal, window, q_offset)
