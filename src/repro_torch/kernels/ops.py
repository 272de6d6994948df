"""The kernel wrappers: one entry per kernel, routed by the tensors' device.

A CUDA tensor launches the hand-written kernel (``kernels.diag_scan``); a
CPU tensor takes the plain PyTorch version (``kernels.ref``); any other
device raises — but inside :func:`shape_only` (the dry run's trace) a meta
tensor gets an empty output of the kernel's shape.  There is no fallback from a CUDA tensor to the plain version.
Each wrapper counts its kernel launches in its ``launches`` attribute, so a
run can show that its main path went through the kernels.

The scan is differentiable: :func:`diag_scan_lanes` is a
``torch.autograd.Function`` whose forward is the ``diag_scan`` kernel and
whose backward is the ``diag_scan_bwd`` kernel (each with its own counter),
and :func:`diag_scan` builds the complex entry on top of it, so
``torch.complex`` and ``.real``/``.imag`` carry the gradient.  Each counter
counts one per scan call, though a call may make two CUDA launches (the
chunked schedule of ``csrc/diag_scan.cu``).

The fused decode has one kernel with two entries: :func:`decode_fused` on
split (re, im) lanes (the JAX package's ``ops.decode_fused``) and
:func:`decode_fused_packed` on the engine's packed Q layout (what
``core.dispatch.run_decode_fused`` calls); both count in
``decode_fused.launches``.  Past the limits of ``csrc/decode_fused.cu``'s
layouts its streamed route (``csrc/decode_stream.cu``) runs the call, still
one launch, which also counts in ``decode_stream.launches``;
:func:`decode_stream` forces that route at any shape.

Attention has one kernel, ``flash_attention_fwd`` (``kernels.
flash_attention``), with two entries: :func:`flash_attention_fwd` returns
``(out, lse)`` and is what the model's ``jnp_flash`` calls;
:func:`flash_attention` is the counterpart of the JAX package's wrapper, a
``torch.autograd.Function`` whose backward recomputes through
``ref.attention_ref``.  Both count in ``flash_attention_fwd.launches``.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd.function import once_differentiable

from .. import dist
from . import ref
from .diag_scan import (decode_fused_cuda, decode_fused_packed_cuda,
                        diag_scan_lanes_bwd_cuda, diag_scan_lanes_cuda)
from .flash_attention import flash_attention_fwd_cuda

__all__ = ["shape_only", "diag_scan", "diag_scan_lanes", "diag_scan_bwd",
           "decode_fused",
           "decode_fused_packed", "decode_stream",
           "flash_attention_fwd", "flash_attention"]

_REAL = {torch.float32: torch.float32, torch.float64: torch.float64,
         torch.complex64: torch.float32, torch.complex128: torch.float64}


_SHAPE_ONLY = [False]


@contextlib.contextmanager
def shape_only():
    """Within it, the wrappers take meta tensors and return empty outputs
    of their kernels' shapes: the dry run traces shapes, and nothing runs
    (``launch.dryrun``)."""
    old, _SHAPE_ONLY[0] = _SHAPE_ONLY[0], True
    try:
        yield
    finally:
        _SHAPE_ONLY[0] = old


def _route(*tensors) -> str:
    devices = {t.device for t in tensors if t is not None and
               hasattr(t, "device")}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs must share one device, got "
                         f"{sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda") and not (kind == "meta" and
                                            _SHAPE_ONLY[0]):
        raise ValueError(f"no kernel for device type {kind!r}")
    return kind


def _like(v):
    """An empty tensor shaped as ``v`` (None for None): a kernel's output
    on the meta device, where the dry run traces shapes only."""
    return None if v is None else torch.empty_like(v)


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
        kind = _route(*args)
        if kind == "cpu":
            return ref.diag_scan_lanes_ref(*args)
        if kind == "meta":
            return _like(x_re), _like(x_im)
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
    kind = _route(*args)
    if kind == "cpu":
        return ref.diag_scan_lanes_bwd_ref(*args)
    if kind == "meta":
        return tuple(_like(v) for v in (a_re, a_im, g_re, g_im, h0_re,
                                        h0_im))
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
    if dist.is_dtensor(x_re):
        return _scan_on_local_lanes(a_re, a_im, x_re, x_im, h0_re, h0_im)
    if torch.is_grad_enabled():
        args = (a_re, a_im, x_re, x_im, h0_re, h0_im)
        if any(v is not None and v.requires_grad for v in args):
            _route(*args)
            return _DiagScanLanes.apply(*args)
    return _scan_forward(a_re, a_im, x_re, x_im, h0_re, h0_im)


def _scan_on_local_lanes(a_re, a_im, x_re, x_im, h0_re, h0_im):
    """The lane scan on DTensor operands, run on each rank's own batch rows
    and lanes (``local_map``): the scan is element-wise in N, so a split of
    the batch or of the lanes needs no collective.  Per mesh dim, x's split
    of its batch (dim 0) or lanes (dim 2) is kept and each other operand
    split alike on the dims it has; a split of time, or a partial sum, is
    replicated first.  An operand without a batch dim (``a`` of shape (N,)
    or (T, N), ``h0`` of shape (N,)) gets a gradient that is partial over
    the batch split: each rank sums its own rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x_re.device_mesh
    x_pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
            for p in x_re.placements]
    batched = {"a": a_re.ndim == 3, "h0": h0_re is not None and
               h0_re.ndim == 2}

    def like(v, has_batch, grad=False):
        if v is None:
            return None
        out = []
        for p in x_pl:
            if isinstance(p, Shard) and p.dim == 2:
                out.append(Shard(v.ndim - 1))
            elif isinstance(p, Shard) and has_batch:
                out.append(Shard(0))
            elif isinstance(p, Shard):
                out.append(Partial() if grad else Replicate())
            else:
                out.append(Replicate())
        return out
    ins = (like(a_re, batched["a"]), like(a_im, batched["a"]), x_pl,
           None if x_im is None else x_pl, like(h0_re, batched["h0"]),
           like(h0_im, batched["h0"]))
    grads = (like(a_re, batched["a"], True), like(a_im, batched["a"], True),
             x_pl, None if x_im is None else x_pl,
             like(h0_re, batched["h0"], True),
             like(h0_im, batched["h0"], True))
    run = local_map(diag_scan_lanes, out_placements=(x_pl, ins[3]),
                    in_placements=ins, in_grad_placements=grads,
                    device_mesh=mesh, redistribute_inputs=True)
    return run(a_re, a_im, x_re, x_im, h0_re, h0_im)


def _count_decode(out):
    """One B2 launch: count it (and its route's) and return its outputs."""
    *out, layout = out
    decode_fused.launches += 1
    if layout.streamed:
        decode_stream.launches += 1
    return tuple(out)


def decode_fused(a_re, a_im, h_re, h_im, y0, wd_re, wd_im, wy, b_out, wh_re,
                 wh_im, mask, *, k: int, ensemble: str = "off"):
    """K-token fused closed-loop decode on realified lanes (operands as in
    ``ref.decode_fused_ref``).  Returns ``(h_re, h_im, y, ys)``."""
    args = (a_re, a_im, h_re, h_im, y0, wd_re, wd_im, wy, b_out, wh_re,
            wh_im, mask)
    if _route(*args) == "cpu":
        return ref.decode_fused_ref(*args, k=k, ensemble=ensemble)
    return _count_decode(decode_fused_cuda(*args, k=k, ensemble=ensemble,
                                           with_layout=True))


decode_fused.launches = 0


def decode_fused_packed(lam_q, n_real: int, w_drive, w_out, states, y_prev,
                        mask, *, k: int, use_bias: bool, use_feedback: bool,
                        ensemble: str = "off"):
    """The same kernel on the engine's packed Q layout (operands as in
    ``ref.decode_fused_packed_ref``): one launch that reads and writes the
    packed state in place.  Counts in ``decode_fused.launches``.  Returns
    ``(states', y_prev', ys)``."""
    args = (lam_q, n_real, w_drive, w_out, states, y_prev, mask)
    kw = dict(k=k, use_bias=use_bias, use_feedback=use_feedback,
              ensemble=ensemble)
    if _route(lam_q, w_drive, w_out, states, y_prev, mask) == "cpu":
        return ref.decode_fused_packed_ref(*args, **kw)
    return _count_decode(decode_fused_packed_cuda(*args, **kw,
                                                  with_layout=True))


def decode_stream(a_re, a_im, h_re, h_im, y0, wd_re, wd_im, wy, b_out,
                  wh_re, wh_im, mask, *, k: int, ensemble: str = "off"):
    """:func:`decode_fused` through B2's streamed route at any shape (the
    route :func:`decode_fused` takes by itself only past the limits of
    ``kernels.diag_scan.decode_layout``); the plain version on the CPU.
    Counts in ``decode_stream.launches`` and ``decode_fused.launches``."""
    args = (a_re, a_im, h_re, h_im, y0, wd_re, wd_im, wy, b_out, wh_re,
            wh_im, mask)
    if _route(*args) == "cpu":
        return ref.decode_fused_ref(*args, k=k, ensemble=ensemble)
    return _count_decode(decode_fused_cuda(*args, k=k, ensemble=ensemble,
                                           stream=True, with_layout=True))


decode_stream.launches = 0


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
    kind = _route(q, k, v)
    if kind == "cpu":
        return ref.flash_attention_fwd_ref(q, k, v, **kw)
    if kind == "meta":
        return _like(q), q.new_empty(q.shape[:3], dtype=torch.float32)
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
