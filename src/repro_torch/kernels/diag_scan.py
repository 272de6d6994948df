"""Launchers of the Hopper kernels in ``csrc/diag_scan.cu``.

``diag_scan_lanes_cuda`` (split (re, im) lanes), ``diag_scan_cuda`` (real or
complex tensors, split into lanes) and ``decode_fused_cuda`` take CUDA
tensors, check every
input (device, dtype, shape, contiguity, the one-block limits of the decode
kernel), allocate the outputs with ``torch.empty``, and launch on PyTorch's
current stream without synchronising.  They raise when the C entry point
reports a CUDA error.  ``kernels.ops`` routes CPU tensors to the plain
versions instead; nothing here runs without a GPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .ref import live_mask

__all__ = ["diag_scan_cuda", "diag_scan_lanes_cuda", "decode_fused_cuda",
           "decode_layout",
           "DECODE_MAX_THREADS", "DECODE_MAX_PER_THREAD",
           "DECODE_MAX_SMEM_BYTES"]

#: One thread block runs the whole decode; each thread holds at most
#: DECODE_MAX_PER_THREAD lanes, and the block's shared memory stays in the
#: 48 KB a launch gets without opting in.
DECODE_MAX_THREADS = 1024
DECODE_MAX_PER_THREAD = 8
DECODE_MAX_SMEM_BYTES = 48 * 1024

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "diag_scan": [_VP, _VP, _LL, _LL, _VP, _VP, _VP, _VP, _LL, _VP, _VP,
                  _INT, _INT, _INT, _INT, _VP],
    "decode_fused": [_VP, _VP, _LL, _VP, _VP, _VP, _VP, _VP, _LL, _VP, _LL,
                     _VP, _LL, _VP, _VP, _LL, _VP, _VP, _VP, _VP, _VP,
                     _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VP],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_REAL = {torch.float32: torch.float32, torch.float64: torch.float64,
         torch.complex64: torch.float32, torch.complex128: torch.float64}


def _entry(name: str, dtype: torch.dtype):
    lib = build.library("diag_scan")
    fn = getattr(lib, f"{name}_{_SUFFIX[dtype]}")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(rc: int) -> None:
    if rc != 0:
        lib = build.library("diag_scan")
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel launch failed: error {rc} ({msg})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _same_device(device: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def _lanes(v: torch.Tensor, dtype: torch.dtype, cplx: bool):
    """Contiguous (re, im) lane tensors of ``v`` in the real ``dtype``."""
    if cplx:
        v = v.to(torch.complex128 if dtype == torch.float64
                 else torch.complex64)
        return v.real.contiguous(), v.imag.contiguous()
    return v.to(dtype).contiguous(), None


# --------------------------------------------------------------------------- #
# B1: diag_scan                                                                #
# --------------------------------------------------------------------------- #
def _lane_strides(name, re, im, shape):
    """Strides of ``re`` broadcast to ``shape`` (the kernel reads ``re`` and
    ``im`` through the same ones); the lane axis must have stride 1."""
    if re is None:
        return (0,) * len(shape)
    try:
        strides = re.expand(shape).stride()
        im_strides = strides if im is None else im.expand(shape).stride()
    except RuntimeError as e:
        raise ValueError(f"{name} {tuple(re.shape)} does not broadcast to "
                         f"{tuple(shape)}") from e
    if (shape[-1] > 1 and strides[-1] != 1) or im_strides != strides:
        raise ValueError(f"{name}_re and {name}_im must share one layout "
                         f"with unit lane stride")
    return strides


def diag_scan_lanes_cuda(a_re, a_im, x_re, x_im, h0_re=None, h0_im=None):
    """h_t = a_t h_{t-1} + x_t on split (re, im) lanes through the kernel.

    ``x_*``: contiguous (B, T, N); ``a_*``: anything that broadcasts to
    (B, T, N) lane-wise — (N,), (T, N), (B, T, N) — read through strides,
    never materialized; ``h0_*``: broadcasts to (B, N).  All float32 or all
    float64; ``a_im``, ``x_im`` and ``h0_im`` are all None for a real scan.
    Returns ``(o_re, o_im)`` (``o_im`` None for a real scan).  Forward
    only: raises if any input requires grad.
    """
    if x_re.ndim != 3:
        raise ValueError(f"x must be (B, T, N), got {tuple(x_re.shape)}")
    dev, dtype = x_re.device, x_re.dtype
    if dev.type != "cuda":
        raise ValueError(f"diag_scan kernel needs CUDA tensors, got {dev}")
    if dtype not in _SUFFIX:
        raise TypeError(f"diag_scan kernel takes float32/float64 lanes, "
                        f"got {dtype}")
    cplx = x_im is not None
    if (a_im is not None) != cplx or (
            h0_re is not None and (h0_im is not None) != cplx) or (
            h0_re is None and h0_im is not None):
        raise ValueError("a_im, x_im and h0_im must be given together (a "
                         "complex scan) or all be None (a real scan)")
    named = dict(a_re=a_re, a_im=a_im, x_re=x_re, x_im=x_im, h0_re=h0_re,
                 h0_im=h0_im)
    for name, v in named.items():
        if v is None:
            continue
        if v.device != dev or v.dtype != dtype:
            raise ValueError(f"{name} must be a {dtype} tensor on {dev}, "
                             f"got {v.dtype} on {v.device}")
        if v.requires_grad:
            raise RuntimeError(
                "the diag_scan CUDA kernel has no backward yet: inputs must "
                "not require grad")
    b, t, n = x_re.shape
    if not x_re.is_contiguous() or (cplx and (
            x_im.shape != x_re.shape or not x_im.is_contiguous())):
        raise ValueError("x_re and x_im must be contiguous (B, T, N) tensors")
    a_sb, a_st, _ = _lane_strides("a", a_re, a_im, (b, t, n))
    h0_sb, _ = _lane_strides("h0", h0_re, h0_im, (b, n))
    o_re = torch.empty((b, t, n), dtype=dtype, device=dev)
    o_im = torch.empty_like(o_re) if cplx else None
    rc = _entry("diag_scan", dtype)(
        _ptr(a_re), _ptr(a_im), a_sb, a_st, _ptr(x_re), _ptr(x_im),
        _ptr(h0_re), _ptr(h0_im), h0_sb, _ptr(o_re), _ptr(o_im), b, t, n,
        int(cplx), _stream(dev))
    _check(rc)
    return o_re, o_im


def diag_scan_cuda(a, x, h0=None):
    """h_t = a_t h_{t-1} + x_t through the CUDA kernel, on real or complex
    tensors (float32/float64, complex64/128): ``x`` (B, T, N), ``a``
    broadcasting to it, ``h0`` to (B, N).  Splits complex operands into
    (re, im) lanes for :func:`diag_scan_lanes_cuda`."""
    if x.ndim != 3:
        raise ValueError(f"x must be (B, T, N), got {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"diag_scan_cuda needs CUDA tensors, got {x.device}")
    _same_device(x.device, a=a, h0=h0)
    if any(v is not None and v.requires_grad for v in (a, x, h0)):
        raise RuntimeError(
            "the diag_scan CUDA kernel has no backward yet: inputs must not "
            "require grad")
    dtypes = [a.dtype, x.dtype] + ([] if h0 is None else [h0.dtype])
    out_dtype = dtypes[0]
    for d in dtypes[1:]:
        out_dtype = torch.promote_types(out_dtype, d)
    if out_dtype not in _REAL:
        raise TypeError(f"diag_scan kernel takes float32/float64 or "
                        f"complex64/complex128, got {out_dtype}")
    real = _REAL[out_dtype]
    cplx = out_dtype.is_complex
    a_re, a_im = _lanes(a, real, cplx)
    x_re, x_im = _lanes(x, real, cplx)
    h0_re, h0_im = (None, None) if h0 is None else _lanes(h0, real, cplx)
    o_re, o_im = diag_scan_lanes_cuda(a_re, a_im, x_re, x_im, h0_re, h0_im)
    return torch.complex(o_re, o_im) if cplx else o_re


# --------------------------------------------------------------------------- #
# B2: decode_fused                                                             #
# --------------------------------------------------------------------------- #
def decode_layout(b: int, nc: int, d: int, itemsize: int):
    """``(threads_per_row, lanes_per_thread)`` of the one-block decode, or a
    ValueError stating the limit the shape exceeds."""
    if not 1 <= b <= DECODE_MAX_THREADS:
        raise ValueError(f"decode_fused kernel runs one thread block: "
                         f"1 <= B <= {DECODE_MAX_THREADS}, got B={b}")
    tpr = 1
    while (2 * tpr * b <= DECODE_MAX_THREADS and tpr < nc):
        tpr *= 2
    per = -(-nc // tpr)
    if per > DECODE_MAX_PER_THREAD:
        raise ValueError(
            f"decode_fused kernel holds at most {DECODE_MAX_PER_THREAD} lanes "
            f"per thread in one block of {DECODE_MAX_THREADS} threads: "
            f"NC={nc} with B={b} needs NC <= {DECODE_MAX_PER_THREAD * tpr}")
    smem = itemsize * (2 * b * d + b + b * tpr)
    if smem > DECODE_MAX_SMEM_BYTES:
        raise ValueError(
            f"decode_fused kernel keeps y (B, D) twice in shared memory: "
            f"B={b}, D={d} needs {smem} bytes > {DECODE_MAX_SMEM_BYTES}")
    return tpr, per


def _batch_stride(name, w, shared_shape, b, dtype, device) -> int:
    """0 for a shared ``shared_shape`` operand, the slot stride for a
    per-slot ``(b,) + shared_shape`` one; checks dtype, device, layout."""
    if tuple(w.shape) == shared_shape:
        sb = 0
    elif tuple(w.shape) == (b,) + shared_shape:
        sb = w[0].numel()
    else:
        raise ValueError(f"{name} must be {shared_shape} or "
                         f"{(b,) + shared_shape}, got {tuple(w.shape)}")
    if w.dtype != dtype or w.device != device or not w.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                         f"{device}, got {w.dtype} on {w.device}")
    return sb


def _pair_stride(name, re, im, shared_shape, b, dtype, device) -> int:
    sb = _batch_stride(name + "_re", re, shared_shape, b, dtype, device)
    if _batch_stride(name + "_im", im, shared_shape, b, dtype, device) != sb:
        raise ValueError(f"{name}_re and {name}_im must share one layout")
    return sb


def decode_fused_cuda(a_re, a_im, h_re, h_im, y0, wd_re, wd_im, wy, b_out,
                      wh_re, wh_im, mask, *, k: int, ensemble: str = "off"):
    """K closed-loop decode steps through the one-block CUDA kernel.

    Same operands and result as ``ref.decode_fused_ref``: ``h_*`` (B, NC),
    ``y0`` (B, D), shared 2D or per-slot 3D weights, ``mask`` (B,).
    Returns ``(h_re, h_im, y, ys)`` with ``ys`` (k, B, D)."""
    if ensemble not in ("off", "mean"):
        raise ValueError(f"ensemble must be 'off' or 'mean', got {ensemble!r}")
    if y0.ndim != 2 or h_re.ndim != 2:
        raise ValueError("h_* must be (B, NC) and y0 (B, D)")
    dev, dtype = y0.device, y0.dtype
    if dev.type != "cuda":
        raise ValueError(f"decode_fused_cuda needs CUDA tensors, got {dev}")
    if dtype not in _SUFFIX:
        raise TypeError(f"decode_fused kernel takes float32/float64, got {dtype}")
    if int(k) < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    (b, d), nc = y0.shape, h_re.shape[1]
    # The state is per slot: the shared form is not accepted.
    _batch_stride("y0", y0, (b, d), 0, dtype, dev)
    _pair_stride("h", h_re, h_im, (b, nc), 0, dtype, dev)
    a_sb = _pair_stride("a", a_re, a_im, (nc,), b, dtype, dev)
    wd_sb = _pair_stride("wd", wd_re, wd_im, (d, nc), b, dtype, dev)
    wy_sb = _batch_stride("wy", wy, (d, d), b, dtype, dev)
    bo_sb = _batch_stride("b_out", b_out, (d,), b, dtype, dev)
    wh_sb = _pair_stride("wh", wh_re, wh_im, (nc, d), b, dtype, dev)
    mask = torch.as_tensor(mask, device=dev)
    if tuple(mask.shape) != (b,):
        raise ValueError(f"mask must be ({b},), got {tuple(mask.shape)}")
    m = live_mask(mask, dtype)[1][:, 0].contiguous()
    tpr, per = decode_layout(b, nc, d, y0.element_size())
    o_h_re = torch.empty((b, nc), dtype=dtype, device=dev)
    o_h_im = torch.empty_like(o_h_re)
    o_y = torch.empty((b, d), dtype=dtype, device=dev)
    o_ys = torch.empty((int(k), b, d), dtype=dtype, device=dev)
    rc = _entry("decode_fused", dtype)(
        _ptr(a_re), _ptr(a_im), a_sb, _ptr(h_re), _ptr(h_im), _ptr(y0),
        _ptr(wd_re), _ptr(wd_im), wd_sb, _ptr(wy), wy_sb, _ptr(b_out), bo_sb,
        _ptr(wh_re), _ptr(wh_im), wh_sb, _ptr(m), _ptr(o_h_re), _ptr(o_h_im),
        _ptr(o_y), _ptr(o_ys), b, nc, d, int(k), tpr, per,
        int(ensemble == "mean"), _stream(dev))
    _check(rc)
    return o_h_re, o_h_im, o_y, o_ys
