"""Launchers of the Hopper kernels in ``csrc/diag_scan.cu``.

``diag_scan_lanes_cuda`` (the scan on split (re, im) lanes),
``diag_scan_lanes_bwd_cuda`` (its gradient, in reverse time) and
``decode_fused_cuda`` take CUDA tensors, check every input (device, dtype,
shape, contiguity, the one-block limits of the decode kernel), allocate the
outputs and scratch with ``torch.empty``, and launch on PyTorch's current
stream without synchronising.  A scan cuts time into the chunks that
:func:`scan_chunks` picks from the shape and makes two launches (reduce,
then scan with the composed carry), or one when it picks one chunk.  They
raise when the C entry point reports a CUDA error.  They are raw
launchers: they record nothing for autograd (``kernels.ops`` wraps
the scan and its backward in a ``torch.autograd.Function``) and route
nothing (``kernels.ops`` sends CPU tensors to the plain versions instead);
nothing here runs without a GPU.
"""
from __future__ import annotations

import ctypes
from array import array
from typing import Optional

import torch

from . import build
from .ref import chunk_layout, live_mask

__all__ = ["diag_scan_lanes_cuda", "diag_scan_lanes_bwd_cuda",
           "decode_fused_cuda", "decode_layout", "scan_chunks",
           "SCAN_TARGET_THREADS", "SCAN_MIN_CHUNK",
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
    # The scan entry points take one block of int64 fields (``_launch``).
    "diag_scan": [_VP],
    "diag_scan_bwd": [_VP],
    "decode_fused": [_VP, _VP, _LL, _VP, _VP, _VP, _VP, _VP, _LL, _VP, _LL,
                     _VP, _LL, _VP, _VP, _LL, _VP, _VP, _VP, _VP, _VP,
                     _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VP],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_ENTRIES = {}

#: The scan kernels' chunk-count rule (:func:`scan_chunks`): enough
#: (b, lane, chunk) threads to fill the card's 132 SMs, and chunks of at
#: least SCAN_MIN_CHUNK steps.
SCAN_TARGET_THREADS = 1 << 17
SCAN_MIN_CHUNK = 16


def scan_chunks(b: int, t: int, n: int) -> int:
    """The number of time chunks C the scan kernels cut a (B, T, N) scan
    into: 1 (one launch, no prefix) when B x N alone reaches
    SCAN_TARGET_THREADS or T is too short to cut, else the smallest power
    of two whose C x B x N threads reach it while T / C stays at least
    SCAN_MIN_CHUNK.  Chosen from the shape alone."""
    lanes, c = b * n, 1
    while c * lanes < SCAN_TARGET_THREADS and t >= 2 * c * SCAN_MIN_CHUNK:
        c *= 2
    return c


def _entry(name: str, dtype: torch.dtype):
    """The C entry point ``<name>_<f32|f64>``, resolved once."""
    fn = _ENTRIES.get((name, dtype))
    if fn is None:
        fn = getattr(build.library("diag_scan"), f"{name}_{_SUFFIX[dtype]}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _ENTRIES[name, dtype] = fn
    return fn


def _check(rc: int) -> None:
    if rc != 0:
        lib = build.library("diag_scan")
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel launch failed: error {rc} ({msg})")


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _launch(name: str, dtype: torch.dtype, *fields: int) -> None:
    """Call the scan entry point ``name`` with ``fields`` packed into one
    block of int64 (pointers and integers, in the order of ``ScanCall`` /
    ``ScanBwdCall`` in ``csrc/diag_scan.cu``): ctypes then converts one
    argument instead of every field.  Raises on a CUDA error."""
    block = array("q", fields)
    _check(_entry(name, dtype)(block.buffer_info()[0]))


def _stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (a tensor's
    device, so with its index).  ``torch.cuda.current_stream`` returns the
    same handle inside a Stream object that costs microseconds of host time
    to build on every call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# --------------------------------------------------------------------------- #
# B1: diag_scan                                                                #
# --------------------------------------------------------------------------- #
def _broadcast_strides(name, v, shape):
    """The strides of ``v`` broadcast to ``shape`` (0 along a broadcast
    axis), from its own shape and strides."""
    lead = len(shape) - v.ndim
    if lead >= 0 and v.shape == shape[lead:]:
        return (0,) * lead + v.stride()
    if lead < 0:
        raise ValueError(f"{name} {tuple(v.shape)} does not broadcast to "
                         f"{tuple(shape)}")
    out = [0] * lead
    for size, stride, want in zip(v.shape, v.stride(), shape[lead:]):
        if size == want:
            out.append(stride)
        elif size == 1:
            out.append(0)
        else:
            raise ValueError(f"{name} {tuple(v.shape)} does not broadcast "
                             f"to {tuple(shape)}")
    return tuple(out)


def _lane_strides(name, re, im, shape):
    """Strides of ``re`` broadcast to ``shape`` (the kernel reads ``re`` and
    ``im`` through the same ones); the lane axis must have stride 1."""
    if re is None:
        return (0,) * len(shape)
    strides = _broadcast_strides(name, re, shape)
    im_strides = strides if im is None or (
        im.shape == re.shape and im.stride() == re.stride()) else \
        _broadcast_strides(name, im, shape)
    if (shape[-1] > 1 and strides[-1] != 1) or im_strides != strides:
        raise ValueError(f"{name}_re and {name}_im must share one layout "
                         f"with unit lane stride")
    return strides


_OPERANDS = ("a_re", "a_im", "h0_re", "h0_im", "h_re", "h_im")


def _scan_operands(x_re, x_im, *others):
    """Check the operands of one scan (forward or backward) against the
    lanes ``x_re`` / ``x_im`` (B, T, N); returns ``(device, dtype, cplx)``.
    ``others``: ``a_re, a_im, h0_re, h0_im`` and, for the backward, ``h_re,
    h_im`` (each a tensor or None)."""
    if x_re.ndim != 3:
        raise ValueError(f"x must be (B, T, N), got {tuple(x_re.shape)}")
    dev, dtype = x_re.device, x_re.dtype
    if dev.type != "cuda":
        raise ValueError(f"diag_scan kernel needs CUDA tensors, got {dev}")
    if dtype not in _SUFFIX:
        raise TypeError(f"diag_scan kernel takes float32/float64 lanes, "
                        f"got {dtype}")
    cplx = x_im is not None
    _, a_im, h0_re, h0_im = others[:4]
    if (a_im is not None) != cplx or (
            h0_re is not None and (h0_im is not None) != cplx) or (
            h0_re is None and h0_im is not None):
        raise ValueError("a_im, x_im and h0_im must be given together (a "
                         "complex scan) or all be None (a real scan)")
    for name, v in zip(_OPERANDS, others):
        if v is not None and (v.dtype is not dtype or v.device != dev):
            raise ValueError(f"{name} must be a {dtype} tensor on {dev}, "
                             f"got {v.dtype} on {v.device}")
    if not x_re.is_contiguous() or (cplx and (
            x_im.shape != x_re.shape or not x_im.is_contiguous())):
        raise ValueError("x_re and x_im must be contiguous (B, T, N) tensors")
    return dev, dtype, cplx


def _chunking(b, t, n, chunks):
    """``(n_chunks, chunk_len)`` for ``chunks`` (None: :func:`scan_chunks`)."""
    return chunk_layout(t, scan_chunks(b, t, n) if chunks is None
                        else int(chunks))


def _scratch(like, n_chunks, cplx, stat):
    """The per-chunk carries e and products p (re, im) of a chunked scan of
    the (B, T, N) lanes ``like``: ``(buffer, (e_re, e_im, p_re, p_im))``,
    the pointers into one (parts, B, C, N) buffer (0 where not needed: all
    of them without chunking, p for a static ``a``, the im parts for a real
    scan)."""
    if n_chunks <= 1:
        return None, (0, 0, 0, 0)
    b, _, n = like.shape
    re_im = 2 if cplx else 1
    buf = like.new_empty((re_im * (1 if stat else 2), b, n_chunks, n))
    base, step = buf.data_ptr(), b * n_chunks * n * buf.element_size()
    ptrs = [base + i * step for i in range(buf.shape[0])]
    e, p = ptrs[:re_im], ptrs[re_im:]
    return buf, (e[0], e[1] if cplx else 0, p[0] if p else 0,
                 p[1] if p and cplx else 0)


def diag_scan_lanes_cuda(a_re, a_im, x_re, x_im, h0_re=None, h0_im=None, *,
                         chunks=None):
    """h_t = a_t h_{t-1} + x_t on split (re, im) lanes through the kernels.

    ``x_*``: contiguous (B, T, N); ``a_*``: anything that broadcasts to
    (B, T, N) lane-wise — (N,), (T, N), (B, T, N) — read through strides,
    never materialized; ``h0_*``: broadcasts to (B, N).  All float32 or all
    float64; ``a_im``, ``x_im`` and ``h0_im`` are all None for a real scan.
    ``chunks``: the time chunks C of the schedule (None: the shape's rule,
    :func:`scan_chunks`; the kernels run ``chunk_layout(T, C)``).
    Returns ``(o_re, o_im)`` (``o_im`` None for a real scan).
    """
    dev, dtype, cplx = _scan_operands(x_re, x_im, a_re, a_im, h0_re, h0_im)
    b, t, n = x_re.shape
    a_sb, a_st, _ = _lane_strides("a", a_re, a_im, (b, t, n))
    h0_sb, _ = _lane_strides("h0", h0_re, h0_im, (b, n))
    n_chunks, chunk_len = _chunking(b, t, n, chunks)
    # empty_like of the contiguous (B, T, N) lanes: the same tensor as
    # torch.empty((b, t, n), dtype=, device=) at half its host cost.
    o_re = torch.empty_like(x_re)
    o_im = torch.empty_like(x_re) if cplx else None
    _buf, scratch = _scratch(x_re, n_chunks, cplx, a_st == 0)
    _launch("diag_scan", dtype,
            _ptr(a_re), _ptr(a_im), a_sb, a_st, _ptr(x_re), _ptr(x_im),
            _ptr(h0_re), _ptr(h0_im), h0_sb, _ptr(o_re), _ptr(o_im),
            *scratch, b, t, n, n_chunks, chunk_len, int(cplx), _stream(dev))
    return o_re, o_im


def diag_scan_lanes_bwd_cuda(a_re, a_im, h_re, h_im, g_re, g_im, h0_re=None,
                             h0_im=None, *, chunks=None):
    """The gradient of :func:`diag_scan_lanes_cuda` through the reverse-time
    kernels: ``a_*`` and ``h0_*`` as given to the forward, ``h_*`` its output,
    ``g_*`` the gradient of that output (``_im`` operands None for a real
    scan); ``chunks`` as for the forward.  Returns ``(da_re, da_im, dx_re,
    dx_im, dh0_re, dh0_im)``: ``da`` summed to the shape of ``a_re``, ``dx``
    (B, T, N), ``dh0`` summed to the shape of ``h0_re`` (None without
    ``h0``) — PyTorch's convention, which on the lanes is the real gradient.
    """
    g_re = g_re.contiguous()
    g_im = None if g_im is None else g_im.contiguous()
    dev, dtype, cplx = _scan_operands(g_re, g_im, a_re, a_im, h0_re, h0_im,
                                      h_re, h_im)
    b, t, n = g_re.shape
    if h_re.shape != g_re.shape or not h_re.is_contiguous() or (cplx and (
            h_im is None or h_im.shape != g_re.shape
            or not h_im.is_contiguous())):
        raise ValueError("h_re and h_im must be the forward's contiguous "
                         "(B, T, N) output")
    a_sb, a_st, _ = _lane_strides("a", a_re, a_im, (b, t, n))
    h0_sb, _ = _lane_strides("h0", h0_re, h0_im, (b, n))
    n_chunks, chunk_len = _chunking(b, t, n, chunks)
    stat = a_st == 0
    dx_re = torch.empty_like(g_re)
    dx_im = torch.empty_like(g_re) if cplx else None
    # da per (b, chunk, lane) when a is static in time, else per (b, t, lane).
    da_shape = (b, n_chunks, n) if stat else (b, t, n)
    new = g_re.new_zeros if t == 0 else g_re.new_empty
    da_re = new(da_shape)
    da_im = new(da_shape) if cplx else None
    dh0_re = new((b, n))
    dh0_im = new((b, n)) if cplx else None
    _buf, scratch = _scratch(g_re, n_chunks, cplx, stat)
    _launch("diag_scan_bwd", dtype,
            _ptr(a_re), _ptr(a_im), a_sb, a_st, _ptr(h_re), _ptr(h_im),
            _ptr(g_re), _ptr(g_im), _ptr(h0_re), _ptr(h0_im), h0_sb,
            _ptr(dx_re), _ptr(dx_im), _ptr(da_re), _ptr(da_im), _ptr(dh0_re),
            _ptr(dh0_im), *scratch, b, t, n, n_chunks, chunk_len, int(cplx),
            _stream(dev))

    def to(v, like):
        return None if v is None or like is None else v.sum_to_size(
            like.shape)
    return (to(da_re, a_re), to(da_im, a_im), dx_re, dx_im,
            to(dh0_re, h0_re), to(dh0_im, h0_im))


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
