"""Launchers of the Hopper kernels in ``csrc/diag_scan.cu`` and
``csrc/decode_fused.cu``.

``diag_scan_lanes_cuda`` (the scan on split (re, im) lanes),
``diag_scan_lanes_bwd_cuda`` (its gradient, in reverse time),
``decode_fused_cuda`` (the fused decode on split lanes) and
``decode_fused_packed_cuda`` (the same kernel on the engine's packed Q
layout) take CUDA tensors, check every input (device, dtype, shape,
contiguity, the decode kernel's limits), allocate the outputs and scratch
with ``torch.empty``, and launch on PyTorch's current stream without
synchronising.  A scan cuts time into the chunks that :func:`scan_chunks`
picks from the shape and makes two launches (reduce, then scan with the
composed carry), or one when it picks one chunk; a decode makes one, laid
out by :func:`decode_layout`.  They
raise when the C entry point reports a CUDA error.  They are raw
launchers: they record nothing for autograd (``kernels.ops`` wraps
the scan and its backward in a ``torch.autograd.Function``) and route
nothing (``kernels.ops`` sends CPU tensors to the plain versions instead);
nothing here runs without a GPU.
"""
from __future__ import annotations

import ctypes
import functools
from array import array
from typing import NamedTuple, Optional

import torch

from . import build
from .ref import chunk_layout, live_mask

__all__ = ["diag_scan_lanes_cuda", "diag_scan_lanes_bwd_cuda",
           "decode_fused_cuda", "decode_fused_packed_cuda", "decode_layout",
           "decode_max_threads", "DecodeLayout", "scan_chunks",
           "SCAN_TARGET_THREADS", "SCAN_MIN_CHUNK",
           "DECODE_LANES_PER_THREAD", "DECODE_AIM_WARPS",
           "DECODE_MEAN_AIM_WARPS", "DECODE_PER",
           "DECODE_MAX_D", "DECODE_MAX_WARPS", "DECODE_MAX_SMEM_BYTES",
           "DECODE_MAX_CLUSTER"]

#: B2's layout rule (:func:`decode_layout`): the lanes a thread it aims at
#: for D = 1 and for D > 1 and the most warps a row it aims at
#: (``chip_smoke.py`` phase 4's sweep of W), the warps a row the ``mean``
#: route aims at (the fewest that fit: its exchange grows with W, and
#: phase 4's sweep of the mean route's W shows the fewest fastest at 525
#: float64 lanes), the lanes-a-thread
#: instantiations of ``csrc/decode_fused.cu`` (a layout rounds up to the
#: next), the most outputs D, warps a block and dynamic shared memory a
#: block (227 KB) it takes, and the most blocks in the ``mean`` route's
#: thread-block cluster (the H100's non-portable cluster size).
DECODE_LANES_PER_THREAD = (8, 4)
DECODE_AIM_WARPS = 8
DECODE_MEAN_AIM_WARPS = 1
DECODE_PER = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 16)
DECODE_MAX_D = 8
DECODE_MAX_WARPS = 32
DECODE_MAX_SMEM_BYTES = 232448
DECODE_MAX_CLUSTER = 16

_VP = ctypes.c_void_p
_ARGTYPES = {
    # The scan entry points take one block of int64 fields (``_launch``).
    "diag_scan": [_VP],
    "diag_scan_bwd": [_VP],
    "decode_fused": [_VP],
}
#: The library (``csrc/<stem>.cu``) of each entry point.
_LIBRARY = {"diag_scan": "diag_scan", "diag_scan_bwd": "diag_scan",
            "decode_fused": "decode_fused"}
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
        fn = getattr(build.library(_LIBRARY[name]),
                     f"{name}_{_SUFFIX[dtype]}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _ENTRIES[name, dtype] = fn
    return fn


def _check(rc: int, stem: str = "diag_scan") -> None:
    if rc != 0:
        lib = build.library(stem)
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
# B2: decode_fused (csrc/decode_fused.cu)                                      #
# --------------------------------------------------------------------------- #
class DecodeLayout(NamedTuple):
    """How one decode call runs: ``warps`` a slot row, ``per`` lanes a
    thread (the instantiation, rounded up), ``copies`` of the lane operands
    in shared memory, ``smem`` its dynamic shared memory in bytes,
    ``threads`` a block, ``rows`` a block and ``cluster``, the blocks of the
    ``mean`` route's one thread-block cluster (the ``off`` route launches
    one plain block a row: ``rows`` and ``cluster`` 1)."""
    warps: int
    per: int
    copies: int
    smem: int
    threads: int
    rows: int = 1
    cluster: int = 1


def decode_max_threads(per: int, d: int, itemsize: int) -> int:
    """The most threads a block of the ``per``-lane instantiation runs at D
    outputs — the largest at which ptxas held it without spilling on the
    card (``chip_smoke.py`` phase 2 fails on a spill).  Repeats
    ``decode_max_threads`` in ``csrc/decode_fused.cu``, which bounds each
    instantiation with it."""
    if itemsize == 8:
        if d == 1:
            return 512 if per <= 10 else 256
        return 512 if per == 1 else 256
    if d == 1:
        return 1024 if per <= 3 else 512 if per <= 12 else 256
    return 512


def _decode_fit(warps, nc, d, itemsize, rows, copies, seen=1, header=0):
    """The layout of ``warps`` warps a row and ``rows`` rows a block, or
    None if it does not fit; ``seen``: the rows whose mask and readout
    partials a block keeps (every row of the cluster for ``mean``);
    ``header``: bytes ahead of them (``mean``'s two mbarriers)."""
    need = -(-nc // (32 * warps))
    per = next((p for p in DECODE_PER if p >= need), None)
    threads = rows * 32 * warps
    if per is None or rows * warps > DECODE_MAX_WARPS or \
            threads > decode_max_threads(per, d, itemsize):
        return None
    # Shared lane operands: ``per`` slots a thread (padded ones zero).
    smem = header + itemsize * (copies * per * (2 + 4 * d) * 32 * warps
                                + rows * (d * d + d) + seen
                                + 2 * seen * warps * d)
    if smem > DECODE_MAX_SMEM_BYTES:
        return None
    return DecodeLayout(warps, per, copies, smem, threads, rows)


def _mean_fits(b, nc, d, itemsize, batched, rows, options):
    """The ``mean`` layouts of B rows at ``rows`` rows a block (default:
    one while B <= DECODE_MAX_CLUSTER, else the fewest that keep the
    cluster at DECODE_MAX_CLUSTER blocks), one per W in ``options`` that
    fits."""
    r = rows or -(-b // DECODE_MAX_CLUSTER)
    g = -(-b // r)
    if not 1 <= r <= b or g > DECODE_MAX_CLUSTER:
        return []
    return [lay._replace(cluster=g) for w in options
            if (lay := _decode_fit(w, nc, d, itemsize, r,
                                   r if batched else 1, seen=b, header=16))]


@functools.lru_cache(maxsize=1024)
def decode_layout(b: int, nc: int, d: int, itemsize: int, *,
                  ensemble: str = "off", batched: bool = False,
                  warps: Optional[int] = None,
                  rows: Optional[int] = None) -> DecodeLayout:
    """The decode kernel's layout for B rows of NC lanes and D outputs, or
    a ValueError naming the limit the shape exceeds.

    ``ensemble="off"``: one block a row, so the layout depends on NC, D and
    the dtype, never on B.  The rule aims at DECODE_LANES_PER_THREAD lanes a
    thread (8 for D = 1, 4 above): W = the smallest power of two with
    NC <= 32 W x that, at most DECODE_AIM_WARPS (past it more lanes a
    thread cost less than a wider barrier) — or, where that W does not fit
    (registers, lanes a thread, shared memory), the nearest one that does.
    ``ensemble="mean"``: the rows spread over one thread-block cluster of
    G = ceil(B / R) <= DECODE_MAX_CLUSTER blocks of R rows (R = 1 while
    B <= DECODE_MAX_CLUSTER, else the fewest that keep G there), R x W <=
    DECODE_MAX_WARPS, W the nearest fitting one to DECODE_MEAN_AIM_WARPS
    (the fewest); per-slot (``batched``) operands take one shared-memory
    copy a row of a block.  At NC = 525 (n = 1024), float64, D = 1 that
    is W = 2 and holds 128 rows.  ``warps`` forces W and ``rows`` forces R
    (``chip_smoke.py``'s sweeps; ``rows=B`` is the one-block layout).
    Cached: a serving loop asks for the same few shapes every call."""
    if ensemble not in ("off", "mean"):
        raise ValueError(f"ensemble must be 'off' or 'mean', got {ensemble!r}")
    if not 1 <= d <= DECODE_MAX_D:
        raise ValueError(f"decode_fused kernel takes 1 <= D <= "
                         f"{DECODE_MAX_D} outputs, got D={d}")
    if b < 1 or nc < 1:
        raise ValueError(f"decode_fused kernel needs B >= 1 and NC >= 1, "
                         f"got B={b}, NC={nc}")
    mean = ensemble == "mean"
    if rows is not None and not mean:
        raise ValueError("decode_fused kernel: rows= applies to "
                         "ensemble='mean' only")
    options = [w for w in (1, 2, 4, 8, 16, 32) if warps in (None, w)]
    if mean:
        aim = DECODE_MEAN_AIM_WARPS
        fits = _mean_fits(b, nc, d, itemsize, batched, rows, options)
    else:
        lanes, aim = DECODE_LANES_PER_THREAD[d > 1], 1
        while aim < DECODE_AIM_WARPS and 32 * aim * lanes < nc:
            aim *= 2
        fits = [lay for w in options
                if (lay := _decode_fit(w, nc, d, itemsize, 1, 1))]
    if fits:
        # Nearest to the aim in powers of two; the larger on a tie.
        return min(fits, key=lambda lay: (abs(lay.warps.bit_length()
                                              - aim.bit_length()),
                                          -lay.warps))
    if warps is not None or rows is not None:
        forced = ", ".join(f"{k}={v}" for k, v in (("warps", warps),
                                                   ("rows", rows))
                           if v is not None)
        raise ValueError(f"decode_fused kernel: {forced} does not fit "
                         f"B={b}, NC={nc}, D={d} ({ensemble})")
    if mean:
        most = _most(lambda m: _mean_fits(m, nc, d, itemsize, batched, None,
                                          options), DECODE_MAX_CLUSTER
                     * DECODE_MAX_WARPS)
        raise ValueError(
            f"decode_fused kernel with ensemble='mean' spreads the rows over "
            f"one cluster of at most {DECODE_MAX_CLUSTER} blocks, each of at "
            f"most {DECODE_MAX_WARPS} warps, {max(DECODE_PER)} lanes a "
            f"thread, the registers of an SM and {DECODE_MAX_SMEM_BYTES} "
            f"bytes of shared memory: B={b}, NC={nc}, D={d} "
            f"({'per-slot' if batched else 'shared'} weights, "
            f"{8 * itemsize}-bit) does not fit: B <= {most} fits")
    most = _most(lambda m: any(_decode_fit(w, m, d, itemsize, 1, 1)
                               for w in (1, 2, 4, 8, 16, 32)), nc)
    raise ValueError(
        f"decode_fused kernel holds a row's lanes in one block (at most "
        f"{max(DECODE_PER)} lanes a thread, the registers of an SM, "
        f"{DECODE_MAX_SMEM_BYTES} bytes of shared memory): NC={nc} with "
        f"D={d} ({8 * itemsize}-bit) exceeds it: NC <= {most} fits")


def _most(fits, hi: int) -> int:
    """The largest m in [0, hi] with ``fits(m)`` (0 if none; ``fits`` holds
    up to some m and not past it)."""
    lo = 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def _batch_stride(name, w, shared_shape, b, dtype, device) -> int:
    """0 for a shared ``shared_shape`` operand, the slot stride for a
    per-slot ``(b,) + shared_shape`` one; checks dtype, device, layout."""
    if w.shape == shared_shape:
        sb = 0
    elif w.shape == (b,) + shared_shape:
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


def _decode_operands(y0, ensemble, k):
    """Device and dtype of a decode call, checked."""
    if ensemble not in ("off", "mean"):
        raise ValueError(f"ensemble must be 'off' or 'mean', got {ensemble!r}")
    dev, dtype = y0.device, y0.dtype
    if dev.type != "cuda":
        raise ValueError(f"decode_fused kernel needs CUDA tensors, got {dev}")
    if dtype not in _SUFFIX:
        raise TypeError(f"decode_fused kernel takes float32/float64, "
                        f"got {dtype}")
    if y0.ndim != 2 or not y0.is_contiguous():
        raise ValueError(f"y0 must be a contiguous (B, D) tensor, got "
                         f"{tuple(y0.shape)}")
    if int(k) < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    return dev, dtype


def _mask_bytes(mask, b, dev):
    """The (B,) mask as contiguous bool bytes (a float mask is live above
    0.5), which the kernel reads as 0/1."""
    mask = torch.as_tensor(mask, device=dev)
    if mask.shape != (b,):
        raise ValueError(f"mask must be ({b},), got {tuple(mask.shape)}")
    if mask.dtype != torch.bool:
        mask = live_mask(mask, torch.float32)[0][:, 0]
    return mask.contiguous()


def _decode_launch(dtype, layout, dev, *fields):
    """Call ``decode_fused_<f32|f64>`` with ``fields`` (``DecodeCall`` up to
    ``seed_mean``), the layout and the stream packed into one int64
    block."""
    block = array("q", (*fields, layout.rows, layout.cluster, layout.copies,
                        layout.smem, _stream(dev)))
    _check(_entry("decode_fused", dtype)(block.buffer_info()[0]),
           "decode_fused")


def decode_fused_cuda(a_re, a_im, h_re, h_im, y0, wd_re, wd_im, wy, b_out,
                      wh_re, wh_im, mask, *, k: int, ensemble: str = "off",
                      warps: Optional[int] = None,
                      rows: Optional[int] = None):
    """K closed-loop decode steps through the CUDA kernel, on split lanes.

    Same operands and result as ``ref.decode_fused_ref``: ``h_*`` (B, NC),
    ``y0`` (B, D), shared 2D or per-slot 3D weights, ``mask`` (B,).
    ``warps`` / ``rows``: force W / the ``mean`` route's rows a block
    (default :func:`decode_layout`'s rule).
    Returns ``(h_re, h_im, y, ys)`` with ``ys`` (k, B, D)."""
    dev, dtype = _decode_operands(y0, ensemble, k)
    (b, d), nc = y0.shape, h_re.shape[-1]
    _pair_stride("h", h_re, h_im, (b, nc), 0, dtype, dev)
    a_sb = _pair_stride("a", a_re, a_im, (nc,), b, dtype, dev)
    wd_sb = _pair_stride("wd", wd_re, wd_im, (d, nc), b, dtype, dev)
    wy_sb = _batch_stride("wy", wy, (d, d), b, dtype, dev)
    bo_sb = _batch_stride("b_out", b_out, (d,), b, dtype, dev)
    wh_sb = _pair_stride("wh", wh_re, wh_im, (nc, d), b, dtype, dev)
    m = _mask_bytes(mask, b, dev)
    layout = decode_layout(b, nc, d, y0.element_size(), ensemble=ensemble,
                           batched=bool(a_sb or wd_sb or wh_sb), warps=warps,
                           rows=rows)
    o_h_re = torch.empty_like(h_re)
    o_h_im = torch.empty_like(h_re)
    o_y = torch.empty_like(y0)
    o_ys = y0.new_empty((int(k), b, d))
    _decode_launch(dtype, layout, dev,
                   _ptr(a_re), _ptr(a_im), a_sb, _ptr(h_re), _ptr(h_im), nc,
                   _ptr(y0), _ptr(wd_re), _ptr(wd_im), wd_sb, nc, _ptr(wy),
                   wy_sb, _ptr(b_out), bo_sb, _ptr(wh_re), _ptr(wh_im),
                   wh_sb, _ptr(m), _ptr(o_h_re), _ptr(o_h_im), _ptr(o_y),
                   _ptr(o_ys), b, nc, 0, 0, d, int(k), layout.warps,
                   layout.per, int(ensemble == "mean"), 0)
    return o_h_re, o_h_im, o_y, o_ys


def decode_fused_packed_cuda(lam_q, n_real: int, w_drive, w_out, states,
                             y_prev, mask, *, k: int, use_bias: bool,
                             use_feedback: bool, ensemble: str = "off",
                             warps: Optional[int] = None):
    """K closed-loop decode steps through the CUDA kernel, reading and
    writing the engine's packed Q layout in place: one launch, no lane
    copies.  Same operands and result as ``ref.decode_fused_packed_ref``
    (``w_out``'s bias, feedback and state rows read through row offsets;
    with ``ensemble="mean"`` the kernel seeds every live row with the live
    rows' mean output).  Returns ``(states', y_prev', ys)``."""
    dev, dtype = _decode_operands(y_prev, ensemble, k)
    (b, d), n, nr = y_prev.shape, states.shape[-1], int(n_real)
    if (n - nr) % 2 or not 0 <= nr <= n:
        raise ValueError(f"packed Q state of width {n} with {nr} real slots "
                         f"has no whole number of (re, im) pairs")
    nc = (n + nr) // 2
    f = int(use_bias) + (d if use_feedback else 0) + n
    _batch_stride("states", states, (b, n), 0, dtype, dev)
    a_sb = _batch_stride("lam_q", lam_q, (n,), b, dtype, dev)
    wd_sb = _batch_stride("w_drive", w_drive, (d, n), b, dtype, dev)
    wo_sb = _batch_stride("w_out", w_out, (f, d), b, dtype, dev)
    m = _mask_bytes(mask, b, dev)
    layout = decode_layout(b, nc, d, y_prev.element_size(),
                           ensemble=ensemble,
                           batched=bool(a_sb or wd_sb or wo_sb), warps=warps)
    wo, row = _ptr(w_out), w_out.element_size() * d
    b_out = wo if use_bias else 0
    wy = wo + int(use_bias) * row if use_feedback else 0
    wh = wo + (f - n) * row
    o_states = torch.empty_like(states)
    o_y = torch.empty_like(y_prev)
    o_ys = y_prev.new_empty((int(k), b, d))
    a, h, wd = _ptr(lam_q), _ptr(states), _ptr(w_drive)
    _decode_launch(dtype, layout, dev,
                   a, a, a_sb, h, h, n, _ptr(y_prev), wd, wd, wd_sb, n, wy,
                   wo_sb, b_out, wo_sb, wh, wh, wo_sb, _ptr(m),
                   _ptr(o_states), _ptr(o_states), _ptr(o_y), _ptr(o_ys), b,
                   nc, nr, 1, d, int(k), layout.warps, layout.per,
                   int(ensemble == "mean"), int(ensemble == "mean"))
    return o_states, o_y, o_ys
