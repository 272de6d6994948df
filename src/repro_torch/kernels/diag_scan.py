"""Launchers of the Hopper kernels in ``csrc/diag_scan.cu``,
``csrc/decode_fused.cu`` and ``csrc/decode_stream.cu``.

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
out by :func:`decode_plan`: B2's layout (:func:`decode_layout`) wherever
it has one, else its streamed route's (:func:`decode_stream_layout`).  They
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
           "decode_max_threads", "DecodeLayout", "WideDecodeLayout",
           "scan_chunks",
           "SCAN_TARGET_THREADS", "SCAN_MIN_CHUNK",
           "DECODE_LANES_PER_THREAD", "DECODE_AIM_WARPS",
           "DECODE_MEAN_AIM_WARPS", "DECODE_PER",
           "DECODE_MAX_D", "DECODE_NARROW_D", "DECODE_WIDE_PER",
           "DECODE_MAX_WARPS",
           "DECODE_MAX_SMEM_BYTES",
           "DECODE_MAX_CLUSTER", "DECODE_GRID_CLUSTER",
           "DECODE_MAX_GRID_CLUSTERS", "decode_grid_check",
           "decode_plan", "decode_stream_layout", "DecodeStreamLayout",
           "DECODE_STREAM_THREADS", "DECODE_STREAM_ROWS",
           "DECODE_STREAM_MAX_BLOCKS", "DECODE_STREAM_MODES",
           "DECODE_STREAM_ONE_ROUND"]

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
#: DECODE_NARROW_D: the most outputs of the families that hold y in
#: registers (DM = 1 for D = 1, DM = 8 up to 8); past it the wide family
#: (DM = 0: D read at run time, y in shared memory) takes D up to
#: DECODE_MAX_D, its lanes-a-thread instantiations DECODE_WIDE_PER (its
#: rule takes the fewest lanes a thread, at most 4 wherever it has a
#: layout; at 16, float64, its grid instantiation spilled).
#: DECODE_GRID_CLUSTER: the most blocks a cluster of the ``mean`` route's
#: grid (past one cluster) takes, unless one row's segments need more:
#: of clusters of at most 1, 2, 4, 8 and 16 blocks, 2 ran the grid's steps
#: fastest or within 1.3 % of the fastest at every shape swept on an H100,
#: up to 2.2x faster than 16 (each block takes fewer partials a step;
#: PERF.md section 6).  DECODE_MAX_GRID_CLUSTERS[C - 1]: the
#: most clusters of C blocks an H100 SXM (132 SMs) holds at once at one
#: block an SM, from ``cudaOccupancyMaxActiveClusters`` on the card
#: (``chip_smoke.py`` phase 2 asks it again and fails where the card holds
#: fewer): the grid's clusters must all run at once, since they meet every
#: step.
DECODE_LANES_PER_THREAD = (8, 4)
DECODE_AIM_WARPS = 8
DECODE_MEAN_AIM_WARPS = 1
DECODE_PER = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 16)
DECODE_MAX_D = 128
DECODE_NARROW_D = 8
DECODE_WIDE_PER = (1, 2, 3, 4, 6, 8, 12)
DECODE_MAX_WARPS = 32
DECODE_MAX_SMEM_BYTES = 232448
DECODE_MAX_CLUSTER = 16
DECODE_GRID_CLUSTER = 2
DECODE_MAX_GRID_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7,
                            7, 7, 7)
DECODE_WARPS = (1, 2, 4, 8, 16, 32)
#: B2's streamed route (``csrc/decode_stream.cu``, :func:`decode_stream_layout`):
#: the threads of a block (``DECODE_STREAM_THREADS`` there), the rows of
#: shared weights that share one read of the lane operands (``kRows``),
#: the most blocks of its grid (every block must run at once, and an H100
#: SXM holds one an SM at the shared memory a layout takes:
#: ``chip_smoke.py`` phase 2 asks the card and fails where it holds
#: fewer), its modes (``kResident``, ``kStreamed``, ``kDirect`` there, in
#: order), and the most partials a block sums itself in the exchange's
#: one-round form (past it the rule takes two rounds, a reduce-scatter
#: then a gather, each block reading O(R D) a step: ``chip_smoke.py``
#: phase 4's exchange probe times both on the card; on an H100 SXM one
#: round ran faster up to 4,224 partials a block and slower from 16,896,
#: the two within 6 % of each other at 8,448, either way round).
DECODE_STREAM_THREADS = 256
DECODE_STREAM_ROWS = 8
DECODE_STREAM_MAX_BLOCKS = 132
DECODE_STREAM_MODES = ("resident", "streamed", "direct")
DECODE_STREAM_ONE_ROUND = 7000

_VP = ctypes.c_void_p
_ARGTYPES = {
    # The scan entry points take one block of int64 fields (``_launch``).
    "diag_scan": [_VP],
    "diag_scan_bwd": [_VP],
    "decode_fused": [_VP],
    "decode_stream": [_VP],
}
#: The library (``csrc/<stem>.cu``) of each entry point.
_LIBRARY = {"diag_scan": "diag_scan", "diag_scan_bwd": "diag_scan",
            "decode_fused": "decode_fused", "decode_stream": "decode_stream"}
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
    """How one decode call runs: ``warps`` a row (a row's segment where it
    is split), ``per`` lanes a thread (the instantiation, rounded up),
    ``copies`` of the lane operands in shared memory, ``smem`` its dynamic
    shared memory in bytes, ``threads`` a block, ``rows`` a block,
    ``cluster``, the blocks of one thread-block cluster (``mean``: a
    cluster's rows; ``off``: the blocks of one row, 1 for an unsplit row),
    ``segs``, the blocks a row's lanes are split over (1: the whole row in
    one block), and ``grid``, the ``mean`` route's clusters (1: the whole
    arena in one cluster), each of ``ceil(B / grid)`` rows but the last.
    ``wide`` (not a field, so a layout's fields are those it had before
    the family existed): whether it runs the wide family
    (:class:`WideDecodeLayout`)."""
    warps: int
    per: int
    copies: int
    smem: int
    threads: int
    rows: int = 1
    cluster: int = 1
    segs: int = 1
    grid: int = 1
    wide = False
    streamed = False


class WideDecodeLayout(DecodeLayout):
    """A layout of B2's wide family (y in shared memory, D read at run
    time): every D > DECODE_NARROW_D, or a D <= 8 that asks for it."""
    __slots__ = ()
    wide = True


def decode_max_threads(per: int, d: int, itemsize: int,
                       split: bool = False, grid: bool = False,
                       wide: bool = False) -> int:
    """The most threads a block of the ``per``-lane instantiation runs at D
    outputs — the largest at which ptxas held it without spilling on the
    card (``chip_smoke.py`` phase 2 fails on a spill); ``split``: the
    instantiation of a row split over blocks (at float64, D > 1, one lane
    a thread it spilled at 512); ``grid``: the ``mean`` grid's (split too;
    at float32, D = 1, 12 lanes a thread it spilled at 512); ``wide`` (or
    D > DECODE_NARROW_D): the wide family's, 256 (at 512 float32 split
    instantiations spilled).  Repeats ``decode_max_threads`` in
    ``csrc/decode_fused.cu``, which bounds each instantiation with it."""
    if wide or d > DECODE_NARROW_D:
        return 256
    if itemsize == 8:
        if d == 1:
            return 512 if per <= 10 else 256
        return 512 if per == 1 and not split else 256
    if d == 1:
        return 1024 if per <= 3 else 512 if per <= (10 if grid else 12) \
            else 256
    return 512


def _decode_fit(warps, nc, d, itemsize, rows, copies, seen=1, header=0,
                segs=1, grid=False, wide=False):
    """The layout of ``warps`` warps a row and ``rows`` rows a block, a
    row's NC lanes split over ``segs`` blocks of ceil(NC / segs) lanes, or
    None if it does not fit; ``seen``: the rows whose mask and readout
    partials a block keeps (every row of the cluster for ``mean``);
    ``header``: bytes ahead of them (the exchange's two mbarriers);
    ``grid``: a cluster of the ``mean`` route's grid, whose instantiation
    carries the split's arithmetic (and its thread bound) and whose block
    keeps the grid's y (two parity slots of D values); ``wide``: the wide
    family (implied past DECODE_NARROW_D outputs)."""
    wide = wide or d > DECODE_NARROW_D
    lanes = _seg_lanes(nc, segs)
    need = -(-lanes // (32 * warps))
    per = next((p for p in (DECODE_WIDE_PER if wide else DECODE_PER)
                if p >= need), None)
    threads = rows * 32 * warps
    if per is None or rows * warps > DECODE_MAX_WARPS or \
            threads > decode_max_threads(per, d, itemsize, segs > 1 or grid,
                                         grid, wide):
        return None
    if wide:
        # Lane operands unpadded (the segment's L lanes); each row's share
        # of wy (D x ceil(D / S)), b_out and carried y; a mask slot and the
        # warps' partials (two parity slots) of every (row, segment).
        smem = header + itemsize * (copies * (2 + 4 * d) * lanes
                                    + rows * (d * -(-d // segs) + 2 * d)
                                    + seen * segs
                                    + 2 * seen * segs * warps * d)
    else:
        # Shared lane operands: ``per`` slots a thread (padded ones zero);
        # a mask slot and the warps' partials (two parity slots) of every
        # (row, segment) of the cluster.
        smem = header + itemsize * (copies * per * (2 + 4 * d) * 32 * warps
                                    + rows * (d * d + d) + seen * segs
                                    + 2 * seen * segs * warps * d
                                    + (2 * d if grid else 0))
    if smem > DECODE_MAX_SMEM_BYTES:
        return None
    return (WideDecodeLayout if wide else DecodeLayout)(
        warps, per, copies, smem, threads, rows, 1, segs)


def _seg_lanes(nc: int, segs: int) -> int:
    """Lanes of each of a row's ``segs`` segments (the last holds the
    rest): ceil(NC / segs)."""
    return -(-nc // segs)


def _mean_fits(b, nc, d, itemsize, batched, rows, options, segs=1,
               most=DECODE_MAX_CLUSTER, grid=False, wide=False):
    """The ``mean`` layouts of B rows in one cluster of at most ``most``
    blocks, one per W in ``options`` that fits (``grid``: as a cluster of
    the grid).  A row in one block (``segs`` 1): ``rows`` rows a block
    (default: one while B <= ``most``, else the fewest that keep the
    cluster at ``most`` blocks).  A row over ``segs`` > 1 blocks: one row a
    block, B x ``segs`` <= max(``most``, ``segs``) blocks (a row's
    segments always share a cluster)."""
    if segs > 1:
        if rows not in (None, 1) or b * segs > max(most, segs):
            return []
        r, g = 1, b * segs
    else:
        r = rows or -(-b // most)
        g = -(-b // r)
        if not 1 <= r <= b or g > most:
            return []
    return [lay._replace(cluster=g) for w in options
            if (lay := _decode_fit(w, nc, d, itemsize, r,
                                   r if batched else 1, seen=b, header=16,
                                   segs=segs, grid=grid, wide=wide))]


def _off_fits(nc, d, itemsize, options, segs, wide=False):
    """The ``off`` layouts of a row's NC lanes over ``segs`` blocks (past
    one block, the row's blocks form one cluster), one per W in
    ``options`` that fits."""
    return [lay._replace(cluster=segs) for w in options
            if (lay := _decode_fit(w, nc, d, itemsize, 1, 1,
                                   header=16 if segs > 1 else 0,
                                   segs=segs, wide=wide))]


def _pick(b, nc, d, itemsize, mean, batched, options, rows, seg_options,
          most=DECODE_MAX_CLUSTER, grid=False, wide=False):
    """The rule's layout, or None if none fits: the fewest segments a row
    that fit, then W nearest the aim in powers of two (the larger on a
    tie); ``most``, ``grid`` and ``wide`` as for :func:`_mean_fits`.  The
    wide family (D > DECODE_NARROW_D, or ``wide``): the fewest lanes a
    thread, then the fewest segments, then the fewest warps — on an H100
    its step shortens with a thread's lanes, which each read 4 D shared
    values a step, more than with anything else the choice trades
    (PERF.md section 6)."""
    if wide or d > DECODE_NARROW_D:
        fits = [lay for segs in seg_options for lay in (
            _mean_fits(b, nc, d, itemsize, batched, rows, options, segs,
                       most, grid, True) if mean else
            _off_fits(nc, d, itemsize, options, segs, True))]
        return min(fits, key=lambda lay: (lay.per, lay.segs, lay.warps),
                   default=None)
    for segs in seg_options:
        if mean:
            aim = DECODE_MEAN_AIM_WARPS
            fits = _mean_fits(b, nc, d, itemsize, batched, rows, options,
                              segs, most, grid, wide)
        else:
            lanes, aim = DECODE_LANES_PER_THREAD[d > 1], 1
            while aim < DECODE_AIM_WARPS and \
                    32 * aim * lanes < _seg_lanes(nc, segs):
                aim *= 2
            fits = _off_fits(nc, d, itemsize, options, segs, wide)
        if fits:
            return min(fits, key=lambda lay: (abs(lay.warps.bit_length()
                                                  - aim.bit_length()),
                                              -lay.warps))
    return None


def _pick_grid(b, nc, d, itemsize, batched, options, rows, segs, most,
               wide=False):
    """The ``mean`` route's grid layout of B rows, or None: the fewest
    clusters G >= 2 whose share of the rows, ceil(B / G), has a layout of
    one cluster of at most ``most`` blocks (the rule of :func:`_pick`, its
    mask and partials those of the cluster's rows) and whose G clusters of
    that size the card holds at once (DECODE_MAX_GRID_CLUSTERS).  A forced
    ``segs`` applies as given; a forced W or R at the cluster's free S."""
    forced = len(options) < len(DECODE_WARPS) or rows is not None
    for g in range(2, min(b, max(DECODE_MAX_GRID_CLUSTERS)) + 1):
        bc = -(-b // g)
        if -(-b // bc) != g:        # fewer clusters hold these rows
            continue
        # A split row is a cluster of its S segments: those S of which the
        # card holds g clusters at once.
        every = [s_ for s_ in range(1, DECODE_MAX_CLUSTER + 1)
                 if s_ == 1 or g <= DECODE_MAX_GRID_CLUSTERS[s_ - 1]]
        seg_options = every if segs is None else (segs,)
        if segs is None and forced:
            free = _pick(bc, nc, d, itemsize, True, batched, DECODE_WARPS,
                         None, every, most, True, wide)
            seg_options = (free.segs,) if free else ()
        lay = _pick(bc, nc, d, itemsize, True, batched, options, rows,
                    seg_options, most, True, wide)
        if lay is not None and g <= DECODE_MAX_GRID_CLUSTERS[lay.cluster - 1]:
            return lay._replace(grid=g)
    return None


def _mean_layout(b, nc, d, itemsize, batched, options, rows, segs,
                 cluster, wide=False):
    """The ``mean`` rule: one cluster wherever it holds the B rows (the
    layout of :func:`_pick`), else the grid of :func:`_pick_grid`.  A
    forced W, R or S applies within the rule's choice of one cluster or a
    grid; ``cluster`` forces a grid."""
    every = range(1, DECODE_MAX_CLUSTER + 1)
    if cluster is None:
        free = _pick(b, nc, d, itemsize, True, batched, DECODE_WARPS, None,
                     every, wide=wide)
        if free is not None:
            if segs is not None:
                seg_options = (segs,)
            elif len(options) < len(DECODE_WARPS) or rows is not None:
                seg_options = (free.segs,)  # a forced W or R: the rule's S
            else:
                return free
            return _pick(b, nc, d, itemsize, True, batched, options, rows,
                         seg_options, wide=wide)
    return _pick_grid(b, nc, d, itemsize, batched, options, rows, segs,
                      cluster or DECODE_GRID_CLUSTER, wide)


@functools.lru_cache(maxsize=1024)
def decode_layout(b: int, nc: int, d: int, itemsize: int, *,
                  ensemble: str = "off", batched: bool = False,
                  warps: Optional[int] = None,
                  rows: Optional[int] = None,
                  segs: Optional[int] = None,
                  cluster: Optional[int] = None,
                  wide: Optional[bool] = None) -> DecodeLayout:
    """The decode kernel's layout for B rows of NC lanes and D outputs, or
    a ValueError naming the limit the shape exceeds.

    D = 1 runs the instantiations that hold y in a register, D = 2..8
    those that hold 8 values of it, and D = 9..DECODE_MAX_D the wide
    family (``wide``): y in shared memory, the lane operands unpadded
    (2 + 4D values a lane, so a row needs ceil(NC (2 + 4D) itemsize /
    budget) segments), the readout summed in tiles of 8 outputs.
    ``wide=True`` forces the wide family at D <= 8 (to time it there; the
    rule never picks it below 9).

    A row's lanes sit in one block (S = 1 segment) wherever that fits.
    Past it they split into the fewest S <= DECODE_MAX_CLUSTER segments of
    ceil(NC / S) lanes whose block fits (lanes a thread, registers, shared
    memory): segment s holds lanes [s L, (s + 1) L) on one block, and a
    row's S blocks exchange each step's readout partials through
    distributed shared memory within one thread-block cluster.
    ``ensemble="off"``: one block a segment, so the layout depends on NC,
    D and the dtype, never on B.  The rule aims at DECODE_LANES_PER_THREAD
    lanes a thread (8 for D = 1, 4 above): W = the smallest power of two
    with ceil(NC / S) <= 32 W x that, at most DECODE_AIM_WARPS (past it
    more lanes a thread cost less than a wider barrier) — or, where that W
    does not fit, the nearest one that does.  A split row is one cluster
    of S blocks, B clusters in all.
    ``ensemble="mean"``: the rows spread over one thread-block cluster of
    C <= DECODE_MAX_CLUSTER blocks: with S = 1, C = ceil(B / R) blocks of
    R rows (R = 1 while B <= DECODE_MAX_CLUSTER, else the fewest that keep
    C there), R x W <= DECODE_MAX_WARPS; with S > 1, C = B x S blocks of
    one segment each.  W is the nearest fitting one to
    DECODE_MEAN_AIM_WARPS (the fewest); per-slot (``batched``) operands
    take one shared-memory copy a row of a block.  At NC = 525 (n = 1024),
    float64, D = 1 that is W = 2 and holds 128 rows.  Past one cluster the
    rows spread over a grid of G clusters (``grid``): the fewest G whose
    share of the rows, ceil(B / G), has such a cluster of at most
    DECODE_GRID_CLUSTER blocks, its mask and partials those of its own
    rows, with G <= DECODE_MAX_GRID_CLUSTERS[C - 1] (the card holds every
    cluster at once).  Every shape one cluster holds keeps that layout
    (``grid`` 1).  ``warps`` forces W and ``rows`` forces R, at the rule's
    S unless ``segs`` forces S too, and ``cluster`` forces a grid of
    clusters of at most that many blocks (``chip_smoke.py``'s sweeps;
    ``rows=B`` is the one-block layout).  Cached: a serving loop asks for
    the same few shapes every call."""
    if ensemble not in ("off", "mean"):
        raise ValueError(f"ensemble must be 'off' or 'mean', got {ensemble!r}")
    if not 1 <= d <= DECODE_MAX_D:
        raise ValueError(f"decode_fused kernel takes 1 <= D <= "
                         f"{DECODE_MAX_D} outputs, got D={d}")
    if wide is False and d > DECODE_NARROW_D:
        raise ValueError(f"decode_fused kernel: D={d} > {DECODE_NARROW_D} "
                         f"runs the wide family only (wide=False)")
    wide = bool(wide) or d > DECODE_NARROW_D
    if b < 1 or nc < 1:
        raise ValueError(f"decode_fused kernel needs B >= 1 and NC >= 1, "
                         f"got B={b}, NC={nc}")
    mean = ensemble == "mean"
    if (rows is not None or cluster is not None) and not mean:
        raise ValueError("decode_fused kernel: rows= and cluster= apply to "
                         "ensemble='mean' only")
    if segs is not None and not 1 <= segs <= DECODE_MAX_CLUSTER:
        raise ValueError(f"decode_fused kernel: segs={segs} is not in "
                         f"1..{DECODE_MAX_CLUSTER}")
    if cluster is not None and not 1 <= cluster <= DECODE_MAX_CLUSTER:
        raise ValueError(f"decode_fused kernel: cluster={cluster} is not in "
                         f"1..{DECODE_MAX_CLUSTER}")
    every = range(1, DECODE_MAX_CLUSTER + 1)
    options = [w for w in DECODE_WARPS if warps in (None, w)]
    if mean:
        lay = _mean_layout(b, nc, d, itemsize, batched, options, rows, segs,
                           cluster, wide)
    else:
        seg_options = every if segs is None else (segs,)
        if segs is None and warps is not None:
            # A forced W applies at the rule's S.
            free = _pick(b, nc, d, itemsize, False, batched, DECODE_WARPS,
                         None, every, wide=wide)
            seg_options = (free.segs,) if free else ()
        lay = _pick(b, nc, d, itemsize, False, batched, options, None,
                    seg_options, wide=wide)
    if lay is not None:
        return lay
    if warps is not None or rows is not None or segs is not None or \
            cluster is not None:
        forced = ", ".join(f"{k}={v}" for k, v in (("warps", warps),
                                                   ("rows", rows),
                                                   ("segs", segs),
                                                   ("cluster", cluster))
                           if v is not None)
        raise ValueError(f"decode_fused kernel: {forced} does not fit "
                         f"B={b}, NC={nc}, D={d} ({ensemble})")
    limits = (f"at most {DECODE_MAX_CLUSTER} blocks, each of at most "
              f"{DECODE_MAX_WARPS} warps, "
              f"{max(DECODE_WIDE_PER if wide else DECODE_PER)} lanes a "
              f"thread, "
              f"the registers of an SM and {DECODE_MAX_SMEM_BYTES} bytes of "
              f"shared memory")
    if mean:
        most = _most(lambda m: _mean_layout(
            m, nc, d, itemsize, batched, DECODE_WARPS, None, None,
            None, wide) is not None, _MEAN_MAX_ROWS)
        raise ValueError(
            f"decode_fused kernel with ensemble='mean' spreads the rows over "
            f"one cluster of {limits} (a row's lanes over S of them, B x S "
            f"<= {DECODE_MAX_CLUSTER}), and past it over a grid of G "
            f"clusters of C <= {DECODE_GRID_CLUSTER} blocks, G <= "
            f"{DECODE_MAX_GRID_CLUSTERS[:DECODE_GRID_CLUSTER]}[C - 1] (the "
            f"clusters the card holds at once): B={b}, NC={nc}, D={d} "
            f"({'per-slot' if batched else 'shared'} weights, "
            f"{8 * itemsize}-bit) does not fit: B <= {most} fits")
    most = _most(lambda m: _pick(1, m, d, itemsize, False, False,
                                 DECODE_WARPS, None, every,
                                 wide=wide) is not None, nc)
    raise ValueError(
        f"decode_fused kernel splits a row's lanes over one cluster of "
        f"{limits}: NC={nc} with D={d} ({8 * itemsize}-bit) exceeds it: "
        f"NC <= {most} fits")


#: Past this many rows no ``mean`` layout fits (R x W <= 32 rows a block,
#: at most C x DECODE_MAX_GRID_CLUSTERS[C - 1] blocks at once).
_MEAN_MAX_ROWS = DECODE_MAX_WARPS * max(
    c * g for c, g in enumerate(DECODE_MAX_GRID_CLUSTERS, 1))


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


class DecodeStreamLayout(NamedTuple):
    """How one call of B2's streamed route runs (``csrc/decode_stream.cu``):
    a grid of ``blocks`` = ``groups`` x ``segs`` blocks, all resident at
    once; block g holds row group g // S (``rows`` rows, the last group the
    rest) and lane segment g % S (``lanes`` lanes, the last the rest);
    ``qa`` thread groups split each lane's D terms of the drive and ``qb``
    each output's lanes of the readout.  ``mode``: ``"resident"`` (the
    block's lane operands and state copied into shared memory once, before
    step 0), ``"streamed"`` (the operands through a ring of two tiles of
    ``tile`` lanes, re-read every step) or ``"direct"`` (the operands read
    from global memory where they are used: not one lane's fit a ring
    tile); streamed or direct, the state stays in shared memory where
    ``state_on_chip``, else it rides in a tile beside them;
    ``y_on_chip``: the rows' carried y, readouts and mask in shared memory
    (else in the block's slice of the global scratch); ``rounds``: the
    exchange's grid waits a step (1: every block sums its rows' partials
    itself; 2: a reduce-scatter, then a gather); ``smem``: a block's
    dynamic shared memory in bytes; ``threads`` a block."""
    blocks: int
    groups: int
    rows: int
    segs: int
    lanes: int
    qa: int
    qb: int
    mode: str
    tile: int
    state_on_chip: bool
    y_on_chip: bool
    rounds: int
    smem: int
    threads: int
    streamed = True


def _pow2_at_least(v: int) -> int:
    p = 1
    while p < v:
        p <<= 1
    return p


def _stream_smem(rows, lanes, d, itemsize, batched, mode, tile, on_chip,
                 y_on_chip, threads) -> int:
    """A streamed-route block's dynamic shared memory in bytes, region by
    region as ``smem_plan`` in ``csrc/decode_stream.cu`` lays it out (the
    entry refuses a launch whose ``smem`` differs): the reductions, the
    rows' carried y, their readouts and their mask (``y_on_chip``), the
    state (``on_chip``), then the operands: resident, one set of ``lanes``
    lanes (a row's, per-slot); streamed, the ring's two tiles of ``tile``
    lanes; direct, none; streamed or direct, with room for a row tile's
    state in each tile unless ``on_chip``."""
    nt = 1 if batched else min(rows, DECODE_STREAM_ROWS)
    values = (2 * DECODE_STREAM_ROWS * threads
              + ((2 * d + 1) * rows if y_on_chip else 0)
              + (2 * rows * lanes if on_chip else 0))
    per_lane = 2 + 4 * d
    if mode == "resident":
        values += (rows if batched else 1) * per_lane * lanes
    else:
        stage = ((per_lane if mode == "streamed" else 0)
                 + (0 if on_chip else 2 * nt)) * tile
        values += (2 if mode == "streamed" else 1) * stage
    return values * itemsize


@functools.lru_cache(maxsize=1024)
def decode_stream_layout(b: int, nc: int, d: int, itemsize: int, *,
                         ensemble: str = "off", batched: bool = False,
                         segs: Optional[int] = None,
                         mode: Optional[str] = None,
                         rounds: Optional[int] = None) -> DecodeStreamLayout:
    """The streamed route's layout for B rows of NC lanes and D outputs,
    from the shapes alone: it has one at every shape (only device memory
    bounds the route), and raises only for what no kernel takes (an
    unknown ensemble, D, B or NC < 1) or a forced mode that does not fit.

    Rows: with shared weights up to DECODE_STREAM_ROWS rows a group, which
    share one read of each lane operand a step; per-slot, one a group; in
    either case at least ceil(B / DECODE_STREAM_MAX_BLOCKS), balanced over
    the groups.  Segments: as many as the card holds blocks for,
    DECODE_STREAM_MAX_BLOCKS // groups (at most NC), so that a block's
    lane loop is short (the exchange reads O(R D) a block whatever S);
    ``segs`` forces S (any S >= 1: a grid past the card is refused at
    launch, code 10001).  S is then the fewest segments of ceil(NC / S)
    lanes.  Mode: ``"resident"`` wherever a block's share (its lanes'
    2 + 4D operand values, per row if per-slot, and its rows' state, with
    the fixed buffers) fits DECODE_MAX_SMEM_BYTES; else ``"streamed"``
    wherever the ring's two tiles of one lane fit beside the reductions'
    buffer; else ``"direct"``.  ``mode`` forces it (raising where it does
    not fit).  Within the mode: resident keeps the rows' y, readouts and
    mask in shared memory if they fit beside the share; streamed or
    direct, if that leaves tiles at least half as wide as without them,
    and then the state likewise; a tile is the most lanes that fit, at
    most the segment, balanced over it.  Rounds: one where a block's own
    sums read at most DECODE_STREAM_ONE_ROUND partials (S R D ``off``,
    G D ``mean``), else two; ``rounds`` forces it.  ``qa``: the most (a
    power of two, at most D) that leave a chunk of the drive as many lanes
    as a tile has (up to the block's threads); ``qb``: the block's threads
    over D rounded up to a power of two."""
    if ensemble not in ("off", "mean"):
        raise ValueError(f"ensemble must be 'off' or 'mean', got {ensemble!r}")
    if d < 1:
        raise ValueError(f"decode_fused kernel takes D >= 1 outputs, got "
                         f"D={d}")
    if b < 1 or nc < 1:
        raise ValueError(f"decode_fused kernel needs B >= 1 and NC >= 1, "
                         f"got B={b}, NC={nc}")
    if segs is not None and segs < 1:
        raise ValueError(f"decode_stream: segs={segs} is not >= 1")
    if mode not in (None,) + DECODE_STREAM_MODES:
        raise ValueError(f"decode_stream: mode must be one of "
                         f"{DECODE_STREAM_MODES}, got {mode!r}")
    if rounds not in (None, 1, 2):
        raise ValueError(f"decode_stream: rounds must be 1 or 2, got "
                         f"{rounds!r}")
    t, most = DECODE_STREAM_THREADS, DECODE_STREAM_MAX_BLOCKS
    rows = max(1 if batched else min(b, DECODE_STREAM_ROWS), -(-b // most))
    groups = -(-b // rows)
    rows = -(-b // groups)
    if segs is None:
        segs = max(1, min(most // groups, nc))
    lanes = -(-nc // segs)
    segs = -(-nc // lanes)
    cap = DECODE_MAX_SMEM_BYTES

    def smem(mode, tile, on_chip, y_on):
        return _stream_smem(rows, lanes, d, itemsize, batched, mode, tile,
                            on_chip, y_on, t)

    def widest(mode, on_chip, y_on):
        return _most(lambda w: smem(mode, w, on_chip, y_on) <= cap, lanes)
    fits = {"resident": smem("resident", lanes, True, False) <= cap,
            "streamed": widest("streamed", False, False) >= 1,
            "direct": widest("direct", False, False) >= 1}
    if mode is None:
        mode = next(m for m in DECODE_STREAM_MODES if fits[m])
    if not fits[mode]:
        raise ValueError(
            f"decode_stream: the {mode} mode needs "
            f"{smem(mode, 1 if mode != 'resident' else lanes, mode == 'resident', False)} "
            f"bytes of shared memory a block at B={b}, NC={nc}, D={d} "
            f"({8 * itemsize}-bit, {segs} segments of {lanes} lanes); "
            f"{cap} fit")
    if mode == "resident":
        tile, on_chip = lanes, True
        y_on = smem(mode, lanes, True, True) <= cap
    else:
        full = widest(mode, False, False)
        y_w = widest(mode, False, True)
        y_on = y_w >= 1 and 2 * y_w >= full
        tile = widest(mode, False, y_on)
        on = widest(mode, True, y_on)
        on_chip = on >= 1 and 2 * on >= tile
        if on_chip:
            tile = on
        tile = -(-lanes // -(-lanes // tile))
    if rounds is None:
        reads = (groups * segs if ensemble == "mean" else segs * rows) * d
        rounds = 1 if reads <= DECODE_STREAM_ONE_ROUND else 2
    ca = min(_pow2_at_least(tile), t)
    qa = 1
    while 2 * qa <= min(d, t // ca):
        qa *= 2
    qb = t // min(_pow2_at_least(d), t)
    return DecodeStreamLayout(groups * segs, groups, rows, segs, lanes, qa,
                              qb, mode, tile, on_chip, y_on, rounds,
                              smem(mode, tile, on_chip, y_on), t)


@functools.lru_cache(maxsize=1024)
def decode_plan(b: int, nc: int, d: int, itemsize: int, *,
                ensemble: str = "off", batched: bool = False):
    """The layout a decode call of this shape launches: :func:`decode_layout`'s
    wherever it has one (``csrc/decode_fused.cu``'s routes, unchanged),
    else :func:`decode_stream_layout`'s — exactly the shapes past
    ``decode_layout``'s limits.  Decided from the shapes alone, so every
    ``off`` and ``mean`` shape has a route on the card; raises only for
    what no kernel takes.  Cached, like both rules."""
    try:
        return decode_layout(b, nc, d, itemsize, ensemble=ensemble,
                             batched=batched)
    except ValueError:
        # decode_layout raises for a shape past its limits (the route
        # below takes it) or for an input no kernel takes (the route below
        # raises for it in turn).
        return decode_stream_layout(b, nc, d, itemsize, ensemble=ensemble,
                                    batched=batched)


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
    ``seed_mean``), the layout (its family last), the stream and (a grid)
    the rows a cluster and the grid's scratch packed into one int64 block.  The scratch — the
    arrival counter, which the entry zeroes on the stream, then two parity
    slots of each cluster's D sums, 128 bytes in — is allocated here for
    the launch."""
    b, d = fields[23], fields[27]   # DecodeCall's n_b and n_d
    scratch, crows = None, b
    if layout.grid > 1:
        crows = -(-b // layout.grid)
        itemsize = 8 if dtype == torch.float64 else 4
        scratch = torch.empty(128 + 2 * layout.grid * d * itemsize,
                              dtype=torch.uint8, device=dev)
    block = array("q", (*fields, layout.rows, layout.cluster, layout.copies,
                        layout.segs, layout.smem, _stream(dev), layout.grid,
                        crows, _ptr(scratch), int(layout.wide)))
    _check(_entry("decode_fused", dtype)(block.buffer_info()[0]),
           "decode_fused")


def _stream_launch(dtype, layout, dev, fields, mean, seed_mean):
    """Call ``decode_stream_<f32|f64>`` with ``fields`` (``DecodeCall`` up
    to ``n_k``), ``mean``, ``seed_mean``, the streamed layout, its scratch
    and the stream packed into one int64 block (``StreamCall`` in
    ``csrc/decode_stream.cu``).  The scratch — a 4-byte arrival flag a
    block, which the entry zeroes on the stream, then (at a multiple of
    128 bytes) two parity slots of every block's partials (D values a
    block for ``mean``, rows x D ``off``, rounded up to 4), the published
    y (B x D ``off``, D ``mean``) and, unless ``y_on_chip``, each block's
    rows' y, readouts and mask (2 rows x D + rows) — is allocated here for
    the launch."""
    b, d = fields[23], fields[27]   # DecodeCall's n_b and n_d
    itemsize = 8 if dtype == torch.float64 else 4
    slot = -(-(d if mean else layout.rows * d) // 4) * 4
    flags = -(-4 * layout.blocks // 128) * 128
    rows = 0 if layout.y_on_chip else layout.blocks * (2 * d + 1) * layout.rows
    scratch = torch.empty(flags + itemsize * (
        2 * layout.blocks * slot + (d if mean else b * d) + rows),
        dtype=torch.uint8, device=dev)
    block = array("q", (*fields, mean, seed_mean, layout.blocks,
                        layout.groups, layout.rows, layout.segs, layout.lanes,
                        layout.qa, layout.qb,
                        DECODE_STREAM_MODES.index(layout.mode), layout.tile,
                        int(layout.state_on_chip), int(layout.y_on_chip),
                        layout.rounds, layout.smem, _ptr(scratch),
                        _stream(dev)))
    _check(_entry("decode_stream", dtype)(block.buffer_info()[0]),
           "decode_stream")


def _launch_decode(dtype, layout, dev, fields, mean, seed_mean):
    """One decode launch of ``layout``: B2's streamed route for a
    :class:`DecodeStreamLayout`, else ``csrc/decode_fused.cu``."""
    if layout.streamed:
        _stream_launch(dtype, layout, dev, fields, mean, seed_mean)
    else:
        _decode_launch(dtype, layout, dev, *fields, layout.warps, layout.per,
                       mean, seed_mean)


def _decode_layout_of(b, nc, d, itemsize, ensemble, batched, stream,
                      **forced):
    """The layout a launcher runs: ``stream`` (True: the streamed route's
    rule; a :class:`DecodeStreamLayout`: that layout) forces the streamed
    route; a forced W, R, S, cluster or family forces
    :func:`decode_layout`'s routes (raising where they do not fit);
    otherwise :func:`decode_plan`."""
    if any(v is not None for v in forced.values()):
        if stream:
            raise ValueError("decode_fused kernel: stream= takes no warps=, "
                             "rows=, segs=, cluster= or wide=")
        return decode_layout(b, nc, d, itemsize, ensemble=ensemble,
                             batched=batched, **forced)
    if isinstance(stream, DecodeStreamLayout):
        return stream
    if stream:
        return decode_stream_layout(b, nc, d, itemsize, ensemble=ensemble,
                                    batched=batched)
    return decode_plan(b, nc, d, itemsize, ensemble=ensemble,
                       batched=batched)


def decode_grid_check() -> None:
    """Raise if a ``mean`` grid launch, or a launch of the streamed route,
    since the last check waited past its bound for its clusters or blocks
    (they did not all run at once; its outputs are not valid).  Call after
    synchronising; the next such launch raises too."""
    for stem, ask in (("decode_fused", "decode_grid_timed_out"),
                      ("decode_stream", "decode_stream_timed_out")):
        fn = getattr(build.library(stem), ask)
        fn.restype = ctypes.c_int
        if fn():
            _check(10002, stem)


def decode_fused_cuda(a_re, a_im, h_re, h_im, y0, wd_re, wd_im, wy, b_out,
                      wh_re, wh_im, mask, *, k: int, ensemble: str = "off",
                      warps: Optional[int] = None,
                      rows: Optional[int] = None,
                      segs: Optional[int] = None,
                      cluster: Optional[int] = None,
                      wide: Optional[bool] = None, stream=None,
                      with_layout: bool = False):
    """K closed-loop decode steps through the CUDA kernel, on split lanes.

    Same operands and result as ``ref.decode_fused_ref``: ``h_*`` (B, NC),
    ``y0`` (B, D), shared 2D or per-slot 3D weights, ``mask`` (B,).  The
    layout is :func:`decode_plan`'s: ``csrc/decode_fused.cu`` wherever
    :func:`decode_layout` has a layout, else the streamed route.
    ``warps`` / ``rows`` / ``segs`` / ``cluster`` / ``wide``: force W / the
    ``mean`` route's rows a block / the blocks a row is split over / a
    ``mean`` grid of clusters of at most that many blocks / the wide
    family at D <= 8 (:func:`decode_layout`, which raises where they do
    not fit); ``stream``: force the streamed route (True: its rule's
    layout, or a :class:`DecodeStreamLayout`).
    Returns ``(h_re, h_im, y, ys)`` with ``ys`` (k, B, D), and with
    ``with_layout`` the layout launched after them."""
    dev, dtype = _decode_operands(y0, ensemble, k)
    (b, d), nc = y0.shape, h_re.shape[-1]
    _pair_stride("h", h_re, h_im, (b, nc), 0, dtype, dev)
    a_sb = _pair_stride("a", a_re, a_im, (nc,), b, dtype, dev)
    wd_sb = _pair_stride("wd", wd_re, wd_im, (d, nc), b, dtype, dev)
    wy_sb = _batch_stride("wy", wy, (d, d), b, dtype, dev)
    bo_sb = _batch_stride("b_out", b_out, (d,), b, dtype, dev)
    wh_sb = _pair_stride("wh", wh_re, wh_im, (nc, d), b, dtype, dev)
    m = _mask_bytes(mask, b, dev)
    layout = _decode_layout_of(b, nc, d, y0.element_size(), ensemble,
                               bool(a_sb or wd_sb or wh_sb), stream,
                               warps=warps, rows=rows, segs=segs,
                               cluster=cluster, wide=wide)
    o_h_re = torch.empty_like(h_re)
    o_h_im = torch.empty_like(h_re)
    o_y = torch.empty_like(y0)
    o_ys = y0.new_empty((int(k), b, d))
    _launch_decode(dtype, layout, dev, (
        _ptr(a_re), _ptr(a_im), a_sb, _ptr(h_re), _ptr(h_im), nc, _ptr(y0),
        _ptr(wd_re), _ptr(wd_im), wd_sb, nc, _ptr(wy), wy_sb, _ptr(b_out),
        bo_sb, _ptr(wh_re), _ptr(wh_im), wh_sb, _ptr(m), _ptr(o_h_re),
        _ptr(o_h_im), _ptr(o_y), _ptr(o_ys), b, nc, 0, 0, d, int(k)),
        int(ensemble == "mean"), 0)
    out = (o_h_re, o_h_im, o_y, o_ys)
    return (*out, layout) if with_layout else out


def decode_fused_packed_cuda(lam_q, n_real: int, w_drive, w_out, states,
                             y_prev, mask, *, k: int, use_bias: bool,
                             use_feedback: bool, ensemble: str = "off",
                             warps: Optional[int] = None, stream=None,
                             with_layout: bool = False):
    """K closed-loop decode steps through the CUDA kernel, reading and
    writing the engine's packed Q layout in place: one launch, no lane
    copies.  Same operands and result as ``ref.decode_fused_packed_ref``
    (``w_out``'s bias, feedback and state rows read through row offsets;
    with ``ensemble="mean"`` the kernel seeds every live row with the live
    rows' mean output).  Layout, ``warps``, ``stream`` and ``with_layout``
    as for :func:`decode_fused_cuda`.  Returns ``(states', y_prev', ys)``
    (and the layout)."""
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
    layout = _decode_layout_of(b, nc, d, y_prev.element_size(), ensemble,
                               bool(a_sb or wd_sb or wo_sb), stream,
                               warps=warps)
    wo, row = _ptr(w_out), w_out.element_size() * d
    b_out = wo if use_bias else 0
    wy = wo + int(use_bias) * row if use_feedback else 0
    wh = wo + (f - n) * row
    o_states = torch.empty_like(states)
    o_y = torch.empty_like(y_prev)
    o_ys = y_prev.new_empty((int(k), b, d))
    a, h, wd = _ptr(lam_q), _ptr(states), _ptr(w_drive)
    mean = int(ensemble == "mean")
    _launch_decode(dtype, layout, dev, (
        a, a, a_sb, h, h, n, _ptr(y_prev), wd, wd, wd_sb, n, wy, wo_sb,
        b_out, wo_sb, wh, wh, wo_sb, _ptr(m), _ptr(o_states),
        _ptr(o_states), _ptr(o_y), _ptr(o_ys), b, nc, nr, 1, d, int(k)),
        mean, mean)
    out = (o_states, o_y, o_ys)
    return (*out, layout) if with_layout else out
