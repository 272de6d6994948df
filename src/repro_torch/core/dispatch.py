"""Backend auto-dispatch for the diagonal reservoir scan and fused decode.

One place decides *how* the O(N) recurrence h_t = Lambda (.) h_{t-1} + x_t
runs, from the shape of the work and the device it lives on:

* **decode / short prefill** (small T)   -> ``sequential``: the lowest
  per-step constant and no fix-up passes.
* **long prefill on the GPU**            -> ``kernel``: the hand-written CUDA
  scan (``kernels.ops.diag_scan_lanes``) — each lane's carry stays in
  registers.
* **long prefill elsewhere**             -> ``chunked``: the work-efficient
  two-pass scan.
* **mid-size T**                         -> ``associative``: O(log T) depth
  without the chunk bookkeeping.

Closed-loop decode has its own funnel: ``run_decode_fused`` executes K
feedback steps per call through ``kernels.ops.decode_fused_packed`` — the
fused CUDA kernel on the GPU, reading the packed layout in place, the plain
version on the CPU.  ``resolve_decode_method`` names the two: ``"kernel"``
on CUDA, ``"ref"`` elsewhere; ``"ref"`` on the card only when the caller
asks for it.

All entry points take Q-basis (Appendix-A realified) operands.
"""
from __future__ import annotations

import torch

from . import scan as scan_mod
from ..kernels import ops as kernel_ops
from ..kernels import ref as kernel_refs

__all__ = [
    "SEQUENTIAL_MAX_T",
    "KERNEL_MIN_T",
    "resolve_method",
    "run_scan_q",
    "resolve_decode_method",
    "run_decode_fused",
]

# Thresholds in steps along the time axis; every method computes the same
# numerics, so a wrong guess costs time, never correctness.
# SEQUENTIAL_MAX_T is carried over from the JAX package's TPU/CPU
# calibration.  KERNEL_MIN_T is the smallest serving bucket at which the
# CUDA scan beats the chunked torch scan on the card: chip_smoke.py's
# crossover (8 rows, n = 1024, float64) on an NVIDIA H100 80GB HBM3 at
# 700 W measured 0.24-0.66 ms against 6.6-13.8 ms at T_bucket 32 over
# three runs, and the kernel ahead at every bucket up to 1024.
SEQUENTIAL_MAX_T = 32     # decode & short prefill: serial scan wins
KERNEL_MIN_T = 32         # prefill on the GPU: the CUDA scan kernels


def _device_type(device) -> str:
    return "cuda" if device is None else torch.device(device).type


def resolve_method(t: int, *, device=None, chunk: int = 128) -> str:
    """Pick a scan backend from the time extent of the work.

    ``t``: steps along time; ``device``: where the work runs (``None``
    means the GPU, as for every entry point of the port); ``chunk``: the
    chunked schedule's chunk — below two chunks its fix-up passes don't pay
    for themselves.  Returns "sequential" | "associative" | "chunked" |
    "kernel".
    """
    if t <= SEQUENTIAL_MAX_T:
        return "sequential"
    if t >= KERNEL_MIN_T and _device_type(device) == "cuda":
        return "kernel"
    if t >= 2 * chunk:
        return "chunked"
    return "associative"


def _kernel_scan_q(lam_q, x_q, n_real: int, h0, *, time_axis: int):
    """Q-basis scan through the kernel wrapper.

    Real eigen-slots ride along as zero-imaginary lanes so one launch covers
    the whole state vector: the packed (N,) coefficients, x and h0 go
    straight to (re, im) lanes of width n_real + n_pairs
    (``kernels.ref.q_lanes``) and the lane outputs straight back to the
    packed layout (``q_repack``).  Per-row coefficients (``lam_q`` shaped
    like ``x_q`` without its time axis: a param-batched wave) go to the
    kernel as (B, 1, nc) lanes, which it reads with a time stride of 0 —
    one launch for the wave, nothing broadcast over time in memory.
    """
    xt = torch.movedim(x_q, time_axis, -2)          # (..., T, N)
    lead = xt.shape[:-2]
    t, n = xt.shape[-2], xt.shape[-1]
    nr = n_real
    dtype = torch.result_type(lam_q, x_q)
    q_lanes = kernel_refs.q_lanes
    a_re, a_im = q_lanes(lam_q.to(dtype), nr)
    if lam_q.ndim > 1:
        rows = (-1, 1, a_re.shape[-1])
        a_re = torch.broadcast_to(a_re, lead + a_re.shape[-1:]).reshape(rows)
        a_im = torch.broadcast_to(a_im, lead + a_im.shape[-1:]).reshape(rows)
    x_re, x_im = q_lanes(xt.reshape((-1, t, n)).to(dtype), nr)  # (B, T, nc)
    h_re = h_im = None
    if h0 is not None:
        h_re, h_im = q_lanes(torch.broadcast_to(h0, lead + (n,))
                             .reshape((-1, n)).to(dtype), nr)
    o_re, o_im = kernel_ops.diag_scan_lanes(a_re, a_im, x_re, x_im, h_re, h_im)
    hs = kernel_refs.q_repack(o_re, o_im, nr).to(x_q.dtype)
    return torch.movedim(hs.reshape(lead + (t, n)), -2, time_axis)


def run_scan_q(lam_q, x_q, n_real: int, h0=None, *, method: str = "auto",
               chunk: int = 128, time_axis: int = -2):
    """Execute the Q-basis diagonal scan with an auto-selected backend.

    ``x_q``: (..., T, N) with time on ``time_axis``; ``lam_q``: (N,)
    packed, or (..., N) — one row of coefficients per batch row of ``x_q``
    (a param-batched wave); ``h0``: optional (..., N) initial state.  ``method="auto"`` resolves via
    :func:`resolve_method` on ``x_q``'s device; explicit method strings pass
    straight through.
    """
    if method == "auto":
        t = x_q.shape[time_axis % x_q.ndim]
        method = resolve_method(t, device=x_q.device, chunk=chunk)
    if method == "kernel":
        return _kernel_scan_q(lam_q, x_q, n_real, h0, time_axis=time_axis)
    return scan_mod.diag_scan_q(lam_q, x_q, n_real, h0, method=method,
                                chunk=chunk, time_axis=time_axis)


# --------------------------------------------------------------------------- #
# Fused multi-token closed-loop decode                                         #
# --------------------------------------------------------------------------- #
def resolve_decode_method(device=None) -> str:
    """Backend for the fused K-token decode: ``"kernel"`` (the CUDA kernel,
    ``kernels.ops.decode_fused_packed``) where the work lives on CUDA —
    ``device=None`` means the GPU, as for every entry point of the port —
    and ``"ref"`` (the plain version) elsewhere.  Decode is step-serial at
    any K, so there is no threshold: the device alone decides."""
    return "kernel" if _device_type(device) == "cuda" else "ref"


def run_decode_fused(lam_q, n_real: int, w_drive, w_out, states, y_prev,
                     mask, k: int, *, use_bias: bool, use_feedback: bool,
                     ensemble: str = "off", method: str = "auto"):
    """Execute K fused closed-loop decode steps over the slot block.

    ``lam_q``: (N,) packed — or (B, N) for a slot-batched param stack;
    ``w_drive``: the pre-summed drive map ``win_q (+ wfb_q)`` (D, N) /
    (B, D, N) — closed loop feeds y back as u, so the two matmuls fuse into
    one; ``w_out``: (F, D) / (B, F, D) readout with rows
    ``[bias? | y_prev? | states]``; ``states``/``y_prev``/``mask``: the
    (B, N)/(B, D)/(B,) arena tensors.  Returns ``(states', y_prev', ys)`` in
    the packed layout, ``ys`` (k, B, D).  ``method``: ``"auto"``
    (:func:`resolve_decode_method` of the states' device), ``"kernel"``
    (``kernels.ops.decode_fused_packed``: one launch of the CUDA kernel,
    reading and writing the packed layout in place — the plain version for
    CPU tensors) or ``"ref"`` (``kernels.ref.decode_fused_packed_ref`` on
    any device).
    """
    if method == "auto":
        method = resolve_decode_method(states.device)
    if method not in ("kernel", "ref"):
        raise ValueError(f"unknown decode method {method!r}: 'auto', "
                         f"'kernel' or 'ref'")
    fn = (kernel_ops.decode_fused_packed if method == "kernel"
          else kernel_refs.decode_fused_packed_ref)
    return fn(lam_q, n_real, w_drive, w_out, states, y_prev, mask, k=k,
              use_bias=use_bias, use_feedback=use_feedback,
              ensemble=ensemble)
