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
feedback steps per call through ``kernels.ops.decode_fused`` — the fused
CUDA kernel on the GPU, the plain version on the CPU (the wrapper routes by
device, so there is no decode method to choose here).

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
    "run_decode_fused",
]

# Thresholds in steps along the time axis, carried over from the JAX
# package's TPU/CPU calibration; every method computes the same numerics, so
# a wrong guess costs time, never correctness.
SEQUENTIAL_MAX_T = 32     # decode & short prefill: serial scan wins
KERNEL_MIN_T = 512        # long prefill on the GPU: the CUDA scan kernel


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


def _q_lanes(v, nr: int, axis: int = -1):
    """Packed Q layout -> contiguous (re, im) lane tensors along ``axis``:
    real slots first (zero imag), then the (re, im) pairs de-interleaved.
    Width nc = nr + (N - nr) // 2."""
    reals = v.narrow(axis, 0, nr)
    pairs = v.narrow(axis, nr, v.shape[axis] - nr)
    pre = pairs.unflatten(axis % v.ndim, (-1, 2)).select(axis % v.ndim + 1, 0)
    pim = pairs.unflatten(axis % v.ndim, (-1, 2)).select(axis % v.ndim + 1, 1)
    re = torch.cat([reals, pre], axis)
    im = torch.cat([torch.zeros_like(reals), pim], axis)
    return re, im


def _q_repack(re, im, nr: int):
    """Inverse of ``_q_lanes`` on the last axis: real lanes back in front,
    pair lanes re-interleaved to the packed layout."""
    pre, pim = re[..., nr:], im[..., nr:]
    pairs = torch.stack([pre, pim], -1).reshape(
        pre.shape[:-1] + (2 * pre.shape[-1],))
    return torch.cat([re[..., :nr], pairs], -1)


def _kernel_scan_q(lam_q, x_q, n_real: int, h0, *, time_axis: int):
    """Q-basis scan through the kernel wrapper.

    Real eigen-slots ride along as zero-imaginary lanes so one launch covers
    the whole state vector: the packed (N,) coefficients, x and h0 go
    straight to (re, im) lanes of width n_real + n_pairs (``_q_lanes``) and
    the lane outputs straight back to the packed layout (``_q_repack``).
    """
    xt = torch.movedim(x_q, time_axis, -2)          # (..., T, N)
    lead = xt.shape[:-2]
    t, n = xt.shape[-2], xt.shape[-1]
    nr = n_real
    dtype = torch.result_type(lam_q, x_q)
    a_re, a_im = _q_lanes(lam_q.to(dtype), nr)
    x_re, x_im = _q_lanes(xt.reshape((-1, t, n)).to(dtype), nr)  # (B, T, nc)
    h_re = h_im = None
    if h0 is not None:
        h_re, h_im = _q_lanes(torch.broadcast_to(h0, lead + (n,))
                              .reshape((-1, n)).to(dtype), nr)
    o_re, o_im = kernel_ops.diag_scan_lanes(a_re, a_im, x_re, x_im, h_re, h_im)
    hs = _q_repack(o_re, o_im, nr).to(x_q.dtype)
    return torch.movedim(hs.reshape(lead + (t, n)), -2, time_axis)


def run_scan_q(lam_q, x_q, n_real: int, h0=None, *, method: str = "auto",
               chunk: int = 128, time_axis: int = -2):
    """Execute the Q-basis diagonal scan with an auto-selected backend.

    ``x_q``: (..., T, N) with time on ``time_axis``; ``lam_q``: (N,) packed;
    ``h0``: optional (..., N) initial state.  ``method="auto"`` resolves via
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
def run_decode_fused(lam_q, n_real: int, w_drive, w_out, states, y_prev,
                     mask, k: int, *, use_bias: bool, use_feedback: bool,
                     ensemble: str = "off"):
    """Execute K fused closed-loop decode steps over the slot block.

    ``lam_q``: (N,) packed — or (B, N) for a slot-batched param stack;
    ``w_drive``: the pre-summed drive map ``win_q (+ wfb_q)`` (D, N) /
    (B, D, N) — closed loop feeds y back as u, so the two matmuls fuse into
    one; ``w_out``: (F, D) / (B, F, D) readout with rows
    ``[bias? | y_prev? | states]``; ``states``/``y_prev``/``mask``: the
    (B, N)/(B, D)/(B,) arena tensors.  Returns ``(states', y_prev', ys)`` in
    the packed layout, ``ys`` (k, B, D).  ``kernels.ops.decode_fused`` picks
    the CUDA kernel or the plain version from the tensors' device.
    """
    nr = n_real
    d = y_prev.shape[-1]
    a_re, a_im = _q_lanes(lam_q, nr)
    h_re, h_im = _q_lanes(states, nr)
    wd_re, wd_im = _q_lanes(w_drive, nr)

    idx = 0
    if use_bias:
        b_out = w_out[..., 0, :]
        idx = 1
    else:
        b_out = w_out.new_zeros(w_out.shape[:-2] + (d,))
    if use_feedback:
        wy = w_out[..., idx:idx + d, :]
        idx += d
    else:
        wy = w_out.new_zeros(w_out.shape[:-2] + (d, d))
    wh_re, wh_im = _q_lanes(w_out[..., idx:, :], nr, axis=-2)

    mask = torch.as_tensor(mask, device=states.device)
    y0 = y_prev
    if ensemble == "mean":
        # Seed parity with arena.closed_loop: the first fed-back input of
        # every masked slot is the ensemble mean of the masked seeds.
        live, m = kernel_refs.live_mask(mask, y0.dtype)
        denom = torch.clamp(m.sum(), min=1.0)
        y_mean = (y0 * m).sum(0, keepdim=True) / denom
        y0 = torch.where(live, torch.broadcast_to(y_mean, y0.shape), y0)

    h_re, h_im, y, ys = kernel_ops.decode_fused(
        a_re, a_im, h_re, h_im, y0, wd_re, wd_im, wy.contiguous(),
        b_out.contiguous(), wh_re, wh_im, mask, k=k, ensemble=ensemble)
    return _q_repack(h_re, h_im, nr), y, ys
