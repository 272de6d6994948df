"""The kernel wrappers: one entry per kernel, routed by the tensors' device.

A CUDA tensor launches the hand-written kernel (``kernels.diag_scan``); a
CPU tensor takes the plain PyTorch version (``kernels.ref``); any other
device raises.  There is no fallback from a CUDA tensor to the plain version.
Each wrapper counts its kernel launches in its ``launches`` attribute, so a
run can show that its main path went through the kernels.
"""
from __future__ import annotations

from . import ref
from .diag_scan import decode_fused_cuda, diag_scan_cuda, diag_scan_lanes_cuda

__all__ = ["diag_scan", "diag_scan_lanes", "decode_fused"]


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


def diag_scan(a, x, h0=None):
    """h_t = a_t h_{t-1} + x_t over ``x`` (B, T, N); ``a``: (N,) / (T, N) /
    (B, T, N), real or complex; ``h0``: broadcasts to (B, N).  Returns all
    states (B, T, N) in the promoted dtype.  Forward only on CUDA."""
    if x.ndim != 3:
        raise ValueError(f"x must be (B, T, N), got {tuple(x.shape)}")
    if _route(a, x, h0) == "cpu":
        return ref.diag_scan_ref(a, x, h0)
    out = diag_scan_cuda(a, x, h0)
    if x.numel():                   # an empty scan launches nothing
        diag_scan.launches += 1
    return out


diag_scan.launches = 0


def diag_scan_lanes(a_re, a_im, x_re, x_im, h0_re=None, h0_im=None):
    """The same scan on split (re, im) lanes: ``x_*`` (B, T, N), ``a_*``
    (N,) / (T, N) / (B, T, N), ``h0_*`` broadcasting to (B, N); the ``_im``
    operands all None for a real scan.  Returns ``(h_re, h_im)``.  Launches
    the ``diag_scan`` kernel and counts in ``diag_scan.launches``."""
    if x_re.ndim != 3:
        raise ValueError(f"x must be (B, T, N), got {tuple(x_re.shape)}")
    args = (a_re, a_im, x_re, x_im, h0_re, h0_im)
    if _route(*args) == "cpu":
        return ref.diag_scan_lanes_ref(*args)
    out = diag_scan_lanes_cuda(*args)
    if x_re.numel():
        diag_scan.launches += 1
    return out


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
