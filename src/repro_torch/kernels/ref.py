"""Plain PyTorch versions of the CUDA kernels: what a CPU tensor runs, and
what the kernels are held against on the card."""
from __future__ import annotations

import torch

__all__ = ["diag_scan_ref", "diag_scan_lanes_ref", "decode_fused_ref"]


def diag_scan_ref(a, x, h0=None):
    """h_t = a_t * h_{t-1} + x_t, one step at a time.  a: (N,) or like x;
    x: (..., T, N) with time on axis -2.  Real or complex."""
    xt = torch.movedim(x, -2, 0)
    dtype = torch.result_type(a, x)
    if a.ndim == 1:
        at = torch.broadcast_to(a, xt.shape)
    else:
        at = torch.movedim(torch.broadcast_to(a, x.shape), -2, 0)
    at, xt = at.to(dtype), xt.to(dtype)
    h = (torch.zeros(xt.shape[1:], dtype=dtype, device=x.device) if h0 is None
         else torch.broadcast_to(h0, xt.shape[1:]).to(dtype))
    hs = []
    for i in range(xt.shape[0]):
        h = at[i] * h + xt[i]
        hs.append(h)
    if not hs:
        return x.to(dtype)
    return torch.movedim(torch.stack(hs), 0, -2)


def diag_scan_lanes_ref(a_re, a_im, x_re, x_im, h0_re=None, h0_im=None):
    """:func:`diag_scan_ref` on split (re, im) lanes (``_im`` operands all
    None for a real scan).  Returns ``(h_re, h_im)``."""
    if x_im is None:
        return diag_scan_ref(a_re, x_re, h0_re), None
    h0 = None if h0_re is None else torch.complex(h0_re, h0_im)
    hs = diag_scan_ref(torch.complex(a_re, a_im), torch.complex(x_re, x_im),
                       h0)
    return hs.real, hs.imag


def _mm(v, w):
    """Row-batch times (possibly slot-batched) weight: (B, F) @ (F, G) for
    shared weights, per-row contraction for a (B, F, G) stacked batch."""
    if w.ndim == 2:
        return v @ w
    return torch.einsum("bf,bfg->bg", v, w)


def live_mask(mask, dtype):
    """``(live (B, 1) bool, m (B, 1) float)`` from a bool or float mask —
    a float mask is live above 0.5."""
    live = mask if mask.dtype == torch.bool else mask > 0.5
    live = live[:, None]
    return live, live.to(dtype)


def decode_fused_ref(a_re, a_im, h_re, h_im, y0, wd_re, wd_im, wy, b_out,
                     wh_re, wh_im, mask, *, k: int, ensemble: str = "off"):
    """K fused closed-loop decode steps, one step at a time.

    Realified lanes: ``a_*`` (NC,) or (B, NC); ``h_*`` (B, NC); ``y0``
    (B, D); weights shared 2D or slot-batched 3D (``wd_*`` (D, NC), ``wy``
    (D, D), ``wh_*`` (NC, D), ``b_out`` (D,) — or each with a leading B);
    ``mask`` (B,) bool/float.  Returns ``(h_re, h_im, y, ys)`` with ``ys``
    (k, B, D).
    """
    live, m = live_mask(torch.as_tensor(mask, device=y0.device), y0.dtype)
    denom = torch.clamp(m.sum(), min=1.0)
    hr, hi, y = h_re, h_im, y0
    ys = []
    for _ in range(k):
        nhr = a_re * hr - a_im * hi + _mm(y, wd_re)
        nhi = a_re * hi + a_im * hr + _mm(y, wd_im)
        hr = torch.where(live, nhr, hr)
        hi = torch.where(live, nhi, hi)
        y_new = b_out + _mm(y, wy) + _mm(hr, wh_re) + _mm(hi, wh_im)
        if ensemble == "mean":
            y_new = torch.broadcast_to(
                (y_new * m).sum(0, keepdim=True) / denom, y_new.shape)
        y = torch.where(live, y_new, y)
        ys.append(y)
    ys = (torch.stack(ys) if ys else
          y0.new_zeros((0,) + tuple(y0.shape)))
    return hr, hi, y, ys
