"""Diagonal linear recurrence — the paper's O(N) reservoir step, three ways.

The recurrence (Corollary 2):      h_t = a_t (.) h_{t-1} + x_t
with diagonal coefficients ``a``.  Because the update is element-wise it is
associative over time (Appendix B), which yields three execution strategies:

* ``sequential``  — a Python loop over time, O(T) depth, minimal FLOPs.
* ``associative`` — a log-depth doubling scan on (a, b) pairs with the
                    composition (a1,b1)*(a2,b2) = (a2 a1, a2 b1 + b2).
* ``chunked``     — work-efficient two-pass: per-chunk local scan + cumulative
                    coefficient products, then a sequential carry scan over
                    chunk summaries, then a broadcast fix-up.

All functions accept real or complex ``a``/``x``.  The Appendix-A realified
form (complex conjugate pairs stored as (re, im) lanes) is provided via
``pack_lambda_q`` / ``realified_multiply`` / ``diag_scan_q``.

Shapes: ``x`` is ``(..., T, N)`` (time on axis -2). ``a`` is ``(N,)`` (static
coefficients) or broadcast-compatible with ``x``.
"""
from __future__ import annotations

import torch

__all__ = [
    "diag_scan",
    "diag_scan_sequential",
    "diag_scan_associative",
    "diag_scan_chunked",
    "pack_lambda_q",
    "realified_multiply",
    "diag_scan_q",
    "q_split",
    "q_merge",
]


def _front(x, time_axis: int):
    return torch.movedim(x, time_axis, 0)


def _back(x, time_axis: int):
    return torch.movedim(x, 0, time_axis)


def _time_coeffs(a, x, time_axis: int):
    """Per-step coefficients with time in front, broadcast to ``x``."""
    return _front(torch.broadcast_to(a, x.shape), time_axis)


# --------------------------------------------------------------------------- #
# Sequential                                                                   #
# --------------------------------------------------------------------------- #
def diag_scan_sequential(a, x, h0=None, *, time_axis: int = -2,
                         reverse: bool = False):
    """h_t = a_t * h_{t-1} + x_t, one step at a time.  Returns all states."""
    xt = _front(x, time_axis)                       # (T, ..., N)
    static_a = a.ndim == 1
    at = None if static_a else _time_coeffs(a, x, time_axis)
    carry_shape = torch.broadcast_shapes(
        xt.shape[1:], a.shape if static_a else at.shape[1:])
    dtype = torch.result_type(a, x)
    h = (torch.zeros(carry_shape, dtype=dtype, device=x.device) if h0 is None
         else torch.broadcast_to(h0, carry_shape).to(dtype))
    t = xt.shape[0]
    hs = [None] * t
    for i in (range(t - 1, -1, -1) if reverse else range(t)):
        h = (a if static_a else at[i]) * h + xt[i]
        hs[i] = h
    if t == 0:
        return x.to(dtype)
    return _back(torch.stack(hs), time_axis)


# --------------------------------------------------------------------------- #
# Associative scan (Appendix B)                                                #
# --------------------------------------------------------------------------- #
def _scan_pairs(at, bt):
    """Inclusive scan of (a, b) pairs along dim 0 under ``_compose``:
    Hillis-Steele doubling, ceil(log2 T) rounds of whole-array updates."""
    step = 1
    while step < at.shape[0]:
        a_prev, b_prev = at[:-step], bt[:-step]
        a_cur, b_cur = at[step:], bt[step:]
        at = torch.cat([at[:step], a_cur * a_prev])
        bt = torch.cat([bt[:step], a_cur * b_prev + b_cur])
        step *= 2
    return at, bt


def diag_scan_associative(a, x, h0=None, *, time_axis: int = -2,
                          reverse: bool = False):
    """Time-parallel scan: O(log T) depth."""
    xt = _front(x, time_axis)
    dtype = torch.result_type(a, x)
    xt = xt.to(dtype)
    if a.ndim == 1:
        at = torch.broadcast_to(a, xt.shape).to(dtype)
    else:
        at = _time_coeffs(a, x, time_axis).to(dtype)
    if h0 is not None:
        # Fold the initial state into the first element: h_1 = a_1 h_0 + x_1.
        xt = torch.cat([(xt[0] + at[0] * h0).to(dtype)[None], xt[1:]])
    if reverse:
        _, hs = _scan_pairs(torch.flip(at, [0]), torch.flip(xt, [0]))
        hs = torch.flip(hs, [0])
    else:
        _, hs = _scan_pairs(at, xt)
    return _back(hs, time_axis)


# --------------------------------------------------------------------------- #
# Chunked two-pass scan                                                        #
# --------------------------------------------------------------------------- #
def diag_scan_chunked(a, x, h0=None, *, chunk: int = 128, time_axis: int = -2,
                      reverse: bool = False):
    """Work-efficient chunked scan.

    Pass 1: within each chunk, local scan from zero + cumulative products A.
    Pass 2: sequential scan over the ``T/chunk`` chunk carries (cheap).
    Pass 3: h[c, t] = local[c, t] + A[c, t] * carry_in[c].
    """
    if reverse:
        a_f = a if a.ndim == 1 else torch.flip(a, [time_axis])
        out = diag_scan_chunked(a_f, torch.flip(x, [time_axis]), h0,
                                chunk=chunk, time_axis=time_axis)
        return torch.flip(out, [time_axis])

    xt = _front(x, time_axis)                       # (T, B..., N)
    t = xt.shape[0]
    dtype = torch.result_type(a, x)
    pad = (-t) % chunk
    if pad:
        xt = torch.cat([xt, xt.new_zeros((pad,) + xt.shape[1:])])
    if a.ndim != 1:
        at_full = _time_coeffs(a, x, time_axis)
        if pad:
            # Pad coefficients with ones so padded steps are harmless.
            at_full = torch.cat(
                [at_full, at_full.new_ones((pad,) + at_full.shape[1:])])
    t_pad = t + pad
    nc = t_pad // chunk
    xc = xt.reshape((nc, chunk) + xt.shape[1:]).to(dtype)   # (nc, tc, B..., N)

    if a.ndim == 1:
        # Static coefficients: powers a^(k+1) for k in [0, chunk).
        real_dtype = a.real.dtype if a.is_complex() else a.dtype
        ks = torch.arange(1, chunk + 1, dtype=real_dtype, device=a.device)
        powers = (a[None, :] ** ks[:, None]).to(dtype)       # (tc, N)
        h = torch.zeros((nc,) + xc.shape[2:], dtype=dtype, device=x.device)
        locals_ = []
        for k in range(chunk):
            h = a * h + xc[:, k]
            locals_.append(h)
        locals_ = torch.stack(locals_, 1)                    # (nc, tc, B..., N)
        a_cum = torch.broadcast_to(
            powers.reshape((1, chunk) + (1,) * (xc.ndim - 3)
                           + (xc.shape[-1],)), xc.shape)
    else:
        ac = at_full.reshape((nc, chunk) + at_full.shape[1:]).to(dtype)
        h = torch.zeros(torch.broadcast_shapes(
            (nc,) + ac.shape[2:], (nc,) + xc.shape[2:]),
            dtype=dtype, device=x.device)
        locals_ = []
        for k in range(chunk):
            h = ac[:, k] * h + xc[:, k]
            locals_.append(h)
        locals_ = torch.stack(locals_, 1)
        a_cum = torch.broadcast_to(torch.cumprod(ac, dim=1), locals_.shape)

    # Pass 2: carries across chunks.
    last_local = locals_[:, -1]
    last_prod = a_cum[:, -1]
    c = (torch.zeros(last_local.shape[1:], dtype=dtype, device=x.device)
         if h0 is None else
         torch.broadcast_to(h0, last_local.shape[1:]).to(dtype))
    carry_in = []
    for i in range(nc):
        carry_in.append(c)      # state entering chunk i
        c = last_local[i] + last_prod[i] * c
    carry_in = torch.stack(carry_in)

    hs = locals_ + a_cum * carry_in[:, None]
    hs = hs.reshape((t_pad,) + xt.shape[1:])[:t]
    return _back(hs, time_axis)


def diag_scan(a, x, h0=None, *, method: str = "sequential", chunk: int = 128,
              time_axis: int = -2, reverse: bool = False):
    """Dispatch across the three strategies (same numerics, different schedules)."""
    if method == "sequential":
        return diag_scan_sequential(a, x, h0, time_axis=time_axis,
                                    reverse=reverse)
    if method == "associative":
        return diag_scan_associative(a, x, h0, time_axis=time_axis,
                                     reverse=reverse)
    if method == "chunked":
        return diag_scan_chunked(a, x, h0, chunk=chunk, time_axis=time_axis,
                                 reverse=reverse)
    raise ValueError(f"unknown scan method {method!r}")


# --------------------------------------------------------------------------- #
# Appendix-A realified (Q-basis) arithmetic                                    #
# --------------------------------------------------------------------------- #
def pack_lambda_q(lam_real, lam_cpx):
    """Pack (L_real (nr,), L_cpx (ni,)) into the Q-layout coefficient vector.

    Layout: [L_real | Re mu_1, Im mu_1, ..., Re mu_ni, Im mu_ni]   (N,) real.
    """
    lam_real = torch.as_tensor(lam_real)
    lam_cpx = torch.as_tensor(lam_cpx)
    pairs = torch.stack([lam_cpx.real, lam_cpx.imag], -1).reshape(-1)
    return torch.cat([lam_real, pairs.to(lam_real.dtype)])


def realified_multiply(h, lam_q, n_real: int):
    """One Q-basis recurrence multiply: real slots scale, pair slots rotate.

    ``h``: (..., N) real; ``lam_q``: (N,) packed (see pack_lambda_q), or
    (..., N) per row (a param batch), broadcasting against ``h``.
    Equivalent to the complex element-wise multiply in the P basis.
    """
    hr = h[..., :n_real] * lam_q[..., :n_real]
    pairs = h[..., n_real:].reshape(h.shape[:-1] + (-1, 2))
    lp = lam_q[..., n_real:].reshape(lam_q.shape[:-1] + (-1, 2))
    ar, ai = lp[..., 0], lp[..., 1]
    pr, pi = pairs[..., 0], pairs[..., 1]
    out_r = pr * ar - pi * ai
    out_i = pr * ai + pi * ar
    hp = torch.stack([out_r, out_i], -1).reshape(h.shape[:-1] + (-1,))
    return torch.cat([hr, hp], -1)


def q_split(v, n_real: int):
    """View a packed Q-layout array ``(..., N)`` as its two native parts:
    ``(real slots (..., n_real), complex pairs (..., (N - n_real) / 2))``.

    The shared helper for the ``[reals | (re, im) pairs]`` layout, used by
    the parallel scans and the kernels dispatch.  ``realified_multiply`` /
    ``pack_lambda_q`` above keep specialized inline forms of the same layout
    for the sequential decode path — a layout change must land in all
    three places together."""
    vr = v[..., :n_real]
    vp = v[..., n_real:].reshape(v.shape[:-1] + (-1, 2))
    return vr, torch.complex(vp[..., 0], vp[..., 1])


def q_merge(vr, vc, dtype):
    """Inverse of :func:`q_split`: re-interleave complex pairs as (re, im)
    lanes after the real slots.  Returns a real ``(..., N)`` tensor."""
    vp = torch.stack([vc.real, vc.imag], -1).reshape(vc.shape[:-1] + (-1,))
    return torch.cat([vr.to(dtype), vp.to(dtype)], -1)


def diag_scan_q(lam_q, x_q, n_real: int, h0=None, *, method: str = "sequential",
                chunk: int = 128, time_axis: int = -2):
    """Q-basis (all-real) scan.  The parallel methods view pairs as complex
    (the combine law is complex multiplication); sequential stays realified.

    ``lam_q``: (N,) packed, or one row of coefficients per batch row — the
    shape of ``x_q`` without its time axis (a param-batched wave, each row
    its own reservoir), static in time either way."""
    if method == "sequential":
        xt = _front(x_q, time_axis)
        h = (torch.zeros(xt.shape[1:], dtype=x_q.dtype, device=x_q.device)
             if h0 is None else h0)
        hs = []
        for i in range(xt.shape[0]):
            h = realified_multiply(h, lam_q, n_real) + xt[i]
            hs.append(h)
        if not hs:
            return x_q
        return _back(torch.stack(hs), time_axis)

    a_r, a_c = q_split(lam_q, n_real)
    if lam_q.ndim > 1:
        # Per-row coefficients: a time axis of 1 broadcasts them over time.
        ta = time_axis - x_q.ndim if time_axis >= 0 else time_axis
        a_r, a_c = a_r.unsqueeze(ta), a_c.unsqueeze(ta)
    x_r, x_c = q_split(x_q, n_real)
    h0_r = h0_c = None
    if h0 is not None:
        h0_r, h0_c = q_split(h0, n_real)
    hs_r = diag_scan(a_r, x_r, h0_r, method=method, chunk=chunk,
                     time_axis=time_axis)
    hs_c = diag_scan(a_c, x_c, h0_c, method=method, chunk=chunk,
                     time_axis=time_axis)
    return q_merge(hs_r, hs_c, x_q.dtype)
