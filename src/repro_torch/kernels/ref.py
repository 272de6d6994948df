"""Plain PyTorch versions of the CUDA kernels: what a CPU tensor runs, and
what the kernels are held against on the card."""
from __future__ import annotations

import torch

__all__ = ["diag_scan_ref", "diag_scan_lanes_ref", "diag_scan_lanes_bwd_ref",
           "chunk_layout", "diag_scan_lanes_chunked_ref",
           "diag_scan_lanes_bwd_chunked_ref", "decode_fused_ref", "q_lanes",
           "q_repack", "decode_fused_packed_ref", "NEG_INF",
           "attention_mask", "attention_ref", "flash_attention_fwd_ref"]

#: The score of a masked query-key pair (as in the JAX package).
NEG_INF = -1e30


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


def diag_scan_lanes_bwd_ref(a_re, a_im, h_re, h_im, g_re, g_im, h0_re=None,
                            h0_im=None):
    """The gradient of :func:`diag_scan_lanes_ref`, one step at a time
    backwards in time.  ``a_*`` and ``h0_*`` as given to the forward, ``h_*``
    its output (B, T, N), ``g_*`` the gradient of that output (``_im``
    operands None for a real scan).  With s_T = 0:

        s_t = g_t + conj(a_{t+1}) s_{t+1},   dx_t = s_t,
        da_t = s_t conj(h_{t-1}) (h_{-1} = h0, zero if absent),
        dh0 = conj(a_0) s_0

    (PyTorch's convention for complex gradients, which on the (re, im) lanes
    is the real gradient).  Returns ``(da_re, da_im, dx_re, dx_im, dh0_re,
    dh0_im)`` with ``da`` summed to the shape of ``a_re`` and ``dh0`` to that
    of ``h0_re`` (None without ``h0``).
    """
    cplx = g_im is not None
    b, t, n = g_re.shape
    full = (b, t, n)

    def lanes(re, im, shape):
        zero = g_re.new_zeros(shape)
        return (zero if re is None else torch.broadcast_to(re, shape),
                zero if im is None else torch.broadcast_to(im, shape))
    ar, ai = lanes(a_re, a_im, full)
    pr, pi = lanes(h0_re, h0_im, (b, n))
    sr, si = g_re.new_zeros((b, n)), g_re.new_zeros((b, n))
    nr, ni = sr, si                         # a_{t+1}; moot while s = 0
    dx_re, dx_im = torch.empty_like(g_re), torch.empty_like(g_re)
    da_re, da_im = torch.empty_like(g_re), torch.empty_like(g_re)
    for i in reversed(range(t)):
        gi = g_im[:, i] if cplx else 0.0
        sr, si = g_re[:, i] + nr * sr + ni * si, gi + nr * si - ni * sr
        dx_re[:, i], dx_im[:, i] = sr, si
        hr, hi = (h_re[:, i - 1], h_im[:, i - 1] if cplx else 0.0) if i \
            else (pr, pi)
        da_re[:, i] = sr * hr + si * hi
        da_im[:, i] = si * hr - sr * hi
        nr, ni = ar[:, i], ai[:, i]
    if t == 0:
        nr = ni = g_re.new_zeros((b, n))
    dh0_re, dh0_im = nr * sr + ni * si, nr * si - ni * sr

    def to(v, like):
        return None if like is None else v.sum_to_size(like.shape)
    return (to(da_re, a_re), to(da_im, a_im), dx_re,
            dx_im if cplx else None, to(dh0_re, h0_re), to(dh0_im, h0_im))


def chunk_layout(t: int, chunks: int):
    """``(n_chunks, chunk_len)`` of a scan of ``t`` steps cut into at most
    ``chunks`` chunks: chunk_len = ceil(t / chunks) (at least 1), n_chunks =
    ceil(t / chunk_len), so only the last chunk may be shorter (and no chunk
    is empty: ``chunks`` above ``t`` gives ``t`` one-step chunks)."""
    if chunks < 1:
        raise ValueError(f"chunks must be >= 1, got {chunks}")
    chunk_len = max(1, -(-t // chunks))
    return -(-t // chunk_len), chunk_len


def _cplx(re, im):
    """One operand of the lane scans as one tensor (complex when ``im`` is
    given)."""
    if re is None:
        return None
    return re if im is None else torch.complex(re, im)


def _lanes_of(v, cplx):
    return (v.real, v.imag) if cplx else (v, None)


def _power(a, e: int):
    """``a ** e`` by repeated squaring, as the kernels form a static
    coefficient's chunk product."""
    p = torch.ones_like(a)
    while e > 0:
        if e & 1:
            p = p * a
        e >>= 1
        if e > 0:
            a = a * a
    return p


def _static_in_time(a):
    return a.ndim < 2 or a.shape[-2] == 1


def diag_scan_lanes_chunked_ref(a_re, a_im, x_re, x_im, h0_re=None,
                                h0_im=None, *, chunks: int):
    """:func:`diag_scan_lanes_ref` through the scan kernel's decomposition,
    one step at a time: cut time into chunks (:func:`chunk_layout`); reduce
    each chunk but the last from a zero carry to its end state ``e`` and its
    coefficient product ``P`` (``a ** chunk_len`` for an ``a`` static in
    time); compose the carry into chunk c as ``h = P h + e`` over the
    chunks before it, starting from ``h0``; rescan each chunk from its
    carry.  (The kernel composes each chunk's carry in its own thread from
    ``h0``; the running composition here gives the same values.)"""
    cplx = x_im is not None
    a, x = _cplx(a_re, a_im), _cplx(x_re, x_im)
    h0 = _cplx(h0_re, h0_im)
    b, t, n = x.shape
    n_chunks, size = chunk_layout(t, chunks)
    af = torch.broadcast_to(a, (b, t, n))
    zero = x.new_zeros((b, n))

    def run(c, h):
        """Chunk c from the carry ``h``: its states and its product."""
        hs, p = [], torch.ones_like(zero)
        for i in range(c * size, min(t, (c + 1) * size)):
            h = af[:, i] * h + x[:, i]
            p = p * af[:, i]
            hs.append(h)
        return hs, p
    reduced = []
    for c in range(n_chunks - 1):
        hs, p = run(c, zero)
        if _static_in_time(a):
            p = _power(af[:, 0], size)
        reduced.append((hs[-1], p))
    out = []
    h = zero if h0 is None else torch.broadcast_to(h0, (b, n)).to(x.dtype)
    for c in range(n_chunks):
        out += run(c, h)[0]
        if c < n_chunks - 1:
            e, p = reduced[c]
            h = p * h + e
    hs = torch.stack(out, 1) if out else x.clone()
    return _lanes_of(hs, cplx)


def diag_scan_lanes_bwd_chunked_ref(a_re, a_im, h_re, h_im, g_re, g_im,
                                    h0_re=None, h0_im=None, *, chunks: int):
    """:func:`diag_scan_lanes_bwd_ref` through the backward kernel's
    decomposition in reverse time.  The carry from step t to step t-1 is
    k_t = conj(a_t) s_t, so s_{t-1} = g_{t-1} + k_t and dh0 = k_0.  Reduce
    each chunk but the first, walking back from its last step with k = 0,
    to the carry it hands on (``e``) and the product of conj(a_t) over it
    (``P``; ``conj(a) ** chunk_len`` for an ``a`` static in time); compose
    the carry into chunk c as ``k = P k + e`` over the chunks after it (the
    last starts from 0, so needs no ``P``); rescan each chunk from its carry
    for dx and da.  For a static ``a``, da is summed per (b, chunk) first,
    as the kernel writes it.  Returns what :func:`diag_scan_lanes_bwd_ref`
    returns."""
    cplx = g_im is not None
    a, h, g = _cplx(a_re, a_im), _cplx(h_re, h_im), _cplx(g_re, g_im)
    h0 = _cplx(h0_re, h0_im)
    b, t, n = g.shape
    n_chunks, size = chunk_layout(t, chunks)
    ac = torch.conj(torch.broadcast_to(a, (b, t, n))).resolve_conj()
    zero = g.new_zeros((b, n))
    hp0 = zero if h0 is None else torch.broadcast_to(h0, (b, n)).to(g.dtype)
    static = _static_in_time(a)

    def run(c, k):
        """Chunk c backwards from the carry ``k``: {t: s_t}, the carry out
        and the product."""
        ss, p = {}, torch.ones_like(zero)
        for i in reversed(range(c * size, min(t, (c + 1) * size))):
            ss[i] = g[:, i] + k
            k = ac[:, i] * ss[i]
            p = p * ac[:, i]
        return ss, k, p
    reduced = {}
    for c in range(1, n_chunks):
        _, e, p = run(c, zero)
        if static:
            p = _power(ac[:, 0], size)
        reduced[c] = (e, p)
    dx, da = torch.empty_like(g), torch.empty_like(g)
    da_parts = g.new_zeros((b, n_chunks, n))
    k, dh0 = zero, zero
    for c in reversed(range(n_chunks)):
        if c == n_chunks - 2:
            k = reduced[c + 1][0]
        elif c < n_chunks - 2:
            e, p = reduced[c + 1]
            k = p * k + e
        ss, k_out, _ = run(c, k)
        for i, s in ss.items():
            dx[:, i] = s
            hp = h[:, i - 1] if i else hp0
            da[:, i] = s * torch.conj(hp)
            da_parts[:, c] += da[:, i]
        if c == 0:
            dh0 = k_out
    da = da_parts if static else da

    def to(v, like):
        return None if like is None else v.sum_to_size(like.shape)
    da_re, da_im = _lanes_of(da, cplx)
    dx_re, dx_im = _lanes_of(dx, cplx)
    dh0_re, dh0_im = _lanes_of(dh0, cplx)
    return (to(da_re, a_re), to(da_im, a_im), dx_re, dx_im,
            to(dh0_re, h0_re), to(dh0_im, h0_im))


def _mm(v, w):
    """Row-batch times weight, row by row: row b of ``v`` (B, F) with the
    shared (F, G) weight or with slot b's of a (B, F, G) stack — the same
    products summed over F in one order either way, so a row's result does
    not depend on whether its weight is shared or stacked (the serving
    arena's readout contraction, ``serve.arena.apply_readout``)."""
    if w.ndim == 2:
        w = w.expand((v.shape[0],) + tuple(w.shape))
    return (v.unsqueeze(-1) * w).contiguous().sum(-2)


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


def q_lanes(v, nr: int, axis: int = -1):
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


def q_repack(re, im, nr: int):
    """Inverse of :func:`q_lanes` on the last axis: real lanes back in
    front, pair lanes re-interleaved to the packed layout."""
    pre, pim = re[..., nr:], im[..., nr:]
    pairs = torch.stack([pre, pim], -1).reshape(
        pre.shape[:-1] + (2 * pre.shape[-1],))
    return torch.cat([re[..., :nr], pairs], -1)


def decode_fused_packed_ref(lam_q, n_real: int, w_drive, w_out, states,
                            y_prev, mask, *, k: int, use_bias: bool,
                            use_feedback: bool, ensemble: str = "off"):
    """K fused closed-loop decode steps on the engine's packed Q layout:
    the lanes split out (:func:`q_lanes`), :func:`decode_fused_ref`, the new
    state packed back (:func:`q_repack`).

    ``lam_q`` (N,) / (B, N); ``w_drive`` (D, N) / (B, D, N); ``w_out``
    (F, D) / (B, F, D) with rows ``[bias? | y_prev? | states]``;
    ``states`` (B, N), ``y_prev`` (B, D), ``mask`` (B,).  With
    ``ensemble="mean"`` every live row starts from the live rows' mean
    output (seed parity with the engine's step-at-a-time closed loop).
    Returns ``(states', y_prev', ys)``, ``ys`` (k, B, D).
    """
    nr = n_real
    d = y_prev.shape[-1]
    a_re, a_im = q_lanes(lam_q, nr)
    h_re, h_im = q_lanes(states, nr)
    wd_re, wd_im = q_lanes(w_drive, nr)
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
    wh_re, wh_im = q_lanes(w_out[..., idx:, :], nr, axis=-2)
    mask = torch.as_tensor(mask, device=states.device)
    y0 = y_prev
    if ensemble == "mean":
        live, m = live_mask(mask, y0.dtype)
        denom = torch.clamp(m.sum(), min=1.0)
        y_mean = (y0 * m).sum(0, keepdim=True) / denom
        y0 = torch.where(live, torch.broadcast_to(y_mean, y0.shape), y0)
    h_re, h_im, y, ys = decode_fused_ref(
        a_re, a_im, h_re, h_im, y0, wd_re, wd_im, wy, b_out, wh_re, wh_im,
        mask, k=k, ensemble=ensemble)
    return q_repack(h_re, h_im, nr), y, ys


def attention_mask(sq, skv, *, causal=True, window=None, q_offset=0,
                   kv_len=None, device=None):
    """(Sq, Skv) bool: key j is visible to query i (at position q_offset + i)
    under the causal, sliding-window and key-length masks."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    m = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        m &= k_pos <= q_pos
    if window is not None:
        m &= k_pos > q_pos - window
    if kv_len is not None:
        m &= k_pos < kv_len
    return m


def _gqa_scores(q, k, scale, mask):
    """Masked float32 scores (B, Hkv, G, Sq, Skv) of q (B, Hq, Sq, D) against
    k (B, Hkv, Skv, D), query head h reading KV head h // (Hq // Hkv)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    return torch.where(mask, s, NEG_INF)


def attention_ref(q, k, v, *, causal=True, window=None, q_offset=0,
                  scale=None):
    """Dense softmax attention with GQA / causal / window in float32 — the
    oracle of the flash kernel (and what its backward recomputes through).
    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).  Rows with no visible key
    give zeros.  Returns q's shape and dtype."""
    b, hq, sq, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    mask = attention_mask(sq, k.shape[2], causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    p = torch.softmax(_gqa_scores(q, k, scale, mask), dim=-1)
    p = torch.where(mask.any(-1)[:, None], p, 0.0)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def flash_attention_fwd_ref(q, k, v, *, causal=True, window=None, q_offset=0,
                            kv_len=None, scale=None):
    """The flash kernel's function, densely: ``(out, lse)`` with ``out`` in
    q's dtype and ``lse = m + log(l)`` (float32, (B, Hq, Sq); -1e30 for a row
    with no visible key, whose output is zeros).  Masks as
    :func:`attention_mask`; p is cast to v's dtype before the p.v product,
    as the kernel casts it."""
    b, hq, sq, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    mask = attention_mask(sq, k.shape[2], causal=causal, window=window,
                          q_offset=q_offset, kv_len=kv_len, device=q.device)
    s = _gqa_scores(q, k, scale, mask)
    m = s.amax(-1, keepdim=True) if s.shape[-1] else torch.full_like(
        s[..., :1], NEG_INF)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    out = (o / safe).reshape(b, hq, sq, d).to(q.dtype)
    lse = (m + torch.log(safe)).reshape(b, hq, sq)
    return out, lse
