"""Attention for the LM stack of the port (the JAX package's
``models/attention.py``): RoPE, the dense reference, decode against a KV
cache, and ``jnp_flash`` — blocked online-softmax attention whose forward is
the hand-written ``flash_attention_fwd`` kernel (``kernels.ops``) and whose
backward recomputes the scores chunk by chunk from the saved ``lse``, so
nothing of size Sq x Skv is kept between the passes.

``attention`` is the front door the blocks call: dense below 1024 keys,
else flash; causal flash runs as ``_banded_attention``, one kernel launch
per 1024-row query chunk over only the keys that chunk can see.

On a device mesh q, k and v are DTensors and ``attention`` runs the same
code on each rank's own batch rows and heads (``local_map``): the kernel
has no DTensor sharding rule, and attention needs no collective when the
heads are split.  :func:`decode_attention_sharded` is decode against a KV
cache split over the sequence (JAX's flash-decoding layout ``P(dp, None,
tp, None)``): each rank attends to its own slice of the cache and the
slices' softmax terms are combined by one max and two sums over the axis.

``UNROLL_SCANS`` (the JAX module's cost-probe switch, set by the dry run's
``--probes``) runs the flash forward as its plain version in PyTorch ops
(``kernels.ref.flash_attention_fwd_ref``), so a FLOP counter sees its
products; it is never set on the main path.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .. import dist
from ..kernels import ops as kops
from ..kernels.ref import NEG_INF, attention_mask, flash_attention_fwd_ref

__all__ = ["NEG_INF", "UNROLL_SCANS", "rope_frequencies", "apply_rope",
           "dense_attention", "decode_attention", "decode_attention_sharded",
           "jnp_flash", "BANDED", "BAND_Q_CHUNK", "attention"]

#: The dry run's cost-probe switch (see the module docstring).
UNROLL_SCANS = False


# --------------------------------------------------------------------------- #
# RoPE                                                                         #
# --------------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None):
    return theta ** (-torch.arange(0, head_dim // 2, dtype=torch.float32,
                                   device=device) / (head_dim // 2))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (B, H, S, D); positions: (S,) or (B, S).  float32 math, cast back
    to x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs      # (..., S, D/2)
    ang = ang[None, None] if ang.ndim == 2 else ang[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


# --------------------------------------------------------------------------- #
# Dense reference (small shapes, decode)                                       #
# --------------------------------------------------------------------------- #
def dense_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    kv_len=None):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D).  float32 softmax; GQA by
    reshape; fully masked rows give zeros.  Returns v's dtype."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    qf = q.reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf.float(), k.float()) * d ** -0.5
    m = attention_mask(sq, skv, causal=causal, window=window,
                       q_offset=q_offset, kv_len=kv_len, device=q.device)
    p = torch.softmax(torch.where(m, s, NEG_INF), dim=-1)
    p = torch.where(m.any(-1)[:, None], p, 0.0)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype), v)
    return o.reshape(b, hq, sq, d)


def decode_attention(q, k_cache, v_cache, cur_len, *, window=None,
                     ring=False):
    """One-token decode: q (B, Hq, 1, D) against a (B, Hkv, S_max, D) cache.

    ``cur_len``: the number of valid cache entries, a 0-d tensor (the new
    token is already written at cur_len - 1).  ``ring``: the cache is a
    circular window buffer; every slot written so far is in the window by
    construction (positions live in the RoPE'd keys, and softmax does not
    care about order), so the mask is just "slot has been written"."""
    q_offset = cur_len - 1
    b, hq, _, d = q.shape
    _, hkv, smax, _ = k_cache.shape
    qf = q.reshape(b, hkv, hq // hkv, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qf.float(),
                     k_cache.float()) * d ** -0.5
    k_pos = torch.arange(smax, device=q.device)
    m = k_pos < cur_len
    if not ring and window is not None:
        m &= k_pos > q_offset - window
    p = torch.softmax(torch.where(m, s, NEG_INF), dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, hq, 1, d)


# --------------------------------------------------------------------------- #
# Flash attention: the kernel forward, a chunked recompute backward            #
# --------------------------------------------------------------------------- #
def _flash_bwd(q, k, v, out, lse, dout, causal, window, q_offset, block_k,
               kv_len):
    """The JAX ``_jf_bwd`` in PyTorch: per chunk of ``block_k`` keys,
    p = exp(s - lse) from the saved ``lse``, then dv, dp, ds, dq and dk.
    The (Sq, block_k) score-sized temporaries are updated in place, which
    halves their memory traffic against the functional form."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    qg = q.reshape(b, hkv, g, sq, d).float()
    dog = dout.reshape(b, hkv, g, sq, d).float()
    delta = (out.reshape(b, hkv, g, sq, d).float() * dog).sum(-1)
    lse = lse.reshape(b, hkv, g, sq, 1)
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    for k0 in range(0, skv, block_k):
        kf = k[:, :, k0:k0 + block_k].float()
        vf = v[:, :, k0:k0 + block_k].float()
        kn = kf.shape[2]
        p = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf)
        p.mul_(scale).sub_(lse).exp_()
        # Decided from the shapes on the host: is every pair visible?
        if not ((not causal or k0 + kn - 1 <= q_offset)
                and (window is None or k0 > q_offset + sq - 1 - window)
                and (kv_len is None or k0 + kn <= kv_len)):
            p.masked_fill_(~attention_mask(
                sq, kn, causal=causal, window=window, q_offset=q_offset - k0,
                kv_len=None if kv_len is None else kv_len - k0,
                device=q.device), 0.0)
        dvs.append(torch.einsum("bhgqk,bhgqd->bhkd", p, dog))
        ds = torch.einsum("bhgqd,bhkd->bhgqk", dog, vf)
        ds.sub_(delta[..., None]).mul_(p).mul_(scale)
        dq += torch.einsum("bhgqk,bhkd->bhgqd", ds, kf)
        dks.append(torch.einsum("bhgqk,bhgqd->bhkd", ds, qg))
    dq = dq.reshape(b, hq, sq, d).to(q.dtype)
    if not dks:                                         # no keys at all
        return dq, torch.zeros_like(k), torch.zeros_like(v)
    return (dq, torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


class _JnpFlash(torch.autograd.Function):
    """Forward: the ``flash_attention_fwd`` kernel (``out`` and ``lse``);
    backward: :func:`_flash_bwd` from the saved ``(q, k, v, out, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, block_k, kv_len):
        fwd = flash_attention_fwd_ref if UNROLL_SCANS \
            else kops.flash_attention_fwd
        out, lse = fwd(q, k, v, causal=causal, window=window,
                       q_offset=q_offset, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = (causal, window, q_offset, block_k, kv_len)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        grads = _flash_bwd(*ctx.saved_tensors, dout, *ctx.masks)
        return (*grads, None, None, None, None, None)


def jnp_flash(q, k, v, causal=True, window=None, q_offset=0, block_k=512,
              kv_len=None):
    """Flash attention, differentiable in q, k, v.  q: (B, Hq, Sq, D); k/v:
    (B, Hkv, Skv, D); ``kv_len`` masks a padded key tail; ``block_k`` is the
    backward's key chunk (the kernel picks its own tiles)."""
    return _JnpFlash.apply(q, k, v, causal, window, q_offset, block_k,
                           kv_len)


# Beyond-paper switch of the JAX package: q-chunked execution with static
# per-chunk key bounds, so key blocks above the causal diagonal or outside
# the window are never computed.
BANDED = True
BAND_Q_CHUNK = 1024


def _banded_attention(q, k, v, causal, window, q_offset, block_k):
    sq = q.shape[2]
    skv = k.shape[2]
    cq = min(BAND_Q_CHUNK, sq)
    outs = []
    for q0 in range(0, sq, cq):
        q1 = min(q0 + cq, sq)
        qi = q[:, :, q0:q1]
        hi_pos = q_offset + q1          # exclusive upper bound of visible keys
        lo_pos = 0
        if window is not None:
            lo_pos = max(0, q_offset + q0 - window + 1)
        lo = (lo_pos // block_k) * block_k
        hi = min(((hi_pos + block_k - 1) // block_k) * block_k, skv) \
            if causal else skv
        if hi <= lo:
            outs.append(torch.zeros_like(qi))
            continue
        # Keys now start at lo; lo and hi are block-aligned, so no padding
        # or kv_len is needed.
        outs.append(jnp_flash(qi, k[:, :, lo:hi], v[:, :, lo:hi], causal,
                              window, q_offset + q0 - lo, block_k, None))
    return torch.cat(outs, dim=2)


def attention(q, k, v, *, causal=True, window=None, q_offset=0,
              impl: str = "auto", block_k: int = 512):
    """Front door: dense or flash (``impl="auto"``: flash from 1024 keys);
    pads the keys to a multiple of ``block_k`` where the flash backward's
    chunking needs it.  DTensor operands run on each rank's own batch rows
    and heads (:func:`_on_local_heads`)."""
    if dist.is_dtensor(q):
        return _on_local_heads(functools.partial(
            attention, causal=causal, window=window, q_offset=q_offset,
            impl=impl, block_k=block_k), q, k, v)
    skv = k.shape[2]
    if impl == "auto":
        impl = "flash" if skv >= 1024 else "dense"
    if impl == "dense":
        return dense_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if BANDED and causal and skv % block_k == 0 and skv > block_k:
        return _banded_attention(q, k, v, causal, window, q_offset, block_k)
    kv_len = None
    if skv % block_k != 0:
        pad = block_k - skv % block_k
        if causal and q_offset + q.shape[2] <= skv:
            # Padded keys sit beyond every query position: causality masks
            # them, no length mask needed.
            k, v = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
        else:
            # Queries reach past the keys, or non-causal: the largest
            # divisor of skv up to block_k, else pad with a length mask.
            div = max((n for n in range(1, block_k + 1) if skv % n == 0),
                      default=1)
            if div >= 64:
                block_k = div
            else:
                k, v = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
                kv_len = skv
    return jnp_flash(q, k, v, causal, window, q_offset, block_k, kv_len)


# --------------------------------------------------------------------------- #
# On a device mesh                                                             #
# --------------------------------------------------------------------------- #
def _on_local_heads(fn, q, k, v):
    """``fn(q, k, v)`` on DTensors (B, H, S, D), run on local shards.

    Per mesh dim: where q is split over the batch, k and v are too; where
    q is split over its heads, k and v are split over theirs if that keeps
    every rank's query groups whole, else they enter whole and each rank
    takes the KV heads its query heads read; anything else (a sequence
    split, a partial sum) is replicated first.  A rank's k / v gradient is
    then partial where they entered whole but the heads were split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    hq, hkv = q.shape[1], k.shape[1]
    q_pl, kv_pl, kv_grad = [], [], []
    head_split = 1
    for i, pq in enumerate(q.placements):
        n = mesh.size(i)
        if isinstance(pq, Shard) and pq.dim == 0:
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
            kv_grad.append(Shard(0))
        elif isinstance(pq, Shard) and pq.dim == 1 and hq % n == 0:
            q_pl.append(Shard(1))
            head_split *= n
            whole = hkv % n != 0
            kv_pl.append(Replicate() if whole else Shard(1))
            kv_grad.append(Partial() if whole else Shard(1))
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            kv_grad.append(Replicate())
    kv_split = math.prod(mesh.size(i) for i, p in enumerate(kv_pl)
                         if isinstance(p, Shard) and p.dim == 1)
    head_axes = tuple(mesh.mesh_dim_names[i] for i, p in enumerate(q_pl)
                      if p == Shard(1))
    group = hq // hkv

    def local(q, k, v):
        hl = q.shape[1]
        if kv_split == 1 and head_split > 1:
            # This rank's query heads start at h0; query head h reads KV
            # head h // group.
            h0 = hl * dist.block_index(mesh, head_axes)
            if hl % group == 0:
                k = k[:, h0 // group:(h0 + hl) // group]
                v = v[:, h0 // group:(h0 + hl) // group]
            else:
                idx = torch.arange(h0, h0 + hl, device=q.device) // group
                k, v = k.index_select(1, idx), v.index_select(1, idx)
        return fn(q, k, v)

    run = local_map(local, out_placements=q_pl,
                    in_placements=(q_pl, kv_pl, kv_pl),
                    in_grad_placements=(q_pl, kv_grad, kv_grad),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(q, k, v)


def decode_attention_sharded(q, k_new, v_new, k_cache, v_cache, cur, *,
                             window=None, ring=False):
    """One decode step against a KV cache split over its sequence dim:
    write ``k_new`` / ``v_new`` (B, Hkv, 1, D) at slot ``cur`` (modulo the
    cache length for a ring), then attend q (B, Hq, 1, D) to the ``cur + 1``
    valid slots.  All DTensors; ``cur`` a replicated 0-d count.

    Each rank holds a contiguous slice of the slots: it writes the new
    entry if the slot is its own, scores its slice (float32, masked as
    :func:`decode_attention`), weighs it by ``exp(s - M)`` with ``M`` the
    largest score over the split (``pmax``), and the output is the sum of
    the weighted values over the split divided by the sum of the weights.
    Returns ``(out (B, Hq, 1, D), k_cache, v_cache)``, the caches as split
    as they came."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = k_cache.device_mesh
    names = mesh.mesh_dim_names
    cache_pl = list(k_cache.placements)
    seq_axes = tuple(names[i] for i, p in enumerate(cache_pl)
                     if isinstance(p, Shard) and p.dim == 2)
    tok_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else
              Replicate() for p in cache_pl]
    rep = [Replicate()] * mesh.ndim
    smax = k_cache.shape[2]

    def local(q, k_new, v_new, kc, vc, cur):
        s_loc = kc.shape[2]
        pos = dist.block_index(mesh, seq_axes) * s_loc + torch.arange(
            s_loc, device=kc.device)
        slot = torch.remainder(cur, smax) if ring else cur.clamp(0, smax - 1)
        hit = (pos == slot)[None, None, :, None]
        kc = torch.where(hit, k_new.to(kc.dtype), kc)
        vc = torch.where(hit, v_new.to(vc.dtype), vc)
        b, hq, _, d = q.shape
        hkv = kc.shape[1]
        qf = q.reshape(b, hkv, hq // hkv, d)
        s = torch.einsum("bhgd,bhkd->bhgk", qf.float(),
                         kc.float()) * d ** -0.5
        m_ok = pos < cur + 1
        if not ring and window is not None:
            m_ok &= pos > cur - window
        s = torch.where(m_ok, s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        big = dist.pmax(m, mesh, seq_axes)
        p = torch.where(m_ok, torch.exp(s - big), 0.0)
        l = dist.psum(p.sum(-1, keepdim=True), mesh, seq_axes)
        o = torch.einsum("bhgk,bhkd->bhgd", p.to(vc.dtype), vc)
        o = dist.psum(o.float(), mesh, seq_axes) / l
        return o.to(vc.dtype).reshape(b, hq, 1, d), kc, vc

    run = local_map(local, out_placements=(tok_pl, cache_pl, cache_pl),
                    in_placements=(tok_pl, tok_pl, tok_pl, cache_pl,
                                   cache_pl, rep),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(q, k_new, v_new, k_cache, v_cache, cur)
