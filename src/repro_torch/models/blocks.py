"""LM building blocks of the port: norms, the SwiGLU/GELU MLP, GQA attention
(full, sliding-window or local, with RoPE and a KV cache), the MoE block
(top-k routing into per-expert capacity buffers), the recurrent mixers —
recurrentgemma's RG-LRU block, xLSTM's mLSTM and sLSTM — and the paper's
LinearReservoir layer as a sequence mixer (the JAX package's
``models/blocks.py``).

Parameters are nested dicts of tensors under the JAX package's key names,
and every ``init_*`` draws from an explicit CPU ``torch.Generator`` and
returns the params alone (the JAX ``init_*`` also return sharding specs: the
LM runs on one device; a mesh — :func:`constrain`, the MoE block's
expert-parallel path — raises naming ROADMAP A11's LM half; the serving
arena's mesh is ``sharding.rules.plan_arena``).

Products promote as ``jnp``'s do (:func:`mm`, :func:`einsum`): float32
activations against a bfloat16 weight (recurrentgemma's embed scale makes
them float32) multiply in float32.  The RG-LRU and sLSTM recurrences run
through ``kernels.ops.diag_scan``: the hand-written scan kernel and its
backward on a CUDA tensor, their plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import spectral
from ..kernels import ops as kops
from . import attention as attn_mod

__all__ = ["ShardProfile", "NULL_PROFILE", "one_device", "constrain",
           "torch_dtype", "init_norm", "apply_norm", "init_mlp", "apply_mlp",
           "init_attention", "apply_attention", "apply_attention_decode",
           "init_moe", "moe_route", "apply_moe",
           "init_reservoir", "apply_reservoir", "mm", "einsum",
           "init_rglru_block", "apply_rglru_block", "init_mlstm",
           "apply_mlstm", "init_slstm", "apply_slstm"]


# --------------------------------------------------------------------------- #
# Sharding profile                                                             #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ShardProfile:
    """How an arch maps onto a device mesh; all-None is one device, the only
    layout the port's LM runs (a mesh is ROADMAP A11 (LM sharding))."""
    mesh: Optional[Any] = None
    tp: Optional[str] = None
    fsdp: Optional[str] = None
    dp: tuple = ()
    tp_size: int = 1
    seq: Optional[str] = None


NULL_PROFILE = ShardProfile()


def one_device(prof: ShardProfile) -> None:
    """Raise unless ``prof`` is the one-device layout the port runs."""
    if prof.mesh is not None:
        raise NotImplementedError("sharded LM layouts are not ported yet: "
                                  "ROADMAP A11 (LM sharding)")


def constrain(x, spec, prof: ShardProfile):
    """A sharding constraint: the identity on one device."""
    one_device(prof)
    return x


def _promoted(*ts):
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return [t.to(dtype) for t in ts]


def mm(x, w):
    """``x @ w`` in the promoted dtype of the two, as ``jnp``'s ``@``: a
    bfloat16 weight against float32 activations multiplies in float32
    (torch refuses mixed dtypes).  Equal dtypes are left as they are."""
    x, w = _promoted(x, w)
    return x @ w


def einsum(eq, *operands):
    """``torch.einsum`` with ``jnp.einsum``'s promotion (see :func:`mm`)."""
    return torch.einsum(eq, *_promoted(*operands))


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"float32"``, ...)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


# --------------------------------------------------------------------------- #
# Norms                                                                        #
# --------------------------------------------------------------------------- #
def init_norm(d, dtype, kind="rmsnorm"):
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype)}
    return {"scale": torch.ones((d,), dtype=dtype),
            "bias": torch.zeros((d,), dtype=dtype)}


def apply_norm(p, x, kind="rmsnorm", eps=1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        nrm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (nrm * p["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    nrm = (xf - mu) * torch.rsqrt(var + eps)
    return (nrm * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _dense_init(gen, shape, dtype, scale=None):
    scale = (1.0 / math.sqrt(shape[0])) if scale is None else scale
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * scale).to(dtype)


# --------------------------------------------------------------------------- #
# MLP (SwiGLU / GELU)                                                          #
# --------------------------------------------------------------------------- #
def _silu(v):
    """jax.nn.silu: v * logistic(v), the logistic as 1 / (1 + exp(-v)).  In
    a low-precision dtype every step rounds to it, as the JAX ops do;
    F.silu would round once, at the end."""
    if v.dtype in (torch.float32, torch.float64):
        return F.silu(v)
    return v * torch.reciprocal(1 + torch.exp(-v))


_ACTS = {"silu": _silu,
         # jax.nn.gelu's default is the tanh approximation.
         "gelu": lambda v: F.gelu(v, approximate="tanh")}


def init_mlp(gen, d, f, dtype, gated=True, bias=False):
    p = {"wi": _dense_init(gen, (d, f), dtype)}
    if gated:
        p["wg"] = _dense_init(gen, (d, f), dtype)
    p["wo"] = _dense_init(gen, (f, d), dtype)
    if bias:
        p["bi"] = torch.zeros((f,), dtype=dtype)
        p["bo"] = torch.zeros((d,), dtype=dtype)
    return p


def apply_mlp(p, x, act="silu", gated=True):
    h = mm(x, p["wi"])
    if "bi" in p:
        h = h + p["bi"]
    a = _ACTS[act]
    h = a(mm(x, p["wg"])) * h if gated else a(h)
    out = mm(h, p["wo"])
    if "bo" in p:
        out = out + p["bo"]
    return out


# --------------------------------------------------------------------------- #
# GQA attention block                                                          #
# --------------------------------------------------------------------------- #
def init_attention(gen, cfg, dtype):
    """3-D weights: ``wq`` (d, Hq, hd), ``wk``/``wv`` (d, Hkv, hd), ``wo``
    (Hq, hd, d) scaled by 1/sqrt(Hq * hd); zero biases with ``qkv_bias``."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {"wq": _dense_init(gen, (d, hq, hd), dtype),
         "wk": _dense_init(gen, (d, hkv, hd), dtype),
         "wv": _dense_init(gen, (d, hkv, hd), dtype),
         "wo": _dense_init(gen, (hq, hd, d), dtype,
                           scale=1.0 / math.sqrt(hq * hd))}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq, hd), dtype=dtype)
        p["bk"] = torch.zeros((hkv, hd), dtype=dtype)
        p["bv"] = torch.zeros((hkv, hd), dtype=dtype)
    return p


def _qkv(p, x, rope_theta, positions):
    q = einsum("bsd,dhk->bhsk", x, p["wq"])
    k = einsum("bsd,dhk->bhsk", x, p["wk"])
    v = einsum("bsd,dhk->bhsk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    if rope_theta:
        q = attn_mod.apply_rope(q, positions, rope_theta)
        k = attn_mod.apply_rope(k, positions, rope_theta)
    return q, k, v


def apply_attention(p, x, cfg, *, causal=True, window=None, positions=None,
                    impl="auto"):
    """Full-sequence path, x (B, S, d).  Returns ``(out, (k, v))`` with the
    full-length (B, Hkv, S, hd) keys and values (the prefill caches)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _qkv(p, x, cfg.rope_theta, positions)
    o = attn_mod.attention(q, k, v, causal=causal, window=window, impl=impl)
    return einsum("bhsk,hkd->bsd", o, p["wo"]), (k, v)


def apply_attention_decode(p, x, cfg, cache, *, window=None):
    """x: (B, 1, d); cache ``{"k", "v"}`` (B, Hkv, S, hd) and ``"len"`` (a
    0-d int tensor).  Returns ``(out, new_cache)``; the cache is not
    modified in place.

    When the cache is window-sized (a ring buffer: long-context decode of
    sliding-window or local attention), writes wrap modulo its length.  RoPE
    is applied at the absolute position before caching, so ring order does
    not matter.  As JAX's ``dynamic_update_slice``, a write past the end of
    a linear cache lands on its last slot."""
    cur = cache["len"]
    smax = cache["k"].shape[2]
    ring = window is not None and smax <= window
    q, k_new, v_new = _qkv(p, x, cfg.rope_theta, cur.reshape(1))
    slot = torch.remainder(cur, smax) if ring else cur.clamp(0, smax - 1)
    slot = slot.reshape(1).long()
    k_cache = cache["k"].index_copy(2, slot, k_new.to(cache["k"].dtype))
    v_cache = cache["v"].index_copy(2, slot, v_new.to(cache["v"].dtype))
    o = attn_mod.decode_attention(q, k_cache, v_cache, cur + 1, window=window,
                                  ring=ring)
    out = einsum("bhsk,hkd->bsd", o, p["wo"])
    return out, {"k": k_cache, "v": v_cache, "len": cur + 1}


# --------------------------------------------------------------------------- #
# Mixture of Experts (the one-device path)                                    #
# --------------------------------------------------------------------------- #
def init_moe(gen, cfg, dtype):
    """A float32 ``router`` (d, E) beside the experts' ``wg`` / ``wu`` (E, d,
    F) and ``wd`` (E, F, d) in ``dtype``, as the JAX ``init_moe``."""
    d, f, e = cfg.d_model, cfg.moe_ff, cfg.n_experts
    return {"router": _dense_init(gen, (d, e), torch.float32),
            "wg": _dense_init(gen, (e, d, f), dtype),
            "wu": _dense_init(gen, (e, d, f), dtype),
            "wd": _dense_init(gen, (e, f, d), dtype)}


def moe_route(x2d, router, *, top_k, capacity, e_local):
    """The router and the capacity dispatch of :func:`_moe_local`: float32
    logits and softmax, the top ``top_k`` experts of each token with their
    weights renormalised to sum 1, and each assignment's slot in its
    expert's buffer of ``capacity`` rows.

    The slot is the running count of earlier assignments to the same
    expert in token-major ``(T·k)`` order — the JAX package's ``cumsum``
    over a one-hot — so an assignment past ``capacity`` is dropped exactly
    where JAX drops it.  Returns ``(logits (T, E), probs, top_w (T, k),
    top_e (T, k), slot (T·k,), keep (T·k,))``; a dropped assignment has
    ``keep`` False and ``slot`` ``e_local * capacity`` (the drop row)."""
    logits = x2d.float() @ router
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    col = top_e.reshape(-1)
    running = F.one_hot(col, e_local).cumsum(0)
    pos = running.gather(1, col[:, None])[:, 0] - 1
    keep = pos < capacity
    slot = torch.where(keep, col * capacity + pos, e_local * capacity)
    return logits, probs, top_w, top_e, slot, keep


def _moe_local(x2d, router, wg, wu, wd, *, top_k, capacity, e_total,
               act="silu"):
    """Dispatch the tokens ``x2d`` (T, d) against the experts ``w*``
    (E, ...): gather each expert's kept tokens into its (capacity, d)
    buffer, run the gated expert MLPs as batched products, and add each
    token's ``top_k`` outputs back, weighted, one k at a time — each sum
    rounds to ``x2d``'s dtype, as JAX's loop does.  Returns ``(out (T, d),
    {"load_balance", "router_z"})``, the aux losses float32 over the full
    router."""
    t, d = x2d.shape
    e_local = wg.shape[0]
    logits, probs, top_w, top_e, slot, keep = moe_route(
        x2d, router, top_k=top_k, capacity=capacity, e_local=e_local)
    drop = e_local * capacity
    flat_t = torch.arange(t, device=x2d.device).repeat_interleave(top_k)
    # Token indices into the buffers (the drop row collects every dropped
    # assignment and is cut off), then one gather of the activations.
    token_idx = torch.full((drop + 1,), t, dtype=torch.long,
                           device=x2d.device)
    token_idx[slot] = torch.where(keep, flat_t, t)
    x_pad = torch.cat([x2d, x2d.new_zeros((1, d))])
    xg = x_pad[token_idx[:-1]].reshape(e_local, capacity, d)
    h = einsum("ecd,edf->ecf", xg, wu)
    g = einsum("ecd,edf->ecf", xg, wg)
    h = _ACTS[act](g) * h
    y = einsum("ecf,efd->ecd", h, wd).reshape(drop, d)
    y = torch.cat([y, y.new_zeros((1, d))])
    out = x2d.new_zeros((t, d))
    slot_tk = slot.reshape(t, top_k)
    for j in range(top_k):
        out = out + (top_w[:, j, None] * y[slot_tk[:, j]]).to(x2d.dtype)
    me = probs.mean(0)
    ce = F.one_hot(top_e[:, 0], e_total).float().mean(0)
    aux = {"load_balance": e_total * (me * ce).sum(),
           "router_z": (torch.logsumexp(logits, dim=-1) ** 2).mean()}
    return out, aux


def apply_moe(p, x, cfg, prof: ShardProfile = NULL_PROFILE):
    """x: (B, S, d) -> ``(out (B, S, d), aux)`` on one device, every token
    against every expert, with the JAX package's capacity
    ``int(capacity_factor * B * S * top_k / E) + 1``.  The expert-parallel
    path of a mesh (JAX's ``shard_map``) is ROADMAP A11 (LM sharding)."""
    one_device(prof)
    b, s, d = x.shape
    e_total = cfg.n_experts
    cap = int(cfg.capacity_factor * b * s * cfg.top_k / e_total) + 1
    out, aux = _moe_local(x.reshape(b * s, d), p["router"], p["wg"], p["wu"],
                          p["wd"], top_k=cfg.top_k, capacity=cap,
                          e_total=e_total, act=cfg.act)
    return out.reshape(b, s, d), aux


# --------------------------------------------------------------------------- #
# RG-LRU recurrent block (recurrentgemma) — the paper's scan, gated            #
# --------------------------------------------------------------------------- #
#: RG-LRU's gate constant c: a = exp(-c r softplus(lam_p)).
RGLRU_C = 8.0


def init_rglru_block(gen, cfg, dtype):
    """The JAX ``init_rglru_block``'s keys, shapes and dtypes.  ``lam_p``
    is drawn as JAX draws it (``np.random.default_rng(0)``), so it is
    bit-equal: recurrence magnitudes on (0.9, 0.999) at r = 1."""
    d, dr = cfg.d_model, cfg.d_rnn
    u = np.random.default_rng(0).uniform(0.9, 0.999, size=dr)
    lam_p = np.log(np.expm1(-np.log(u) / RGLRU_C))
    return {
        "w_x": _dense_init(gen, (d, dr), dtype),
        "w_gate": _dense_init(gen, (d, dr), dtype),
        "conv": (torch.randn((cfg.conv_width, dr), generator=gen)
                 * 0.1).to(dtype),
        "w_a": _dense_init(gen, (dr, dr), dtype),
        "b_a": torch.zeros((dr,), dtype=dtype),
        "w_i": _dense_init(gen, (dr, dr), dtype),
        "b_i": torch.zeros((dr,), dtype=dtype),
        "lam_p": torch.tensor(lam_p, dtype=torch.float32),
        "w_out": _dense_init(gen, (dr, d), dtype),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv over time.  x: (B, S, C); w: (W, C); ``state``:
    the (B, W-1, C) trailing context of decode.  Returns ``(y,
    new_state)``.  As ``jnp.concatenate``, a bfloat16 state joined to
    float32 ``x`` promotes: the state is float32 from then on."""
    width = w.shape[0]
    pad = x.new_zeros((x.shape[0], width - 1) + tuple(x.shape[2:])) \
        if state is None else state
    pad, x = _promoted(pad, x)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(width))
    return y, (xp[:, -(width - 1):] if width > 1 else None)


def _rglru_core(p, xr, h0=None, *, step=False):
    """xr: (B, S, dr) after the conv.  Returns ``(states (B, S, dr) in xr's
    dtype, last state (B, dr) float32)``.  The gates are float32; the scan
    is ``kernels.ops.diag_scan`` with per-timestep ``a`` (B, S, dr), whose
    gradient reaches the gates; ``step`` (one decode token against ``h0``)
    takes the single update instead, as the JAX decode fast path does."""
    r = torch.sigmoid(mm(xr, p["w_a"]) + p["b_a"]).float()
    i = torch.sigmoid(mm(xr, p["w_i"]) + p["b_i"]).float()
    log_a = -RGLRU_C * r * F.softplus(p["lam_p"])       # (B, S, dr), <= 0
    a = torch.exp(log_a)
    gated_x = (i * xr.float()) * torch.sqrt(
        torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    if step:
        h = a * h0[:, None] + gated_x
    else:
        h = kops.diag_scan(a, gated_x, h0)
    return h.to(xr.dtype), h[:, -1]


def apply_rglru_block(p, x, cfg, *, cache=None):
    """Griffin-style recurrent block: x (B, S, d) -> ``(out, {"conv": (B,
    W-1, dr), "h": (B, dr) float32})``; ``cache`` carries both in (decode:
    one token, one sequential step, no kernel)."""
    xr = mm(x, p["w_x"])
    gate = _ACTS["gelu"](mm(x, p["w_gate"]))
    xc, new_conv = _causal_conv(xr, p["conv"],
                                None if cache is None else cache["conv"])
    h0 = None if cache is None else cache["h"]
    hs, last = _rglru_core(p, xc, h0,
                           step=cache is not None and x.shape[1] == 1)
    out = mm(hs * gate, p["w_out"])
    return out, {"conv": new_conv, "h": last.float()}


# --------------------------------------------------------------------------- #
# mLSTM (matrix memory, chunkwise) and sLSTM (scalar memory, stabilized)       #
# --------------------------------------------------------------------------- #
def init_mlstm(gen, cfg, dtype):
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    return {"wq": _dense_init(gen, (d, h, hd), dtype),
            "wk": _dense_init(gen, (d, h, hd), dtype),
            "wv": _dense_init(gen, (d, h, hd), dtype),
            "wi": _dense_init(gen, (d, h), dtype),
            "wf": _dense_init(gen, (d, h), dtype),
            "bf": torch.full((h,), 3.0, dtype=dtype),  # open forget gates
            "wo": _dense_init(gen, (h, hd, d), dtype)}


def apply_mlstm(p, x, cfg, *, cache=None, chunk=64):
    """Chunkwise mLSTM: C_t = f_t C + i_t k v^T; h = C^T q / max(|n.q|, 1),
    with the JAX package's sigmoid input gate.  Plain PyTorch (the JAX
    package has no kernel for it): one step of the chunk loop per ``chunk``
    tokens, one chunk when ``S % chunk != 0`` (decode: S = 1).  ``cache``:
    ``{"C": (B, H, hd, hd), "n": (B, H, hd)}`` float32."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    q = einsum("bsd,dhk->bhsk", x, p["wq"]).float() * hd ** -0.5
    k = einsum("bsd,dhk->bhsk", x, p["wk"]).float()
    v = einsum("bsd,dhk->bhsk", x, p["wv"]).float()
    ig = torch.sigmoid(einsum("bsd,dh->bhs", x, p["wi"])).float()
    fg = torch.sigmoid(einsum("bsd,dh->bhs", x, p["wf"])
                       + p["bf"][None, :, None].float())
    C = x.new_zeros((b, h, hd, hd), dtype=torch.float32) if cache is None \
        else cache["C"]
    n = x.new_zeros((b, h, hd), dtype=torch.float32) if cache is None \
        else cache["n"]
    if s % chunk != 0:
        chunk = s
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    outs = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        qk, kk, vk, ik, fk = q[:, :, sl], k[:, :, sl], v[:, :, sl], \
            ig[:, :, sl], fg[:, :, sl]
        cum = torch.cumsum(torch.log(torch.clamp(fk, min=1e-9)), -1)
        total = cum[..., -1:]
        # intra-chunk decay D[t, s] = exp(cum_t - cum_s) i_s, s <= t
        dec = cum[..., :, None] - cum[..., None, :]
        amat = torch.where(tri, torch.exp(dec) * ik[..., None, :], 0.0)
        scores = torch.einsum("bhtd,bhsd->bhts", qk, kk) * amat
        inter_q = torch.exp(cum)                            # P_t
        num = torch.einsum("bhts,bhsd->bhtd", scores, vk) + \
            inter_q[..., None] * torch.einsum("bhtd,bhde->bhte", qk, C)
        den = scores.sum(-1) + inter_q * torch.einsum("bhtd,bhd->bht", qk, n)
        outs.append(num / torch.clamp(den.abs(), min=1.0)[..., None])
        # state update: C' = F C + sum_s (F / P_s) i_s k_s v_s^T
        wts = torch.exp(total - cum) * ik
        C = torch.exp(total)[..., None] * C + torch.einsum(
            "bhs,bhsd,bhse->bhde", wts, kk, vk)
        n = torch.exp(total) * n + torch.einsum("bhs,bhsd->bhd", wts, kk)
    hs = torch.cat(outs, dim=2)
    out = einsum("bhsk,hkd->bsd", hs.to(x.dtype), p["wo"])
    return out, {"C": C, "n": n}


def init_slstm(gen, cfg, dtype):
    d = cfg.d_model
    return {"wz": _dense_init(gen, (d, d), dtype),
            "wi": _dense_init(gen, (d, d), dtype),
            "wf": _dense_init(gen, (d, d), dtype),
            "bf": torch.full((d,), 3.0, dtype=dtype),
            "wog": _dense_init(gen, (d, d), dtype),
            "wo": _dense_init(gen, (d, d), dtype)}


def _maxplus_scan(f, i):
    """m_t = max(f_t + m_{t-1}, i_t) along dim 1 (m_{-1} = -inf), as the
    JAX package's ``lax.associative_scan`` of the pairs (f, i) under
    (f1, i1) . (f2, i2) = (f1 + f2, max(i1 + f2, i2)): a log-depth
    (Hillis-Steele) doubling scan under the same combine.  Its f-sums
    group terms in another tree than XLA's, so m parts from JAX's by
    rounding (a few float32 ulps); the outputs hardly feel it, because m
    only rescales c and n alike.  One step returns i itself, as JAX."""
    t, off = f.shape[1], 1
    while off < t:
        i = torch.cat([i[:, :off], torch.maximum(i[:, :-off] + f[:, off:],
                                                 i[:, off:])], dim=1)
        if 2 * off < t:
            f = torch.cat([f[:, :off], f[:, :-off] + f[:, off:]], dim=1)
        off *= 2
    return i


def apply_slstm(p, x, cfg, *, cache=None):
    """Parallel sLSTM (input-conditioned gates, exponential input gate
    with the max-plus stabiliser; the JAX package drops the hidden-to-gate
    recurrence).  ``cache``: ``{"c", "n", "m"}`` (B, d) float32; a fresh
    decode cache starts ``m`` at -1e30.  The ``c`` and ``n`` recurrences
    share ``f'`` and run as two ``kernels.ops.diag_scan`` calls."""
    zf = torch.tanh(mm(x, p["wz"])).float()
    itil = mm(x, p["wi"]).float()
    ftil = F.logsigmoid((mm(x, p["wf"]) + p["bf"]).float())
    og = torch.sigmoid(mm(x, p["wog"]).float())
    m_prev0 = None if cache is None else cache["m"]
    it = itil
    if m_prev0 is not None:   # fold the carry into step 0
        it = torch.cat([torch.maximum(ftil[:, :1] + m_prev0[:, None],
                                      itil[:, :1]), itil[:, 1:]], dim=1)
    m = _maxplus_scan(ftil, it)                           # (B, S, d)
    m0 = torch.zeros_like(m[:, 0]) if m_prev0 is None else m_prev0
    m_prev = torch.cat([m0[:, None], m[:, :-1]], dim=1)
    fprime = torch.exp(ftil + m_prev - m)
    iprime = torch.exp(itil - m)
    c0 = None if cache is None else cache["c"]
    n0 = None if cache is None else cache["n"]
    c = kops.diag_scan(fprime, iprime * zf, c0)
    n = kops.diag_scan(fprime, iprime, n0)
    hval = og * c / torch.clamp(n.abs(), min=1.0)
    out = mm(hval.to(x.dtype), p["wo"])
    return out, {"c": c[:, -1], "n": n[:, -1], "m": m[:, -1]}


# --------------------------------------------------------------------------- #
# Linear Reservoir layer — the paper's model as an LM sequence mixer           #
# --------------------------------------------------------------------------- #
def init_reservoir(gen, cfg, dtype, *, n_state=None,
                   distribution="noisy_golden"):
    """LRU-style diagonal complex recurrence with a DPG spectral init.

    lambda is stored as polar (nu, theta) with |lambda| = exp(-exp(nu)) < 1;
    the input map is normalised by gamma = sqrt(1 - |lambda|^2).  As in the
    JAX package, ``b_re``/``b_im`` (and ``c_re``/``c_im``) start equal: the
    JAX init draws each pair from one key.
    """
    d = cfg.d_model
    n = n_state or d
    seed = int(torch.randint(0, 1 << 30, (), generator=gen))
    spec, _ = spectral.dpg(2 * n, 0.95, seed, distribution)
    lam = spec.lam_cpx[:n] if spec.n_cpx >= n else np.concatenate(
        [spec.lam_cpx, 0.9 * np.exp(1j * np.linspace(0.1, 3.0, n - spec.n_cpx))])
    mag = np.clip(np.abs(lam), 1e-3, 0.999)
    b = _dense_init(gen, (d, n), dtype)
    c = _dense_init(gen, (n, d), dtype)
    return {
        "nu": torch.tensor(np.log(-np.log(mag)), dtype=torch.float32),
        "theta": torch.tensor(np.angle(lam), dtype=torch.float32),
        "b_re": b, "b_im": b.clone(),
        "c_re": c, "c_im": c.clone(),
        "dskip": torch.ones((d,), dtype=dtype),
    }


def apply_reservoir(p, x, cfg, *, cache=None):
    """x: (B, S, d) -> ``(out (B, S, d), {"h_re", "h_im"} (B, N))``;
    ``cache``: the carried state ``{"h_re", "h_im"}``.

    The recurrence runs on (re, im) lanes through ``kernels.ops.
    diag_scan_lanes``: on a CUDA tensor that is always the hand-written
    kernel and its backward kernel (the counterpart of the JAX
    ``use_pallas=True`` branch), on the CPU their plain versions."""
    mag = torch.exp(-torch.exp(p["nu"]))
    a_re = mag * torch.cos(p["theta"])
    a_im = mag * torch.sin(p["theta"])
    gamma = torch.sqrt(torch.clamp(1.0 - mag * mag, min=1e-8))
    xf = x.float()
    u_re = xf @ p["b_re"].float() * gamma
    u_im = xf @ p["b_im"].float() * gamma
    h0_re = h0_im = None
    if cache is not None:
        h0_re, h0_im = cache["h_re"], cache["h_im"]
    h_re, h_im = kops.diag_scan_lanes(a_re, a_im, u_re, u_im, h0_re, h0_im)
    y = h_re @ p["c_re"].float() - h_im @ p["c_im"].float()
    out = y.to(x.dtype) + x * p["dskip"]
    return out, {"h_re": h_re[:, -1], "h_im": h_im[:, -1]}
