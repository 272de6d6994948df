"""LM building blocks of the port: norms, the SwiGLU/GELU MLP, GQA attention
(full, sliding-window or local, with RoPE and a KV cache), the MoE block
(top-k routing into per-expert capacity buffers), the recurrent mixers —
recurrentgemma's RG-LRU block, xLSTM's mLSTM and sLSTM — and the paper's
LinearReservoir layer as a sequence mixer (the JAX package's
``models/blocks.py``).

Parameters are nested dicts of tensors under the JAX package's key names,
and every ``init_*`` draws from an explicit CPU ``torch.Generator`` and
returns the params alone (``gen=None`` gives meta tensors of the same shapes
and dtypes: no memory, for the dry run).  The JAX ``init_*`` also return
sharding specs: here each has a ``*_specs`` function of its own
(:func:`moe_specs`, ...), whose tree and tuples equal JAX's
``PartitionSpec`` tree leaf for leaf.

On a device mesh (a :class:`ShardProfile` whose ``mesh`` is a
``DeviceMesh``) the params and activations are DTensors: :func:`constrain`
redistributes, as JAX's ``with_sharding_constraint`` does, and the MoE
block's expert parallelism (JAX's ``shard_map``) is a ``local_map`` body
with explicit collectives (``repro_torch.dist``).

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

from .. import dist
from ..core import spectral
from ..kernels import ops as kops
from . import attention as attn_mod

__all__ = ["ShardProfile", "NULL_PROFILE", "constrain",
           "torch_dtype", "init_norm", "norm_specs", "apply_norm", "init_mlp",
           "mlp_specs", "apply_mlp", "init_attention", "attention_specs",
           "apply_attention", "apply_attention_decode",
           "init_moe", "moe_specs", "moe_route", "apply_moe",
           "reservoir_specs", "rglru_specs", "mlstm_specs", "slstm_specs",
           "init_reservoir", "apply_reservoir", "mm", "einsum", "heads_in",
           "heads_out",
           "init_rglru_block", "apply_rglru_block", "init_mlstm",
           "apply_mlstm", "init_slstm", "apply_slstm"]


# --------------------------------------------------------------------------- #
# Sharding profile                                                             #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ShardProfile:
    """How an arch maps onto a device mesh; all-None is one device.

    ``mesh``: a ``DeviceMesh`` to run on (axes named as JAX's: ``("data",
    "model")`` or ``("pod", "data", "model")``), or any mesh with
    ``axis_names`` and ``devices.shape`` to make specs only.  ``tp``: the
    tensor-parallel axis (heads, d_ff, vocab, experts, recurrent state);
    ``fsdp``: the weight-sharding axis; ``dp``: the batch axes; ``seq``:
    the sequence-parallel axis of the residual stream."""
    mesh: Optional[Any] = None
    tp: Optional[str] = None
    fsdp: Optional[str] = None
    dp: tuple = ()
    tp_size: int = 1
    seq: Optional[str] = None

    def axis(self, name):
        return name if self.mesh is not None else None

    @property
    def dp_spec(self):
        return self.dp if self.dp else None


NULL_PROFILE = ShardProfile()


def _tp_dim(prof: ShardProfile, size: int):
    """The tp axis name iff ``size`` divides evenly over it, else None."""
    if prof.tp and size % prof.tp_size == 0:
        return prof.tp
    return None


def _fsdp_dim(prof: ShardProfile, size: int):
    if prof.fsdp and prof.mesh is not None:
        if size % dist.mesh_axes(prof.mesh)[prof.fsdp] == 0:
            return prof.fsdp
    return None


def constrain(x, spec, prof: ShardProfile):
    """JAX's ``with_sharding_constraint``: on a mesh, ``x`` (a DTensor)
    redistributed to ``spec``'s placements — the values stay, the layout
    moves; the identity without a mesh."""
    if prof.mesh is None:
        return x
    if not dist.is_dtensor(x):
        raise TypeError(f"a sharded profile constrains DTensors, got "
                        f"{type(x).__name__}")
    return x.redistribute(prof.mesh, dist.spec_placements(
        spec, prof.mesh.mesh_dim_names))


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


def heads_in(eq, x, w):
    """``einsum(eq, x, w)`` for a projection of ``x`` (B, S, d) onto heads,
    ``w`` (d, H, ...) -> (B, H, S, ...).  On a mesh it is a ``local_map``
    body (Megatron's column-parallel linear): ``x`` split over the batch
    only, ``w`` over its heads where they are split (an FSDP split of d is
    gathered), the output split as both; ``x``'s gradient is partial over
    a head split, ``w``'s over a batch split.  DTensor's own einsum may
    split the flattened heads x head-dim unevenly across heads and then
    fail to unflatten it (KV heads that do not divide the tp axis)."""
    if not dist.is_dtensor(w):
        return einsum(eq, x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    x_pl = [Shard(0) if p == Shard(0) else Replicate() for p in x.placements]
    w_pl = [Shard(1) if p == Shard(1) else Replicate() for p in w.placements]
    out = [Shard(0) if a == Shard(0) else Shard(1) if b == Shard(1)
           else Replicate() for a, b in zip(x_pl, w_pl)]
    x_grad = [Partial() if b == Shard(1) else a for a, b in zip(x_pl, w_pl)]
    w_grad = [Partial() if a == Shard(0) else b for a, b in zip(x_pl, w_pl)]
    return local_map(lambda x, w: einsum(eq, x, w), out_placements=out,
                     in_placements=(x_pl, w_pl),
                     in_grad_placements=(x_grad, w_grad),
                     device_mesh=w.device_mesh, redistribute_inputs=True)(x, w)


def heads_out(o, wo):
    """``einsum("bhsk,hkd->bsd", o, wo)``: the heads merged back into d
    (Megatron's row-parallel linear on a mesh: a partial sum over a head
    split, reduced where the residual sum is made)."""
    if not dist.is_dtensor(wo):
        return einsum("bhsk,hkd->bsd", o, wo)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    w_pl = [Shard(0) if p == Shard(0) else Replicate() for p in wo.placements]
    o_pl = [Shard(0) if a == Shard(0) else Shard(1) if b == Shard(0)
            else Replicate() for a, b in zip(o.placements, w_pl)]
    out = [Partial() if b == Shard(0) else a for a, b in zip(o_pl, w_pl)]
    w_grad = [Partial() if a == Shard(0) and b != Shard(0) else b
              for a, b in zip(o_pl, w_pl)]
    return local_map(lambda o, w: einsum("bhsk,hkd->bsd", o, w),
                     out_placements=out, in_placements=(o_pl, w_pl),
                     in_grad_placements=(o_pl, w_grad),
                     device_mesh=wo.device_mesh,
                     redistribute_inputs=True)(o, wo)


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


def norm_specs(kind="rmsnorm"):
    """The specs of :func:`init_norm`'s tree: replicated."""
    if kind == "rmsnorm":
        return {"scale": (None,)}
    return {"scale": (None,), "bias": (None,)}


def apply_norm(p, x, kind="rmsnorm", eps=1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        nrm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (nrm * p["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    nrm = (xf - mu) * torch.rsqrt(var + eps)
    return (nrm * p["scale"].float() + p["bias"].float()).to(x.dtype)


def randn(gen, shape):
    """float32 normal draws from the CPU generator ``gen``; ``gen=None``: a
    meta tensor of the shape (no memory: the dry run's abstract params)."""
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def _dense_init(gen, shape, dtype, scale=None):
    scale = (1.0 / math.sqrt(shape[0])) if scale is None else scale
    return (randn(gen, shape) * scale).to(dtype)


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


def mlp_specs(d, f, prof: ShardProfile, gated=True, bias=False):
    """:func:`init_mlp`'s specs: d_ff over tp, d over fsdp."""
    tp_f = _tp_dim(prof, f)
    fs = _fsdp_dim(prof, d)
    s = {"wi": (fs, tp_f), "wo": (tp_f, fs)}
    if gated:
        s["wg"] = (fs, tp_f)
    if bias:
        s["bi"] = (tp_f,)
        s["bo"] = (None,)
    return s


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


def attention_specs(cfg, prof: ShardProfile):
    """:func:`init_attention`'s specs: query heads over tp where they
    divide; KV heads over tp only where both head counts divide (else
    replicated: Megatron-style KV duplication); d over fsdp."""
    tp_h = _tp_dim(prof, cfg.n_heads)
    tp_kv = _tp_dim(prof, cfg.n_kv)
    fs = _fsdp_dim(prof, cfg.d_model)
    kv_h = tp_kv if (tp_kv and tp_h) else None
    kv_spec = (fs, kv_h, None)
    s = {"wq": (fs, tp_h, None), "wk": kv_spec, "wv": kv_spec,
         "wo": (tp_h, None, fs)}
    if cfg.qkv_bias:
        s["bq"] = (tp_h, None)
        s["bk"] = (kv_h, None)
        s["bv"] = s["bk"]
    return s


def _qkv(p, x, rope_theta, positions):
    q = heads_in("bsd,dhk->bhsk", x, p["wq"])
    k = heads_in("bsd,dhk->bhsk", x, p["wk"])
    v = heads_in("bsd,dhk->bhsk", x, p["wv"])
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
    return heads_out(o, p["wo"]), (k, v)


def apply_attention_decode(p, x, cfg, cache, *, window=None):
    """x: (B, 1, d); cache ``{"k", "v"}`` (B, Hkv, S, hd) and ``"len"`` (a
    0-d int tensor).  Returns ``(out, new_cache)``; the cache is not
    modified in place.

    When the cache is window-sized (a ring buffer: long-context decode of
    sliding-window or local attention), writes wrap modulo its length.  RoPE
    is applied at the absolute position before caching, so ring order does
    not matter.  As JAX's ``dynamic_update_slice``, a write past the end of
    a linear cache lands on its last slot.  A DTensor cache (on a mesh)
    takes ``attention.decode_attention_sharded``: split over its sequence,
    as ``lm.cache_specs`` places it."""
    cur = cache["len"]
    smax = cache["k"].shape[2]
    ring = window is not None and smax <= window
    q, k_new, v_new = _qkv(p, x, cfg.rope_theta, cur.reshape(1))
    if dist.is_dtensor(cache["k"]):
        o, k_cache, v_cache = attn_mod.decode_attention_sharded(
            q, k_new, v_new, cache["k"], cache["v"], cur, window=window,
            ring=ring)
        out = heads_out(o, p["wo"])
        return out, {"k": k_cache, "v": v_cache, "len": cur + 1}
    slot = torch.remainder(cur, smax) if ring else cur.clamp(0, smax - 1)
    slot = slot.reshape(1).long()
    k_cache = cache["k"].index_copy(2, slot, k_new.to(cache["k"].dtype))
    v_cache = cache["v"].index_copy(2, slot, v_new.to(cache["v"].dtype))
    o = attn_mod.decode_attention(q, k_cache, v_cache, cur + 1, window=window,
                                  ring=ring)
    out = heads_out(o, p["wo"])
    return out, {"k": k_cache, "v": v_cache, "len": cur + 1}


# --------------------------------------------------------------------------- #
# Mixture of Experts (expert parallelism over the tp axis on a mesh)           #
# --------------------------------------------------------------------------- #
def init_moe(gen, cfg, dtype):
    """A float32 ``router`` (d, E) beside the experts' ``wg`` / ``wu`` (E, d,
    F) and ``wd`` (E, F, d) in ``dtype``, as the JAX ``init_moe``."""
    d, f, e = cfg.d_model, cfg.moe_ff, cfg.n_experts
    return {"router": _dense_init(gen, (d, e), torch.float32),
            "wg": _dense_init(gen, (e, d, f), dtype),
            "wu": _dense_init(gen, (e, d, f), dtype),
            "wd": _dense_init(gen, (e, f, d), dtype)}


def moe_specs(cfg, prof: ShardProfile):
    """:func:`init_moe`'s specs: experts over tp, the expert width over
    fsdp, the router replicated."""
    ep = _tp_dim(prof, cfg.n_experts)
    fs = _fsdp_dim(prof, cfg.moe_ff)
    return {"router": (None, None), "wg": (ep, None, fs),
            "wu": (ep, None, fs), "wd": (ep, fs, None)}


def moe_route(x2d, router, *, top_k, capacity, e_local, e_offset=0):
    """The router and the capacity dispatch of :func:`_moe_local`: float32
    logits and softmax, the top ``top_k`` experts of each token with their
    weights renormalised to sum 1, and each assignment's slot in its
    expert's buffer of ``capacity`` rows.

    The experts held here are ``e_offset .. e_offset + e_local - 1`` (all of
    them off a mesh); an assignment to another expert is not kept.  The
    slot is the running count of earlier assignments to the same expert in
    token-major ``(T·k)`` order — the JAX package's ``cumsum`` over a
    one-hot — so an assignment past ``capacity`` is dropped exactly where
    JAX drops it.  Returns ``(logits (T, E), probs, top_w (T, k), top_e (T,
    k), slot (T·k,), keep (T·k,))``; an assignment not kept has ``slot``
    ``e_local * capacity`` (the drop row)."""
    logits = x2d.float() @ router
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    local = top_e.reshape(-1) - e_offset
    is_local = (local >= 0) & (local < e_local)
    col = torch.where(is_local, local, e_local)
    running = F.one_hot(col, e_local + 1).cumsum(0)
    pos = running.gather(1, col[:, None])[:, 0] - 1
    keep = is_local & (pos < capacity)
    slot = torch.where(keep, col * capacity + pos, e_local * capacity)
    return logits, probs, top_w, top_e, slot, keep


def _moe_local(x2d, router, wg, wu, wd, *, top_k, capacity, e_total,
               e_offset=0, act="silu"):
    """Dispatch the tokens ``x2d`` (T, d) against the experts ``w*``
    (E_local, ...) numbered from ``e_offset``: gather each expert's kept
    tokens into its (capacity, d) buffer, run the gated expert MLPs as
    batched products, and add each token's ``top_k`` outputs back,
    weighted, one k at a time — each sum rounds to ``x2d``'s dtype, as
    JAX's loop does.  A token routed to an expert held elsewhere adds zero
    here (the expert-parallel caller sums over the shards).  Returns
    ``(out (T, d), {"load_balance", "router_z"})``, the aux losses float32
    over the full router."""
    t, d = x2d.shape
    e_local = wg.shape[0]
    logits, probs, top_w, top_e, slot, keep = moe_route(
        x2d, router, top_k=top_k, capacity=capacity, e_local=e_local,
        e_offset=e_offset)
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
    """x: (B, S, d) -> ``(out (B, S, d), aux)``.

    Off a mesh: every token against every expert, with the JAX package's
    capacity ``int(capacity_factor * B * S * top_k / E) + 1``.  On a mesh
    whose tp axis divides E: expert parallelism (:func:`_moe_ep`).  A mesh
    whose tp axis does not divide E (no registered config at the
    production mesh) raises ``ValueError``: JAX leaves that case to GSPMD,
    and the port does not gather the experts whole on every rank."""
    b, s, d = x.shape
    e_total = cfg.n_experts
    if prof.mesh is None:
        cap = int(cfg.capacity_factor * b * s * cfg.top_k / e_total) + 1
        out, aux = _moe_local(x.reshape(b * s, d), p["router"], p["wg"],
                              p["wu"], p["wd"], top_k=cfg.top_k, capacity=cap,
                              e_total=e_total, act=cfg.act)
        return out.reshape(b, s, d), aux
    check_moe_mesh(cfg, prof)
    return _moe_ep(p, x, cfg, prof)


def check_moe_mesh(cfg, prof: ShardProfile) -> None:
    """Raise ``ValueError`` where :func:`apply_moe` cannot run ``cfg`` on
    ``prof``'s mesh: a tp axis that does not divide the experts."""
    if prof.mesh is not None and _tp_dim(prof, cfg.n_experts) is None:
        raise ValueError(f"expert parallelism needs the tp axis to divide "
                         f"the experts: tp {prof.tp!r} of size "
                         f"{prof.tp_size} against E = {cfg.n_experts}")


def _moe_ep(p, x, cfg, prof):
    """Expert parallelism, JAX's ``shard_map`` body as a ``local_map``
    body.  Tokens are split over the batch axes ``prof.dp`` and whole on
    every tp rank; experts are split over tp (rank ``i`` holds experts
    ``i·E/tp ..``).  Capacity (so token dropping) is shard-local, as on a
    real EP fleet: ``int(cf * T_local * k / E) + 1``.  Each rank's output
    is its experts' share, summed over tp — or, when ``prof.seq`` is the
    tp axis and divides the sequence, reduce-scattered over it along the
    sequence, so it lands in the residual stream's sequence-split layout
    ``(dp, tp, None)`` (JAX scatters the flattened token rows, which
    DTensor cannot express for a (B, S, d) tensor; the values are the
    same) — and the aux losses are averaged over the batch and tp axes.  The
    expert weights enter whole over the fsdp axis (each layer's FSDP
    all-gather).

    Gradients: a rank's token and router gradients are partial over tp
    (its experts' terms) and the router's and experts' partial over the
    batch axes (its tokens' terms), which ``in_grad_placements`` tells
    DTensor; ``dist.psum`` passes the whole cotangent to each partial."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = prof.mesh
    axes = dist.mesh_axes(mesh)
    b, s, d = x.shape
    e_total, tp, tp_size = cfg.n_experts, prof.tp, prof.tp_size
    dp = tuple(prof.dp)
    t_local = (b * s) // math.prod(axes[a] for a in dp)
    cap = int(cfg.capacity_factor * t_local * cfg.top_k / e_total) + 1
    use_scatter = prof.seq == tp and s % tp_size == 0

    def per_axis(on_tp, on_dp, other):
        return [on_tp if a == tp else on_dp if a in dp else other
                for a in axes]
    x_in = per_axis(Replicate(), Shard(0), Replicate())
    w_in = per_axis(Shard(0), Replicate(), Replicate())
    rep = per_axis(Replicate(), Replicate(), Replicate())
    x_grad = per_axis(Partial(), Shard(0), Replicate())
    r_grad = per_axis(Partial(), Partial(), Replicate())
    w_grad = per_axis(Shard(0), Partial(), Replicate())
    out_pl = per_axis(Shard(1) if use_scatter else Replicate(), Shard(0),
                      Replicate())

    def shard_fn(x, router, wg, wu, wd):
        e_local = e_total // tp_size
        out, aux = _moe_local(x.reshape(-1, d), router, wg, wu, wd,
                              top_k=cfg.top_k, capacity=cap, e_total=e_total,
                              e_offset=dist.axis_index(mesh, tp) * e_local,
                              act=cfg.act)
        out = out.reshape(x.shape)
        if use_scatter:
            out = dist.psum_scatter(out, mesh, tp, dim=1)
        else:
            out = dist.psum(out, mesh, (tp,))
        return (out, dist.pmean(aux["load_balance"], mesh, dp + (tp,)),
                dist.pmean(aux["router_z"], mesh, dp + (tp,)))

    fn = local_map(shard_fn, out_placements=(out_pl, rep, rep),
                   in_placements=(x_in, rep, w_in, w_in, w_in),
                   in_grad_placements=(x_grad, r_grad, w_grad, w_grad,
                                       w_grad),
                   device_mesh=mesh, redistribute_inputs=True)
    out, lb, rz = fn(x, p["router"], p["wg"], p["wu"], p["wd"])
    return out, {"load_balance": lb, "router_z": rz}


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
        "conv": (randn(gen, (cfg.conv_width, dr)) * 0.1).to(dtype),
        "w_a": _dense_init(gen, (dr, dr), dtype),
        "b_a": torch.zeros((dr,), dtype=dtype),
        "w_i": _dense_init(gen, (dr, dr), dtype),
        "b_i": torch.zeros((dr,), dtype=dtype),
        "lam_p": torch.tensor(lam_p, dtype=torch.float32),
        "w_out": _dense_init(gen, (dr, d), dtype),
    }


def rglru_specs(cfg, prof: ShardProfile):
    """:func:`init_rglru_block`'s specs: d_rnn over tp (the recurrence runs
    on each rank's own lanes), d over fsdp."""
    tp_r = _tp_dim(prof, cfg.d_rnn)
    fs = _fsdp_dim(prof, cfg.d_model)
    return {"w_x": (fs, tp_r), "w_gate": (fs, tp_r), "conv": (None, tp_r),
            "w_a": (None, tp_r), "b_a": (tp_r,), "w_i": (None, tp_r),
            "b_i": (tp_r,), "lam_p": (tp_r,), "w_out": (tp_r, fs)}


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


def _rglru_core(p, xr, h0=None, *, step=False, prof=NULL_PROFILE):
    """xr: (B, S, dr) after the conv.  Returns ``(states (B, S, dr) in xr's
    dtype, last state (B, dr) float32)``.  The gates are float32; the scan
    is ``kernels.ops.diag_scan`` with per-timestep ``a`` (B, S, dr), whose
    gradient reaches the gates; ``step`` (one decode token against ``h0``)
    takes the single update instead, as the JAX decode fast path does.

    On a mesh the (dr, dr) gate products take their input gathered over tp
    (JAX's constraint: one gather of the input in place of reducing both
    gates' pre-activations) and give dr-sharded gates, so the recurrence
    stays on each rank's lanes."""
    xg = constrain(xr, (prof.dp_spec, None, None), prof)
    r = torch.sigmoid(mm(xg, p["w_a"]) + p["b_a"]).float()
    i = torch.sigmoid(mm(xg, p["w_i"]) + p["b_i"]).float()
    log_a = -RGLRU_C * r * F.softplus(p["lam_p"])       # (B, S, dr), <= 0
    a = torch.exp(log_a)
    gated_x = (i * xr.float()) * torch.sqrt(
        torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    if step:
        h = a * h0[:, None] + gated_x
    else:
        h = kops.diag_scan(a, gated_x, h0)
    return h.to(xr.dtype), h[:, -1]


def apply_rglru_block(p, x, cfg, *, cache=None, prof=NULL_PROFILE):
    """Griffin-style recurrent block: x (B, S, d) -> ``(out, {"conv": (B,
    W-1, dr), "h": (B, dr) float32})``; ``cache`` carries both in (decode:
    one token, one sequential step, no kernel)."""
    xr = mm(x, p["w_x"])
    gate = _ACTS["gelu"](mm(x, p["w_gate"]))
    xc, new_conv = _causal_conv(xr, p["conv"],
                                None if cache is None else cache["conv"])
    h0 = None if cache is None else cache["h"]
    hs, last = _rglru_core(p, xc, h0,
                           step=cache is not None and x.shape[1] == 1,
                           prof=prof)
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


def mlstm_specs(cfg, prof: ShardProfile):
    """:func:`init_mlstm`'s specs: heads over tp."""
    tp_h = _tp_dim(prof, cfg.n_heads)
    return {"wq": (None, tp_h, None), "wk": (None, tp_h, None),
            "wv": (None, tp_h, None), "wi": (None, tp_h), "wf": (None, tp_h),
            "bf": (tp_h,), "wo": (tp_h, None, None)}


def apply_mlstm(p, x, cfg, *, cache=None, chunk=64):
    """Chunkwise mLSTM: C_t = f_t C + i_t k v^T; h = C^T q / max(|n.q|, 1),
    with the JAX package's sigmoid input gate.  Plain PyTorch (the JAX
    package has no kernel for it): one step of the chunk loop per ``chunk``
    tokens, one chunk when ``S % chunk != 0`` (decode: S = 1).  ``cache``:
    ``{"C": (B, H, hd, hd), "n": (B, H, hd)}`` float32."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    q = heads_in("bsd,dhk->bhsk", x, p["wq"]).float() * hd ** -0.5
    k = heads_in("bsd,dhk->bhsk", x, p["wk"]).float()
    v = heads_in("bsd,dhk->bhsk", x, p["wv"]).float()
    ig = torch.sigmoid(heads_in("bsd,dh->bhs", x, p["wi"])).float()
    fg = torch.sigmoid(heads_in("bsd,dh->bhs", x, p["wf"])
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
    out = heads_out(hs.to(x.dtype), p["wo"])
    return out, {"C": C, "n": n}


def init_slstm(gen, cfg, dtype):
    d = cfg.d_model
    return {"wz": _dense_init(gen, (d, d), dtype),
            "wi": _dense_init(gen, (d, d), dtype),
            "wf": _dense_init(gen, (d, d), dtype),
            "bf": torch.full((d,), 3.0, dtype=dtype),
            "wog": _dense_init(gen, (d, d), dtype),
            "wo": _dense_init(gen, (d, d), dtype)}


def slstm_specs(cfg, prof: ShardProfile):
    """:func:`init_slstm`'s specs: the cell (d) over tp."""
    tp_d = _tp_dim(prof, cfg.d_model)
    return {"wz": (None, tp_d), "wi": (None, tp_d), "wf": (None, tp_d),
            "bf": (tp_d,), "wog": (None, tp_d), "wo": (tp_d, None)}


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
    ftil = dist.elementwise(F.logsigmoid,
                            (mm(x, p["wf"]) + p["bf"]).float())
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
    # A fixed seed for the shape-only init, as JAX's under tracing.
    seed = 0 if gen is None else int(torch.randint(0, 1 << 30, (),
                                                   generator=gen))
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


def reservoir_specs(cfg, prof: ShardProfile, *, n_state=None):
    """:func:`init_reservoir`'s specs: the state N over tp."""
    tp_n = _tp_dim(prof, n_state or cfg.d_model)
    return {"nu": (tp_n,), "theta": (tp_n,), "b_re": (None, tp_n),
            "b_im": (None, tp_n), "c_re": (tp_n, None), "c_im": (tp_n, None),
            "dskip": (None,)}


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
