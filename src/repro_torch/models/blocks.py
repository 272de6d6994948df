"""LM building blocks of the port: norms, the SwiGLU/GELU MLP, GQA attention
(full, sliding-window or local, with RoPE and a KV cache) and the paper's
LinearReservoir layer as a sequence mixer (the JAX package's
``models/blocks.py``, reduced to what the attention and reservoir LMs need).

Parameters are nested dicts of tensors under the JAX package's key names,
and every ``init_*`` draws from an explicit CPU ``torch.Generator`` and
returns the params alone (the JAX ``init_*`` also return sharding specs: the
port runs on one device, ROADMAP A11).  The MoE, RG-LRU, mLSTM and sLSTM
blocks are not ported yet: :func:`not_ported` raises for them, naming
ROADMAP A12.
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

__all__ = ["ShardProfile", "NULL_PROFILE", "constrain", "not_ported",
           "torch_dtype", "init_norm", "apply_norm", "init_mlp", "apply_mlp",
           "init_attention", "apply_attention", "apply_attention_decode",
           "init_reservoir", "apply_reservoir"]


def not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP A12 (the "
                              f"MoE, RG-LRU, xLSTM and encoder-decoder "
                              f"blocks)")


# --------------------------------------------------------------------------- #
# Sharding profile                                                             #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ShardProfile:
    """How an arch maps onto a device mesh; all-None is one device, the only
    layout the port runs (a mesh is ROADMAP A11)."""
    mesh: Optional[Any] = None
    tp: Optional[str] = None
    fsdp: Optional[str] = None
    dp: tuple = ()
    tp_size: int = 1
    seq: Optional[str] = None


NULL_PROFILE = ShardProfile()


def constrain(x, spec, prof: ShardProfile):
    """A sharding constraint: the identity on one device."""
    if prof.mesh is not None:
        raise NotImplementedError("sharded layouts are not ported yet: "
                                  "ROADMAP A11")
    return x


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
    h = x @ p["wi"]
    if "bi" in p:
        h = h + p["bi"]
    a = _ACTS[act]
    h = a(x @ p["wg"]) * h if gated else a(h)
    out = h @ p["wo"]
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
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bhsk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bhsk", x, p["wv"])
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
    return torch.einsum("bhsk,hkd->bsd", o, p["wo"]), (k, v)


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
    out = torch.einsum("bhsk,hkd->bsd", o, p["wo"])
    return out, {"k": k_cache, "v": v_cache, "len": cur + 1}


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
