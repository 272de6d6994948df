"""Optimizers as plain functions on tensor trees (the JAX package's
``train/optimizer.py``): AdamW (float32 moments) and Adafactor (factored
second moments), global-norm clipping and the cosine schedule.

The API is the JAX package's — ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``, ``apply_updates`` —
with the state under its key names (``m``, ``v``, ``step``; ``f/<leaf>/vr``,
``vc``, ``v``), so checkpoints carry over key for key.  ``torch.optim`` is
not used: its update rule and state layout differ.  Updates are functional:
new tensors, nothing is modified in place.

On a device mesh the params, gradients and state are DTensors, each state
leaf placed as ``sharding.rules.opt_state_specs`` says: AdamW's moments as
their params, Adafactor's ``vr`` / ``vc`` as their params less the
factored dim (a mesh dim that split it holds the factor whole), the step
replicated.  The global norm and Adafactor's means are DTensor reductions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from .. import dist
from ..tree import tree_leaves, tree_map

__all__ = ["global_norm", "clip_by_global_norm", "cosine_schedule", "AdamW",
           "Adafactor", "apply_updates", "make_optimizer"]


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _clip_scale(grads, max_norm):
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def _clip_leaf(g, scale):
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm):
    scale, norm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: _clip_leaf(g, scale), grads), norm


# --------------------------------------------------------------------------- #
# Schedules                                                                    #
# --------------------------------------------------------------------------- #
def cosine_schedule(base_lr, warmup_steps, total_steps, min_ratio=0.1):
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(step < warmup_steps, warm, cos)
    return fn


def _lr(lr, step):
    return lr(step) if callable(lr) else lr


def _step0(params):
    """The step counter at 0: on the params' device, replicated on their
    mesh when they are DTensors."""
    leaf = tree_leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=leaf.device)
    if dist.is_dtensor(leaf):
        step = dist.place(step, (), leaf.device_mesh)
    return step


def _zeros_without(p, dim):
    """float32 zeros shaped as ``p`` less its dim ``dim`` (negative); for a
    DTensor ``p``, placed as ``p`` with that dim dropped (a mesh dim that
    split it holds the result whole)."""
    shape = p.shape[:dim] + p.shape[dim + 1:] if dim != -1 else p.shape[:-1]
    if not dist.is_dtensor(p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    cut = p.ndim + dim
    pl = []
    for q in p.placements:
        if isinstance(q, Shard) and q.dim == cut:
            pl.append(Replicate())
        elif isinstance(q, Shard) and q.dim > cut:
            pl.append(Shard(q.dim - 1))
        else:
            pl.append(q)
    return distribute_tensor(
        torch.zeros(shape, dtype=torch.float32, device=p.to_local().device),
        p.device_mesh, pl, src_data_rank=None)


def _as(v, like):
    """``v`` redistributed to ``like``'s placements (a DTensor state leaf
    keeps its placements across updates); ``v`` itself off a mesh."""
    if dist.is_dtensor(like) and v.placements != like.placements:
        return v.redistribute(like.device_mesh, like.placements)
    return v


# --------------------------------------------------------------------------- #
# AdamW                                                                        #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Any = 3e-4                    # float or schedule fn
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params):
        def z(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "step": _step0(params)}

    def update(self, grads, state, params):
        """One leaf at a time: a gradient is clipped, folded into its
        moments and turned into its update before the next leaf, so no
        clipped copy of the gradient tree is held (each float32 tree of
        recurrentgemma-2b at 9 layers is 8.3 GB).  The arithmetic is
        ``clip_by_global_norm``'s, then the moments', unchanged."""
        scale = _clip_scale(grads, self.clip_norm)[0] if self.clip_norm \
            else None
        step = state["step"] + 1
        lr = _lr(self.lr, step)
        b1, b2 = self.b1, self.b2
        t = step.float()
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)

        def one(g, m, v, p):
            if scale is not None:
                g = _clip_leaf(g, scale)
            m = b1 * m + (1 - b1) * g.float()
            v = b2 * v + (1 - b2) * torch.square(g.float())
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            return m, v, (-lr * u).to(p.dtype)

        out = tree_map(one, grads, state["m"], state["v"], params)

        def part(i):
            return tree_map(lambda mvu: mvu[i], out)
        return part(2), {"m": part(0), "v": part(1), "step": step}


# --------------------------------------------------------------------------- #
# Adafactor (factored second moments, no first moment)                         #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: Any = 1e-3
    decay: float = 0.8       # t^-decay second-moment running rate
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def init(self, params):
        def one(p):
            if p.ndim >= 2:
                # Factor the trailing two dims; leading dims (layer stacks)
                # ride along.
                return {"vr": _zeros_without(p, -1),
                        "vc": _zeros_without(p, -2)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"f": tree_map(one, params), "step": _step0(params)}

    def update(self, grads, state, params):
        step = state["step"] + 1
        t = step.float()
        beta = 1.0 - t ** (-self.decay)
        lr = _lr(self.lr, step)

        def one(g, f, p):
            gf = g.float()
            g2 = torch.square(gf) + self.eps
            if p.ndim >= 2:
                vr = beta * f["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * f["vc"] + (1 - beta) * g2.mean(-2)
                mean_r = torch.clamp(vr.mean(-1, keepdim=True), min=self.eps)
                u = gf / (torch.sqrt(vr / mean_r)[..., :, None]
                          * torch.sqrt(vc)[..., None, :])
                newf = {"vr": _as(vr, f["vr"]), "vc": _as(vc, f["vc"])}
            else:
                v = beta * f["v"] + (1 - beta) * g2
                u = gf / torch.sqrt(v)
                newf = {"v": _as(v, f["v"])}
            rms = torch.sqrt(torch.mean(torch.square(u)))
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (-lr * u).to(p.dtype), newf

        # The factored state is one dict deeper than the params: walk the
        # params' tree and hand each leaf its state dict.  The result's
        # leaves are (update, state) tuples.
        pairs = _zip_leaves(one, grads, state["f"], params)
        return (tree_map(lambda pr: pr[0], pairs),
                {"f": tree_map(lambda pr: pr[1], pairs), "step": step})


def _zip_leaves(fn, grads, fstate, params):
    if isinstance(params, dict):
        return {k: _zip_leaves(fn, grads[k], fstate[k], params[k])
                for k in params}
    return fn(grads, fstate, params)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def make_optimizer(name: str, lr=3e-4, **kw):
    if name == "adamw":
        return AdamW(lr=lr, **kw)
    if name == "adafactor":
        return Adafactor(lr=lr, **kw)
    raise ValueError(name)
