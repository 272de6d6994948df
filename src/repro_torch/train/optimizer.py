"""Optimizers as plain functions on tensor trees (the JAX package's
``train/optimizer.py``): AdamW (float32 moments) and Adafactor (factored
second moments), global-norm clipping and the cosine schedule.

The API is the JAX package's — ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``, ``apply_updates`` —
with the state under its key names (``m``, ``v``, ``step``; ``f/<leaf>/vr``,
``vc``, ``v``), so checkpoints carry over key for key.  ``torch.optim`` is
not used: its update rule and state layout differ.  Updates are functional:
new tensors, nothing is modified in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

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
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "step": step}

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
            kw = dict(dtype=torch.float32, device=p.device)
            if p.ndim >= 2:
                # Factor the trailing two dims; leading dims (layer stacks)
                # ride along.
                return {"vr": torch.zeros(p.shape[:-1], **kw),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
            return {"v": torch.zeros(p.shape, **kw)}
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return {"f": tree_map(one, params), "step": step}

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
                newf = {"vr": vr, "vc": vc}
            else:
                v = beta * f["v"] + (1 - beta) * g2
                u = gf / torch.sqrt(v)
                newf = {"v": v}
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
