"""Placement of a serving slot arena on a ``(data, model)`` device mesh.

The serving half of ``repro.sharding.rules``: :class:`ArenaPlan`,
:func:`_axis_or_none` and :func:`plan_arena`, rule for rule.  **Slots ride
the data axis, N rides the model axis**, each only where it divides evenly
and the axis has more than one device.  Diag mode splits the state,
``lam_q`` and the Q-transformed input maps over ``model`` (the step is
element-wise in N: no per-step communication); standard mode splits the
columns of ``W``, ``w_in`` and ``w_fb`` over ``model`` and keeps the states
whole on every model shard.  A param batch leads with ``data``; the readout
is replicated, a batched readout split over ``data`` on its leading axis.

Each leaf's placement is a :class:`Sharding` — the mesh and a ``spec``, one
axis name or ``None`` per tensor dim: JAX's ``NamedSharding(mesh,
PartitionSpec(*spec))`` in plain Python, so the two packages' plans
compare leaf by leaf.  Where a cut of the packed Q basis (``lam_q`` is
``[reals | re1, im1, re2, im2, ...]``, ``core.scan.pack_lambda_q``) falls
inside an (re, im) pair, the plan moves it one column on so that every
pair stays whole and each model shard is a packed-Q problem of its own
(``ArenaPlan.n_real``); the specs are JAX's all the same.

The training and LM side of the JAX module (``plan_cell``,
``make_profile``, the step builders) is ROADMAP A2.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["Sharding", "ArenaPlan", "plan_arena"]


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """A leaf's placement: ``spec[d]`` names the mesh axis dim ``d`` is
    split over, or is ``None`` (replicated).  ``bounds`` maps a split axis
    to its cut offsets (``len`` = axis size + 1; even cuts unless the plan
    moved one to keep a packed (re, im) pair whole)."""
    mesh: Any
    spec: Tuple[Optional[str], ...]
    bounds: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)

    def _index(self, i: int, j: int, ndim: int):
        cell = {"data": i, "model": j}
        idx = []
        for d in range(ndim):
            ax = self.spec[d] if d < len(self.spec) else None
            if ax is None:
                idx.append(slice(None))
            else:
                b = self.bounds[ax]
                idx.append(slice(b[cell[ax]], b[cell[ax] + 1]))
        return tuple(idx)

    def split(self, tensor: torch.Tensor) -> np.ndarray:
        """The shards of ``tensor`` on their devices: an object array shaped
        like the mesh, cell ``(i, j)`` on ``mesh.devices[i, j]`` (a
        replicated dim whole in every cell)."""
        grid = self.mesh.devices
        out = np.empty(grid.shape, dtype=object)
        for i in range(grid.shape[0]):
            for j in range(grid.shape[1]):
                out[i, j] = tensor[self._index(i, j, tensor.ndim)].to(
                    grid[i, j]).contiguous()
        return out

    def join(self, shards: np.ndarray, device) -> torch.Tensor:
        """Reassemble :meth:`split`'s shards on ``device``: split dims
        concatenated in shard order (model within each data row, then the
        data rows), replicated axes read from their first shard."""
        def along(ax, parts):
            if ax not in self.spec:
                return parts[0]
            return torch.cat(parts, self.spec.index(ax))
        rows = [along("model", [s.to(device) for s in shards[i]])
                for i in range(shards.shape[0])]
        return along("data", rows)


@dataclasses.dataclass(frozen=True)
class ArenaPlan:
    """Placements for one serving arena: ``arena`` (``states``, ``y_prev``,
    ``active``), ``params`` (a param struct of :class:`Sharding`),
    ``readout`` (the bare ``w_out``, or None).  Beside JAX's fields: the
    cut offsets of both axes (``row_bounds``, ``col_bounds``: one shard
    spanning everything on an axis the plan leaves replicated) and each
    model shard's ``n_real`` (diag mode)."""
    mesh: Any
    arena: Any
    params: Any
    readout: Any
    row_bounds: Tuple[int, ...] = (0,)
    col_bounds: Tuple[int, ...] = (0,)
    n_real: Tuple[int, ...] = (0,)


def _axis_or_none(extent: int, name: str, size: int):
    """Shard ``extent`` over mesh axis ``name`` only when it divides evenly
    (and the axis exists with >1 devices); otherwise replicate.  Correctness
    never depends on the placement — an indivisible axis just stays
    local."""
    return name if size > 1 and extent % size == 0 else None


def _pair_cuts(n: int, size: int, n_real: int) -> Tuple[int, ...]:
    """Even cuts of ``n`` packed-Q columns over ``size`` shards, each cut
    that falls between the re and im of a pair moved one column on."""
    cuts = []
    for k in range(size + 1):
        c = k * n // size
        if n_real < c < n and (c - n_real) % 2 == 1:
            c += 1
        cuts.append(c)
    return tuple(cuts)


def plan_arena(mesh, params, max_slots: int, *, batched: bool = False,
               readout=None) -> ArenaPlan:
    """Place a ``(max_slots, N)`` slot arena (and its reservoir params) on a
    ``(data, model)`` mesh: **slots ride the data axis, N rides the model
    axis** (the rules of ``repro.sharding.rules.plan_arena``)."""
    sizes = mesh.shape
    dsz, msz = sizes.get("data", 1), sizes.get("model", 1)
    cfg = params.cfg
    dp = _axis_or_none(max_slots, "data", dsz)
    tp = _axis_or_none(cfg.n, "model", msz)
    diag = params.mode == "diag"
    n_real = int(getattr(params, "n_real", 0))
    rows = (tuple(k * max_slots // dsz for k in range(dsz + 1)) if dp
            else (0, max_slots))
    if tp is None:
        cols = (0, cfg.n)
    elif diag:
        cols = _pair_cuts(cfg.n, msz, n_real)
    else:
        cols = tuple(k * cfg.n // msz for k in range(msz + 1))
    bounds = {"data": rows, "model": cols}

    def sh(*spec):
        return Sharding(mesh, tuple(spec), bounds)

    arena_sh = {
        "states": sh(dp, tp if diag else None),
        "y_prev": sh(dp, None),
        "active": sh(dp),
    }
    lead = (dp,) if batched else ()
    if diag:
        params_sh = dataclasses.replace(
            params,
            lam_q=sh(*lead, tp),
            win_q=sh(*lead, None, tp),
            wfb_q=None if params.wfb_q is None else sh(*lead, None, tp),
            # qtq is the EET *training* metric: serving never touches it.
            qtq=sh(*lead, None, None))
        shard_real = tuple(
            max(0, min(n_real, hi) - lo) for lo, hi in zip(cols, cols[1:]))
    else:
        params_sh = dataclasses.replace(
            params,
            w=sh(*lead, None, tp),
            w_in=sh(*lead, None, tp),
            w_fb=None if params.w_fb is None else sh(*lead, None, tp))
        shard_real = (0,) * (len(cols) - 1)
    # n_features rarely divides the model axis (bias adds +1) and w_out is
    # O(N * d_out): replicate it; a batched readout slot-shards its lead.
    readout_sh = None if readout is None else sh(*lead, None, None)
    return ArenaPlan(mesh=mesh, arena=arena_sh, params=params_sh,
                     readout=readout_sh, row_bounds=rows, col_bounds=cols,
                     n_real=shard_real)
