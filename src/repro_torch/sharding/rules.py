"""Sharding plans: the LM's on a device mesh, and the serving slot arena's.

The counterpart of ``repro.sharding.rules``.  Parallelism map of the LM
(mesh axes ``(pod, data, model)``):

  DP    — batch over ``(pod, data)``; the gradient sum is DTensor's
          redistribution of each gradient to its param's placements.
  FSDP  — >= 10B-param archs also split weights over ``data`` (each use
          gathers them).
  TP    — heads / d_ff / vocab / recurrent state over ``model``; attention
          weights stay whole where the head counts do not divide.
  EP    — MoE experts over ``model``: ``models.blocks._moe_ep``, a
          ``local_map`` body (JAX's ``shard_map``) with one sum a layer.
  SP    — the residual stream split over its sequence on ``model`` for
          large-d archs, and decode KV caches split over their sequence on
          ``model`` (flash-decoding).

:func:`make_profile` and :func:`plan_cell` read only axis names and sizes,
and the spec functions return plain tuples (``repro_torch.dist``), so plans
are made, and compared with JAX's, without a process group.  The step
builders and :func:`lower_cell` run on a ``DeviceMesh`` over an initialised
process group (one rank a device; a fake group of 256 or 512 ranks for the
dry run, ``launch.dryrun``).

The serving half places a slot arena: :class:`ArenaPlan`,
:func:`_axis_or_none` and :func:`plan_arena`, rule for rule.  **Slots ride
the data axis, N rides the model axis**, each only where it divides evenly
and the axis has more than one device.  Diag mode splits the state,
``lam_q`` and the Q-transformed input maps over ``model`` (the step is
element-wise in N: no per-step communication); standard mode splits the
columns of ``W``, ``w_in`` and ``w_fb`` over ``model`` and keeps the states
whole on every model shard.  A param batch leads with ``data``; the readout
is replicated, a batched readout split over ``data`` on its leading axis.

Each arena leaf's placement is a :class:`Sharding` — the mesh and a
``spec``, one axis name or ``None`` per tensor dim: JAX's
``NamedSharding(mesh, PartitionSpec(*spec))`` in plain Python, so the two
packages' plans compare leaf by leaf.  Where a cut of the packed Q basis
(``lam_q`` is ``[reals | re1, im1, re2, im2, ...]``,
``core.scan.pack_lambda_q``) falls inside an (re, im) pair, the plan moves
it one column on so that every pair stays whole and each model shard is a
packed-Q problem of its own (``ArenaPlan.n_real``); the specs are JAX's all
the same.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import dist
from ..configs import ArchConfig, ShapeCell
from ..models import lm
from ..models.blocks import ShardProfile
from ..train import optimizer as opt_mod
from ..train import trainer as trainer_mod
from ..tree import tree_map

__all__ = ["FSDP_THRESHOLD", "SCAN_METHOD", "CellPlan", "make_profile",
           "plan_cell", "batch_structs", "batch_specs", "params_abstract",
           "opt_state_specs", "make_train_step", "make_prefill_step",
           "make_decode_step", "PlacedStep", "lower_cell", "Sharding",
           "ArenaPlan", "plan_arena"]

FSDP_THRESHOLD = 10e9  # params

#: JAX's scan strategy for the recurrent mixers inside step functions, which
#: its dry-run probes switch to "associative".  The port's mixers always run
#: ``kernels.ops.diag_scan`` (on the meta device, shapes only); the name is
#: kept so the two dry runs set the same switches.
SCAN_METHOD = "chunked"


@dataclasses.dataclass(frozen=True)
class CellPlan:
    """Everything the launcher needs to build one (arch x shape x mesh)
    cell."""
    cfg: ArchConfig
    cell: ShapeCell
    prof: ShardProfile
    batch_axes: tuple          # dp axes actually used for this batch size
    seq_shard: bool            # SP of the residual stream
    optimizer: str             # adamw | adafactor


def make_profile(mesh, cfg: ArchConfig, *, seq_shard=None) -> ShardProfile:
    """The arch's profile on ``mesh``: tp ``model``, dp ``(pod, data)`` as
    present, FSDP over ``data`` above :data:`FSDP_THRESHOLD` params."""
    axes = dist.mesh_axes(mesh)
    tp = "model" if "model" in axes else None
    dp = tuple(a for a in ("pod", "data") if a in axes)
    fsdp = "data" if cfg.param_count() > FSDP_THRESHOLD and "data" in axes \
        else None
    return ShardProfile(mesh=mesh, tp=tp, fsdp=fsdp, dp=dp,
                        tp_size=axes.get("model", 1))


def plan_cell(mesh, cfg: ArchConfig, cell: ShapeCell) -> CellPlan:
    """JAX's plan: the largest prefix of the dp axes whose product divides
    the global batch; SP of the residual stream for d_model >= 4096 on
    full-sequence passes; no FSDP for decode (weights stay tp-split and
    data-replicated: one token is not worth every layer's all-gather);
    Adafactor above 100B params."""
    prof = make_profile(mesh, cfg)
    sizes = dist.mesh_axes(mesh)
    dp = []
    prod = 1
    for a in prof.dp:
        if cell.global_batch % (prod * sizes[a]) == 0:
            dp.append(a)
            prod *= sizes[a]
    dp = tuple(dp)
    seq_shard = (cell.kind in ("train", "prefill") and cfg.d_model >= 4096
                 and cell.seq_len % prof.tp_size == 0)
    fsdp = None if cell.kind == "decode" else prof.fsdp
    prof = dataclasses.replace(prof, dp=dp, fsdp=fsdp,
                               seq="model" if seq_shard else None)
    optimizer = "adafactor" if cfg.param_count() > 100e9 else "adamw"
    return CellPlan(cfg, cell, prof, dp, seq_shard, optimizer)


# --------------------------------------------------------------------------- #
# Inputs, abstract params and their specs (no allocation)                     #
# --------------------------------------------------------------------------- #
def batch_structs(cfg: ArchConfig, cell: ShapeCell):
    """The cell's batch as meta tensors (JAX's ``ShapeDtypeStruct``s):
    int32 tokens (B, 1) for decode, else tokens (B, S) or embeddings (B, S,
    d) in the config's dtype (plus labels to train on), plus an
    encoder-decoder's frames (B, T_enc, d)."""
    b, s = cell.global_batch, cell.seq_len

    def sd(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    act = getattr(torch, cfg.dtype)
    batch = {}
    if cell.kind == "decode":
        batch["tokens"] = sd((b, 1), torch.int32)
        return batch
    if cfg.input_mode == "embeddings":
        batch["embeds"] = sd((b, s, cfg.d_model), act)
        if cell.kind == "train":
            batch["labels"] = sd((b, s), torch.int32)
    else:
        batch["tokens"] = sd((b, s), torch.int32)
    if cfg.is_encoder_decoder:
        batch["frames"] = sd((b, cfg.encoder_seq, cfg.d_model), act)
    return batch


def batch_specs(cfg: ArchConfig, cell: ShapeCell, plan: CellPlan):
    """Each batch leaf split over the plan's batch axes on dim 0."""
    dp = plan.batch_axes or None
    return {k: (dp,) + (None,) * (v.ndim - 1)
            for k, v in batch_structs(cfg, cell).items()}


def params_abstract(cfg: ArchConfig, prof: ShardProfile):
    """(the param tree as meta tensors, its specs): no allocation, any
    config (JAX's ``eval_shape`` of ``init_params``)."""
    return lm.init_params(None, cfg, "meta"), lm.param_specs(cfg, prof)


def opt_state_specs(opt, param_specs):
    """The optimizer state's specs: AdamW's moments as the params;
    Adafactor's ``vr`` drops the last dim's entry, ``vc`` the one before
    it (a factored leaf has two or more entries, else ``v``)."""
    if isinstance(opt, opt_mod.AdamW):
        return {"m": param_specs, "v": param_specs, "step": ()}

    def one(spec):
        if len(spec) >= 2:
            return {"vr": tuple(spec[:-1]),
                    "vc": tuple(spec[:-2]) + tuple(spec[-1:])}
        return {"v": tuple(spec)}
    return {"f": tree_map(one, param_specs), "step": ()}


# --------------------------------------------------------------------------- #
# Step builders                                                                #
# --------------------------------------------------------------------------- #
def make_train_step(plan: CellPlan, opt):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss,
    metrics)``: the loss with each layer recomputed in the backward
    (``remat``), flash attention from 1024 tokens, then the update."""
    cfg, prof = plan.cfg, plan.prof
    attn_impl = "flash" if plan.cell.seq_len >= 1024 else "dense"

    def train_step(params, opt_state, batch):
        loss, metrics, grads = trainer_mod.loss_and_grads(
            cfg, params, batch, prof=prof, remat=True, attn_impl=attn_impl)
        updates, opt_state = opt.update(grads, opt_state, params)
        del grads
        params = opt_mod.apply_updates(params, updates)
        return params, opt_state, loss, metrics

    return train_step


def make_prefill_step(plan: CellPlan):
    """``prefill_step(params, batch) -> (last logits (B, V), caches)``."""
    cfg, prof = plan.cfg, plan.prof

    def prefill_step(params, batch):
        with torch.no_grad():
            logits, caches, _ = lm.forward(params, cfg, batch, prof,
                                           mode="prefill", attn_impl="flash")
        return logits[:, -1], caches

    return prefill_step


def make_decode_step(plan: CellPlan):
    """``decode_step(params, cache, batch) -> (logits (B, 1, V), cache)``."""
    cfg, prof = plan.cfg, plan.prof

    def decode_step(params, cache, batch):
        with torch.no_grad():
            return lm.decode_step(params, cfg, cache, batch["tokens"], prof)

    return decode_step


@dataclasses.dataclass
class PlacedStep:
    """What stands in for JAX's ``Lowered`` here: PyTorch has no XLA
    program to lower, so a cell is its step function with its arguments
    placed on the mesh (DTensors, meta tensors under the dry run) and their
    spec trees.  Calling it runs (or, on meta, traces) the step once; with
    ``donate`` (JAX's ``donate_argnums``) it drops its own references to
    the params and state it hands over and cannot be called again."""
    plan: CellPlan
    step: Any
    args: Optional[tuple]
    specs: Dict[str, Any]
    donate: bool = True

    def __call__(self):
        if self.args is None:
            raise RuntimeError("a donating PlacedStep runs once")
        args = self.args
        if self.donate:
            self.args = None
        return self.step(*args)


def lower_cell(mesh, cfg: ArchConfig, cell: ShapeCell, *, donate=True):
    """Build and place one cell on the ``DeviceMesh`` ``mesh``.  Returns
    ``(placed, meta)``: a :class:`PlacedStep` over abstract (meta) params,
    optimizer state, batch and caches placed by their specs, and JAX's
    ``meta`` dict, key for key."""
    plan = plan_cell(mesh, cfg, cell)
    prof = plan.prof
    p_shapes, p_specs = params_abstract(cfg, prof)
    params = dist.place(p_shapes, p_specs, mesh)
    b_specs = batch_specs(cfg, cell, plan)
    batch = dist.place(batch_structs(cfg, cell), b_specs, mesh)
    meta = {"arch": cfg.name, "shape": cell.name, "kind": cell.kind,
            "mesh": dist.mesh_axes(mesh), "optimizer": plan.optimizer,
            "fsdp": prof.fsdp, "dp_axes": list(plan.batch_axes),
            "seq_shard": plan.seq_shard}
    specs = {"params": p_specs, "batch": b_specs}
    if cell.kind == "train":
        opt = opt_mod.make_optimizer(plan.optimizer)
        specs["opt"] = opt_state_specs(opt, p_specs)
        args = (params, opt.init(params), batch)
        step = make_train_step(plan, opt)
    elif cell.kind == "prefill":
        args = (params, batch)
        step = make_prefill_step(plan)
    else:
        specs["cache"] = lm.cache_specs(cfg, prof)
        cache = lm.make_decode_cache(p_shapes, cfg, cell.global_batch,
                                     cell.seq_len, prof)
        args = (params, cache, batch)
        step = make_decode_step(plan)
    return PlacedStep(plan, step, args, specs, donate), meta


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
