"""SlotArena — the device-side layer of the serving stack.

The serving stack is three layers (bottom to top):

* **arena** (this module) — the ``(B, N)`` slot state itself, as an
  immutable struct of tensors plus *pure functions* over it.  Nothing here
  knows about sessions, queues, or admission policy.
* **scheduler** (``serve.scheduler``) — host-side admission: requests are
  bucketed by padded prompt length and served in waves.
* **engine** (``serve.engine``) — the thin orchestrator that owns the
  session <-> slot mapping and calls down into both.

The heart of the layer is :func:`prefill_wave`: ONE ``(B_wave, T_bucket)``
batched scan (backend from ``core.dispatch``) replaces ``B_wave``
sequential per-session prefills.  Rows are padded up to the bucket length;
because the recurrence is causal, the padded tail steps can never influence
the gathered per-row final state ``states[b, length_b - 1]``.

All functions take the param struct (``core.params``) and readout
``w_out`` as explicit arguments.  ``batched=True`` means a *stacked* param
struct (``core.params.stack_params``): slot ``i`` runs reservoir ``i`` with
readout ``w_out[i]`` ((B, F, D)).  ``ensemble="mean"`` / ``"weighted"``
reduces the per-slot predictions of a param-batched arena to one ensemble
output, which is also what feeds back in closed loop.

**Value semantics.**  Every function here returns a *new* ``SlotArena``
whose tensors share no storage that a later call writes: nothing is updated
in place, so an older arena value stays valid while a newer one is being
computed (the engine's in-flight window relies on this).

**The sharded arena.**  On a device mesh (``launch.mesh``) the arena is a
:class:`ShardedArena`: one ``SlotArena`` per mesh cell, placed by
``sharding.rules.plan_arena`` (slots on ``data``, N on ``model``), and
every function above takes it in place of a ``SlotArena``:

* each data shard is an independent sub-arena (slot ``s`` on data shard
  ``s // (max_slots / n_data)``); its prefill is one scan launch a model
  shard;
* each model shard holds whole (re, im) pairs of the packed Q basis with
  its own ``n_real`` (diag), or the whole state and its columns of ``W``
  (standard: the columns of ``states @ W`` are gathered back to every model
  shard once a step);
* the readout ``[1 | y_prev | r] @ w_out`` is a partial product a model
  shard, ``[1 | y_prev]`` on the first, summed on the data shard's first
  device in shard order; an ``ensemble`` reduce sums over the data shards
  in order on the mesh's first device;
* a closed loop runs the fused decode once a data shard when the model
  axis is not split and no ensemble reduce crosses data shards; otherwise
  every step needs the whole ``y`` and the loop takes the step route
  (:func:`closed_loop_route` decides from the plan and the shapes).

An axis the plan leaves replicated keeps a full replica on each of its
devices, and each replica runs every launch; reads come from the first.
``states``, ``y_prev`` and ``active`` of a sharded arena assemble the full
tensors on the mesh's first device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..core import dispatch as dispatch_mod
from ..core import esn as esn_fn
from ..kernels.diag_scan import decode_layout

__all__ = [
    "SlotArena",
    "ArenaLayout",
    "ShardedArena",
    "make_arena",
    "shard_arena",
    "place",
    "place_many",
    "gather_rows",
    "release",
    "release_many",
    "force_output",
    "arena_step",
    "apply_readout",
    "decode_step",
    "driven_loop",
    "closed_loop",
    "closed_loop_fused",
    "decode_route",
    "closed_loop_route",
    "prefill_wave",
]


@dataclasses.dataclass(frozen=True)
class SlotArena:
    """Device-side slot state: ``states`` (B, N) recurrent state in the
    model's native basis; ``y_prev`` (B, D_out) last output per slot (the
    feedback column); ``active`` (B,) bool occupancy mask."""
    states: torch.Tensor
    y_prev: torch.Tensor
    active: torch.Tensor

    @property
    def max_slots(self) -> int:
        return self.states.shape[0]


def make_arena(n: int, d_out: int, max_slots: int, dtype,
               device) -> SlotArena:
    """A zeroed arena of ``max_slots`` slots, all free."""
    return SlotArena(
        states=torch.zeros((max_slots, n), dtype=dtype, device=device),
        y_prev=torch.zeros((max_slots, d_out), dtype=dtype, device=device),
        active=torch.zeros((max_slots,), dtype=torch.bool, device=device))


def _set_row(v, slot: int, row):
    return v.index_put((torch.tensor([slot], device=v.device),),
                       torch.as_tensor(row, dtype=v.dtype, device=v.device)[None])


def place(arena: SlotArena, slot: int, h0, y0) -> SlotArena:
    """Write a session's (state, feedback) into ``slot`` and mark it live."""
    if isinstance(arena, ShardedArena):
        return _sh_place(arena, slot, h0, y0)
    return SlotArena(states=_set_row(arena.states, slot, h0),
                     y_prev=_set_row(arena.y_prev, slot, y0),
                     active=_set_row(arena.active, slot, True))


def place_many(arena: SlotArena, slots, h0s, y0s) -> SlotArena:
    """Write a whole wave of sessions in ONE scatter per tensor (one a
    cell of a sharded arena)."""
    if isinstance(arena, ShardedArena):
        return _sh_place_many(arena, slots, h0s, y0s)
    return SlotArena(states=arena.states.index_copy(0, slots, h0s),
                     y_prev=arena.y_prev.index_copy(0, slots, y0s),
                     active=arena.active.index_fill(0, slots, True))


def gather_rows(arena: SlotArena, slots):
    """``slots``'s (states, y_prev) rows, on the arena's device (a sharded
    arena's first device)."""
    if isinstance(arena, ShardedArena):
        return _sh_gather_rows(arena, slots)
    return arena.states[slots], arena.y_prev[slots]


def release(arena: SlotArena, slot: int) -> SlotArena:
    """Mark ``slot`` free.  The state tensors are left as they are."""
    if isinstance(arena, ShardedArena):
        return _sh_map_slots(arena, slot, lambda c, loc, dev: release(
            c, loc[0]))
    return dataclasses.replace(arena,
                               active=_set_row(arena.active, slot, False))


def release_many(arena: SlotArena, slots) -> SlotArena:
    """Free a whole wave of slots in ONE scatter."""
    if isinstance(arena, ShardedArena):
        return _sh_map_slots(arena, slots, lambda c, loc, dev: release_many(
            c, _dev_index(loc, dev)))
    return dataclasses.replace(arena,
                               active=arena.active.index_fill(0, slots, False))


def force_output(arena: SlotArena, slot, y_true) -> SlotArena:
    """Teacher-force ``slot`` (or each slot of a list): overwrite its
    feedback output ``y_prev[slot]`` with ground truth, leaving the
    recurrent state untouched — the next ``decode_step`` / ``closed_loop``
    of that slot drives from the true output (``ReservoirEngine.observe``).
    Returns the rebuilt arena."""
    if isinstance(arena, ShardedArena):
        return _sh_map_slots(arena, slot, lambda c, loc, dev: force_output(
            c, loc, torch.as_tensor(y_true).to(dev)))
    if isinstance(slot, (int, np.integer)):
        return dataclasses.replace(
            arena, y_prev=_set_row(arena.y_prev, slot, y_true))
    idx = torch.tensor(list(slot), dtype=torch.int64,
                       device=arena.y_prev.device)
    y = torch.as_tensor(y_true, dtype=arena.y_prev.dtype,
                        device=arena.y_prev.device)
    return dataclasses.replace(arena, y_prev=arena.y_prev.index_put(
        (idx,), y.expand(len(idx), -1)))


# ------------------------------------------------------------------ stepping
def arena_step(params, states, u, y_prev, *, batched: bool = False):
    """One reservoir step over the whole slot block.  Shared params
    broadcast over (B, N); a param *batch* steps row b with reservoir b (the
    per-row drive is one batched matmul)."""
    fb = params.cfg.use_feedback
    if batched:
        d = esn_fn.drive(params, u[:, None], y_prev[:, None] if fb else None)
        return esn_fn.step_states(params, states, d[:, 0])
    return esn_fn.step_states(
        params, states, esn_fn.drive(params, u, y_prev if fb else None))


def apply_readout(w_out, x):
    """Features (B, ..., F) through the readout, row by row: row b of ``x``
    with readout b of a (B, F, D) pool (a param batch, or the per-tenant
    pool over one reservoir), or with the one (F, D) readout, expanded to
    every row without a copy.  Either way the same products are summed
    over F in one order, so a row's output depends on its own features and
    readout alone — never on whether a pool is active or what the other
    rows serve (a refit of one tenant moves no bit of another's)."""
    w = w_out if w_out.ndim == 3 else w_out.expand(
        (x.shape[0],) + tuple(w_out.shape))
    w = w.reshape(w.shape[:1] + (1,) * (x.ndim - 2) + w.shape[1:])
    # The products land in one layout whatever the readout's strides, so
    # the sum runs in one order.
    return (x.unsqueeze(-1) * w).contiguous().sum(-2)


def _ensemble_reduce(y, mask, weights=None):
    """(Weighted) mean over the stepped slots, broadcast back to every row.
    ``weights=None`` is the plain mean; otherwise per-slot voting weights,
    renormalized over the masked slots."""
    if weights is None:
        w = mask.to(y.dtype)
        denom = torch.clamp(w.sum(), min=1.0)
    else:
        w = torch.as_tensor(weights, dtype=y.dtype, device=y.device) * mask
        denom = torch.clamp(w.sum(), min=1e-9)
    y_mean = (y * w[:, None]).sum(0) / denom
    return torch.broadcast_to(y_mean, y.shape)


def _readout_step(params, w_out, states, y_feat, mask, w_ens, *, ensemble):
    """The readout of one step (and its ensemble reduce): ``y_feat`` is the
    feedback column the features carry."""
    x = esn_fn.assemble_features(params, states, y_feat)
    y = apply_readout(w_out, x)
    if ensemble in ("mean", "weighted"):
        y = _ensemble_reduce(y, mask, w_ens if ensemble == "weighted"
                             else None)
    return y


def decode_step(params, w_out, arena: SlotArena, u, mask, ens_weights=None,
                *, batched: bool = False, ensemble: str = "off"):
    """Advance the masked slots one token.  Returns ``(arena', y)`` where
    unmasked rows of ``y`` hold their previous output."""
    if isinstance(arena, ShardedArena):
        return _sh_decode_step(params, w_out, arena, u, mask, ens_weights,
                               batched=batched, ensemble=ensemble)
    new = arena_step(params, arena.states, u, arena.y_prev, batched=batched)
    states = torch.where(mask[:, None], new, arena.states)
    if w_out is None:
        return dataclasses.replace(arena, states=states), arena.y_prev
    y = _readout_step(params, w_out, states, arena.y_prev, mask, ens_weights,
                      ensemble=ensemble)
    y_out = torch.where(mask[:, None], y, arena.y_prev)
    return dataclasses.replace(arena, states=states, y_prev=y_out), y_out


def driven_loop(params, w_out, arena: SlotArena, mask, u_seq,
                ens_weights=None, *, batched: bool = False,
                ensemble: str = "off"):
    """Teacher-driven generation over the masked slots: step the K queued
    inputs ``u_seq`` (K, B, D_in) through the arena.  Each step is exactly
    :func:`decode_step` on ``u_seq[t]``, so draining a per-session input
    queue this way is bit-identical to K sequential ``decode_step`` calls.
    Returns ``(arena', ys)`` with ``ys`` (K, B, D_out)."""
    ys = []
    for u_t in u_seq:
        arena, y = decode_step(params, w_out, arena, u_t, mask, ens_weights,
                               batched=batched, ensemble=ensemble)
        ys.append(y)
    ys = torch.stack(ys) if ys else arena.y_prev.new_zeros(
        (0,) + tuple(arena.y_prev.shape))
    return arena, ys


def closed_loop(params, w_out, arena: SlotArena, mask, n_steps: int,
                ens_weights=None, *, batched: bool = False,
                ensemble: str = "off"):
    """Free-running generation over the masked slots, one step at a time:
    each step feeds the prediction (or the ensemble reduce of the
    predictions) back as the next input.  Returns ``(arena', ys)`` with
    ``ys`` (n_steps, B, D_out)."""
    if isinstance(arena, ShardedArena):
        return _sh_closed_loop(params, w_out, arena, mask, n_steps,
                               ens_weights, batched=batched,
                               ensemble=ensemble)
    w_ens = ens_weights if ensemble == "weighted" else None
    states, y = arena.states, arena.y_prev
    if ensemble in ("mean", "weighted"):
        # The free-run starts from the fused seed too: every masked
        # reservoir's first input is the ensemble reduce of the stepped
        # slots' seeds (unmasked slots keep their own y_prev).
        y = torch.where(mask[:, None], _ensemble_reduce(y, mask, w_ens), y)
    ys = []
    for _ in range(n_steps):
        new = arena_step(params, states, y, y, batched=batched)
        states = torch.where(mask[:, None], new, states)
        y_new = _readout_step(params, w_out, states, y, mask, w_ens,
                              ensemble=ensemble)
        y = torch.where(mask[:, None], y_new, y)
        ys.append(y)
    ys = torch.stack(ys) if ys else y.new_zeros((0,) + tuple(y.shape))
    return dataclasses.replace(arena, states=states, y_prev=y), ys


def decode_route(b: int, nc: int, d: int, itemsize: int, device_type: str,
                 *, ensemble: str = "off", per_slot: bool = False) -> str:
    """Which path a diag-mode closed-loop decode with a readout takes, from
    the shapes and the device type alone: ``"fused"`` (one launch of the
    fused K-token decode kernel) or ``"step"`` (:func:`closed_loop`, one
    step at a time on the same device).  ``weighted`` voting takes the
    step path everywhere (the kernel reduces by plain mean only, as in the
    JAX package).  On CUDA, ``mean`` spreads the rows over one
    thread-block cluster of the kernel, so an arena whose B rows of NC
    lanes exceed it (``kernels.diag_scan.decode_layout``: at n = 1024,
    float64, more than 128 slots) takes the step path; the plain version
    on the CPU has no such limit.  Decided before any launch, never by
    catching a launch's error."""
    if ensemble == "weighted":
        return "step"
    if device_type == "cuda" and ensemble == "mean":
        try:
            decode_layout(b, nc, d, itemsize, ensemble="mean",
                          batched=per_slot)
        except ValueError:
            return "step"
    return "fused"


def closed_loop_route(params, w_out, arena: SlotArena, *,
                      ensemble: str = "off") -> str:
    """:func:`decode_route` for this engine's operands (dense params or a
    missing readout take the step path; on a sharded arena also a split
    model axis, and an ensemble reduce across split data shards)."""
    if isinstance(arena, ShardedArena):
        return _sh_closed_loop_route(params, w_out, arena, ensemble=ensemble)
    if w_out is None or params.mode != "diag":
        return "step"
    n = params.lam_q.shape[-1]
    per_slot = (params.lam_q.dim() == 2 or params.win_q.dim() == 3
                or (params.wfb_q is not None and params.wfb_q.dim() == 3)
                or w_out.dim() == 3)
    b, d = arena.y_prev.shape
    return decode_route(b, (n + int(params.n_real)) // 2, d,
                        arena.y_prev.element_size(), arena.y_prev.device.type,
                        ensemble=ensemble, per_slot=per_slot)


def closed_loop_fused(params, w_out, arena: SlotArena, mask, n_steps: int,
                      ens_weights=None, *, batched: bool = False,
                      ensemble: str = "off", method: str = "auto"):
    """:func:`closed_loop` through the fused K-token decode kernel: one
    launch runs all ``n_steps`` (``core.dispatch.run_decode_fused`` — the
    CUDA kernel on the GPU, the plain version elsewhere; ``method`` as
    there), including the ``mean`` ensemble's reduce and seed.  Where
    :func:`closed_loop_route` says ``"step"`` (dense params, a missing
    readout, ``weighted`` voting, a ``mean`` arena past the kernel's
    cluster limit) it runs :func:`closed_loop` instead; the fused path
    reads ``batched`` from the shape of ``lam_q``.  A sharded arena on the
    fused route runs it once a cell."""
    if isinstance(arena, ShardedArena):
        return _sh_closed_loop_fused(params, w_out, arena, mask, n_steps,
                                     ens_weights, batched=batched,
                                     ensemble=ensemble, method=method)
    if closed_loop_route(params, w_out, arena, ensemble=ensemble) == "step":
        return closed_loop(params, w_out, arena, mask, n_steps, ens_weights,
                           batched=batched, ensemble=ensemble)
    cfg = params.cfg
    w_drive = (params.win_q + params.wfb_q if cfg.use_feedback
               else params.win_q)
    states, y_prev, ys = dispatch_mod.run_decode_fused(
        params.lam_q, params.n_real, w_drive, w_out, arena.states,
        arena.y_prev, mask, int(n_steps), use_bias=cfg.use_bias,
        use_feedback=cfg.use_feedback, ensemble=ensemble, method=method)
    return dataclasses.replace(arena, states=states, y_prev=y_prev), ys


# ------------------------------------------------------------- wave prefill
def _rows(params, slots):
    """The reservoirs of ``slots`` out of a stacked param struct (the leaves
    the prefill reads: the recurrence and the drive maps)."""
    if params.mode == "diag":
        return dataclasses.replace(
            params, lam_q=params.lam_q[slots], win_q=params.win_q[slots],
            wfb_q=None if params.wfb_q is None else params.wfb_q[slots])
    return dataclasses.replace(
        params, w=params.w[slots], w_in=params.w_in[slots],
        w_fb=None if params.w_fb is None else params.w_fb[slots])


def prefill_wave(params, w_out, arena: SlotArena, slots, u, lengths,
                 y_teacher=None, *, batched: bool = False,
                 method: str = "sequential", chunk: int = 128,
                 want_outputs: bool = True):
    """Run ONE batched prefill over a wave of slots.

    ``slots``: (B_wave,) slot indices; ``u``: (B_wave, T_bucket, D_in)
    prompts padded to the bucket length; ``lengths``: (B_wave,) true prompt
    lengths; ``y_teacher``: (B_wave, T_bucket, D_out) teacher outputs for
    feedback models (padding past ``lengths`` is ignored).  Returns
    ``(arena', outputs)`` where outputs is (B_wave, T_bucket, D_out)
    per-step predictions ((B_wave, T_bucket, N) states when ``w_out`` is
    None), zeroed past each row's true length, or None when
    ``want_outputs=False``.

    The rows ride one scan as a batch axis.  With a param batch
    (``batched``) each row runs the reservoir of its slot: the drive is one
    batched matmul and the scan takes one row of coefficients per row —
    still one scan, one kernel launch on the card.

    **Resumable carry**: every row starts from its slot's *current*
    ``(states[slot], y_prev[slot])`` and writes the post-scan carry back, so
    a prompt run as K sequential same-slot waves over its chunks equals one
    wave over the whole prompt.  Nothing at t >= length can reach
    ``states[length - 1]``.

    On a sharded arena each data shard runs its rows of the wave: one scan
    a model shard.
    """
    if isinstance(arena, ShardedArena):
        return _sh_prefill_wave(params, w_out, arena, slots, u, lengths,
                                y_teacher, batched=batched, method=method,
                                chunk=chunk, want_outputs=want_outputs)
    cfg = params.cfg
    h0 = arena.states[slots]
    y0 = arena.y_prev[slots]
    if batched:
        params = _rows(params, slots)
    if w_out is not None and w_out.ndim == 3:
        w_out = w_out[slots]        # each row's readout out of the pool
    rows = torch.arange(u.shape[0], device=u.device)
    last_t = lengths - 1
    y_shift = None
    if cfg.use_feedback:
        y_shift = torch.cat([y0[:, None], y_teacher[:, :-1]], 1)
    states = esn_fn.scan_states(params, esn_fn.drive(params, u, y_shift), h0,
                                method=method, chunk=chunk)
    last = states[rows, last_t]
    valid = (torch.arange(u.shape[1], device=u.device)[None, :]
             < lengths[:, None])[..., None]
    if cfg.use_feedback:
        # Prefill is teacher-forced end-to-end: the teacher's last *true*
        # output is the feedback seed.
        y_next = y_teacher[rows, last_t]
    if w_out is None:
        out = torch.where(valid, states, 0.0) if want_outputs else None
        y_next = y_next if cfg.use_feedback else y0
    elif want_outputs:
        y = apply_readout(w_out,
                          esn_fn.assemble_features(params, states, y_shift))
        out = torch.where(valid, y, 0.0)
        if not cfg.use_feedback:
            y_next = y[rows, last_t]
    else:
        # Last-step readout only: the closed-loop feedback seed.
        out = None
        if not cfg.use_feedback:
            y_next = apply_readout(
                w_out, esn_fn.assemble_features(params, last, None))
    arena = dataclasses.replace(
        arena,
        states=arena.states.index_copy(0, slots, last),
        y_prev=arena.y_prev.index_copy(0, slots, y_next))
    return arena, out


# ------------------------------------------------------------ sharded arena
@dataclasses.dataclass(frozen=True, eq=False)
class ArenaLayout:
    """Where the cells of a :class:`ShardedArena` live and what each holds,
    built once per engine from its ``sharding.rules.ArenaPlan``: each
    cell's device, each data shard's slot range and each model shard's
    column range (the whole range on every shard of a replicated axis), and
    each cell's params (its rows and columns, its own ``n_real``).  The
    readouts the waves serve are split for the cells at first use and kept
    while they are the current ones."""
    plan: Any
    devices: np.ndarray
    rows: Tuple[Tuple[int, int], ...]
    cols: Tuple[Tuple[int, int], ...]
    split_data: bool
    split_model: bool
    params: np.ndarray
    n_extra: int
    _readouts: Dict = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, plan, params) -> "ArenaLayout":
        grid = plan.mesh.devices
        nd, nm = grid.shape
        rb, cb = plan.row_bounds, plan.col_bounds
        split_data = nd > 1 and len(rb) == nd + 1
        split_model = nm > 1 and len(cb) == nm + 1
        rows = tuple((rb[i], rb[i + 1]) if split_data else (rb[0], rb[-1])
                     for i in range(nd))
        cols = tuple((cb[j], cb[j + 1]) if split_model else (cb[0], cb[-1])
                     for j in range(nm))
        leaves = {f.name: getattr(plan.params, f.name).split(
                      getattr(params, f.name))
                  for f in dataclasses.fields(params)
                  if hasattr(getattr(plan.params, f.name), "split")}
        cell_params = np.empty(grid.shape, dtype=object)
        for i in range(nd):
            for j in range(nm):
                kw = {k: v[i, j] for k, v in leaves.items()}
                if params.mode == "diag":
                    kw["n_real"] = plan.n_real[j if split_model else 0]
                cell_params[i, j] = dataclasses.replace(params, **kw)
        cfg = params.cfg
        return cls(plan=plan, devices=grid, rows=rows, cols=cols,
                   split_data=split_data, split_model=split_model,
                   params=cell_params, n_extra=cfg.n_features - cfg.n)

    @property
    def home(self) -> torch.device:
        return self.devices[0, 0]

    @property
    def partial(self) -> bool:
        """The state's columns are split over the model shards (diag mode
        on a split model axis): each shard holds a part of the readout."""
        return self.split_model and self.params[0, 0].mode == "diag"

    @property
    def shape(self) -> Tuple[int, int]:
        return self.devices.shape

    def data_owners(self) -> range:
        """The data shards whose rows a read takes (the first replica of a
        replicated data axis)."""
        return range(self.shape[0] if self.split_data else 1)

    def readouts(self, w_out):
        """``w_out`` ((F, D), or a (B, F, D) pool / param batch) split for
        the cells: a pool's rows by data shard; on a partial model axis
        model shard j's rows of F (``[1 | y_prev]`` and its columns on the
        first, its columns alone on the others)."""
        if w_out is None:
            return None
        hit = self._readouts.get(id(w_out))
        if hit is not None and hit[0] is w_out:
            return hit[1]
        grid = np.empty(self.shape, dtype=object)
        for i, (r0, r1) in enumerate(self.rows):
            w_i = w_out[r0:r1] if w_out.ndim == 3 else w_out
            for j, (c0, c1) in enumerate(self.cols):
                w = w_i
                if self.partial:
                    w = (w_i[..., :self.n_extra + c1, :] if j == 0 else
                         w_i[..., self.n_extra + c0:self.n_extra + c1, :])
                grid[i, j] = w.to(self.devices[i, j]).contiguous()
        # Only the current readouts: a refit's new pool replaces the old.
        self._readouts.clear()
        self._readouts[id(w_out)] = (w_out, grid)
        return grid

    def cut(self, t, i: int, j: int):
        """Data shard ``i``'s rows of a per-slot tensor, on cell (i, j)."""
        if t is None:
            return None
        r0, r1 = self.rows[i]
        return t[r0:r1].to(self.devices[i, j])

    def state_cols(self, x, j: int):
        """Model shard ``j``'s columns of a (.., N) state (all of them
        unless the columns are split)."""
        if not self.partial:
            return x
        c0, c1 = self.cols[j]
        return x[..., c0:c1]


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedArena:
    """A slot arena on a device mesh: ``cells[i][j]`` is the
    :class:`SlotArena` of data shard ``i`` (its slot rows) and model shard
    ``j`` (its state columns, or the whole state in standard mode), on
    ``layout.devices[i, j]``; ``y_prev`` and ``active`` are whole on every
    model shard.  ``states`` / ``y_prev`` / ``active`` assemble the full
    tensors on the mesh's first device."""
    layout: ArenaLayout
    cells: Tuple[Tuple[SlotArena, ...], ...]

    @property
    def max_slots(self) -> int:
        return self.layout.plan.row_bounds[-1]

    def _join(self, field: str) -> torch.Tensor:
        parts = np.empty(self.layout.shape, dtype=object)
        for i, row in enumerate(self.cells):
            for j, cell in enumerate(row):
                parts[i, j] = getattr(cell, field)
        return self.layout.plan.arena[field].join(parts, self.layout.home)

    @functools.cached_property
    def states(self) -> torch.Tensor:
        return self._join("states")

    @functools.cached_property
    def y_prev(self) -> torch.Tensor:
        return self._join("y_prev")

    @functools.cached_property
    def active(self) -> torch.Tensor:
        return self._join("active")


def shard_arena(layout: ArenaLayout, arena: SlotArena) -> ShardedArena:
    """Place a whole :class:`SlotArena` (on any device) on ``layout``'s
    mesh, by the plan's arena shardings."""
    sh = layout.plan.arena
    parts = {k: sh[k].split(getattr(arena, k))
             for k in ("states", "y_prev", "active")}
    nd, nm = layout.shape
    return ShardedArena(layout, tuple(
        tuple(SlotArena(states=parts["states"][i, j],
                        y_prev=parts["y_prev"][i, j],
                        active=parts["active"][i, j]) for j in range(nm))
        for i in range(nd)))


def _slot_list(slots) -> List[int]:
    if isinstance(slots, torch.Tensor):
        return [int(s) for s in slots.reshape(-1).tolist()]
    if isinstance(slots, (int, np.integer)):
        return [int(slots)]
    return [int(s) for s in slots]


def _by_shard(lay: ArenaLayout, slots: List[int], *, owners: bool = False):
    """Data shard -> (positions in ``slots``, local row indices) of the
    slots it holds (``owners``: the first replica only)."""
    groups: Dict[int, Tuple[List[int], List[int]]] = {}
    for pos, s in enumerate(slots):
        for i, (r0, r1) in enumerate(lay.rows):
            if r0 <= s < r1:
                g = groups.setdefault(i, ([], []))
                g[0].append(pos)
                g[1].append(s - r0)
                if owners:
                    break
    return groups


def _dev_index(idx: List[int], device: torch.device) -> torch.Tensor:
    """Row indices on ``device`` (through page-locked memory on the card,
    so the copy waits for nothing queued before it)."""
    t = torch.tensor(idx, dtype=torch.int64)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _with_cells(arena: ShardedArena, cells) -> ShardedArena:
    return ShardedArena(arena.layout, tuple(tuple(row) for row in cells))


def _sh_place(arena, slot, h0, y0):
    lay = arena.layout
    cells = [list(row) for row in arena.cells]
    for i, (_, loc) in _by_shard(lay, [slot]).items():
        for j in range(lay.shape[1]):
            cells[i][j] = place(cells[i][j], loc[0], lay.state_cols(h0, j),
                                y0)
    return _with_cells(arena, cells)


def _sh_place_many(arena, slots, h0s, y0s):
    lay = arena.layout
    cells = [list(row) for row in arena.cells]
    for i, (pos, loc) in _by_shard(lay, _slot_list(slots)).items():
        pos_t = torch.tensor(pos, device=h0s.device)
        h_i, y_i = h0s[pos_t], y0s[pos_t]
        for j in range(lay.shape[1]):
            dev = lay.devices[i, j]
            cells[i][j] = place_many(cells[i][j], _dev_index(loc, dev),
                                     lay.state_cols(h_i, j).to(dev),
                                     y_i.to(dev))
    return _with_cells(arena, cells)


def _sh_gather_rows(arena, slots):
    lay = arena.layout
    home = lay.home
    sl = _slot_list(slots)
    parts = []
    for i, (pos, loc) in _by_shard(lay, sl, owners=True).items():
        row = arena.cells[i]
        idx = [_dev_index(loc, lay.devices[i, j]) for j in range(len(row))]
        s = (torch.cat([c.states[idx[j]].to(home) for j, c in enumerate(row)],
                       -1) if lay.partial else row[0].states[idx[0]].to(home))
        parts.append((pos, s, row[0].y_prev[idx[0]].to(home)))
    if len(parts) == 1 and parts[0][0] == list(range(len(sl))):
        return parts[0][1], parts[0][2]
    states = parts[0][1].new_empty((len(sl), parts[0][1].shape[-1]))
    ys = parts[0][2].new_empty((len(sl), parts[0][2].shape[-1]))
    for pos, s, y in parts:
        pos_t = torch.tensor(pos, device=home)
        states.index_copy_(0, pos_t, s)
        ys.index_copy_(0, pos_t, y)
    return states, ys


def _sh_map_slots(arena, slots, fn):
    """``fn(cell, local_slots, device)`` on every cell holding ``slots``."""
    lay = arena.layout
    cells = [list(row) for row in arena.cells]
    for i, (_, loc) in _by_shard(lay, _slot_list(slots)).items():
        for j in range(lay.shape[1]):
            cells[i][j] = fn(cells[i][j], loc, lay.devices[i, j])
    return _with_cells(arena, cells)


def _tick(lay, i, states, u, y_fb, *, batched):
    """Data shard ``i``'s new (unmasked) states, one per model shard: the
    step on each shard's columns; in standard mode on a split model axis
    each shard's columns of ``states @ W`` gathered back to every shard."""
    prow = lay.params[i]
    new = [arena_step(prow[j], states[j], u[j], y_fb[j], batched=batched)
           for j in range(len(states))]
    if not lay.split_model or lay.partial:
        return new
    dev0 = lay.devices[i, 0]
    full = torch.cat([b.to(dev0) for b in new], -1)
    return [full.to(lay.devices[i, j]) for j in range(len(states))]


def _partial_readout(lay, i, w_row, states, y_feat):
    """Data shard ``i``'s readout on its first device: ``[1 | y_feat | r]
    @ w_out`` — on a partial model axis the sum of each shard's product of
    its columns (``[1 | y_feat]`` with the first), in shard order."""
    p0 = lay.params[i, 0]
    y = apply_readout(w_row[0], esn_fn.assemble_features(p0, states[0],
                                                         y_feat))
    if lay.partial:
        dev0 = lay.devices[i, 0]
        for j in range(1, len(states)):
            y = y + apply_readout(w_row[j], states[j]).to(dev0)
    return y


def _sh_ensemble(lay, ys, masks, ens_weights, ensemble):
    """The ensemble reduce of each data shard's predictions ``ys[i]`` (on
    its first device): over the stepped slots of every data shard, summed
    in shard order on the mesh's first device, broadcast back."""
    if ensemble not in ("mean", "weighted"):
        return ys
    wts = ens_weights if ensemble == "weighted" else None
    if not lay.split_data:
        return [_ensemble_reduce(ys[i], masks[i], lay.cut(wts, i, 0))
                for i in range(len(ys))]
    home = lay.home
    num = den = None
    for i, y in enumerate(ys):
        w = (masks[i].to(y.dtype) if wts is None else
             lay.cut(wts, i, 0).to(y.dtype) * masks[i])
        n_i, d_i = (y * w[:, None]).sum(0).to(home), w.sum().to(home)
        num = n_i if num is None else num + n_i
        den = d_i if den is None else den + d_i
    mean = num / torch.clamp(den, min=1.0 if wts is None else 1e-9)
    return [torch.broadcast_to(mean.to(y.device), y.shape) for y in ys]


def _join_rows(lay, parts, dim: int = 0) -> torch.Tensor:
    """Per data shard tensors (slot rows on ``dim``) as one on the mesh's
    first device (the first replica of a replicated data axis)."""
    home = lay.home
    blocks = [parts[i].to(home) for i in lay.data_owners()]
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim)


def _sh_masks(lay, mask):
    nd, nm = lay.shape
    return [[lay.cut(mask, i, j) for j in range(nm)] for i in range(nd)]


def _sh_decode_step(params, w_out, arena, u, mask, ens_weights, *, batched,
                    ensemble):
    lay = arena.layout
    nd, nm = lay.shape
    w_cells = lay.readouts(w_out)
    masks = _sh_masks(lay, mask)
    states, ys = [], []
    for i in range(nd):
        row = arena.cells[i]
        y_fb = [c.y_prev for c in row]
        new = _tick(lay, i, [c.states for c in row],
                    [lay.cut(u, i, j) for j in range(nm)], y_fb,
                    batched=batched)
        states.append([torch.where(masks[i][j][:, None], new[j], row[j].states)
                       for j in range(nm)])
        if w_out is not None:
            ys.append(_partial_readout(lay, i, w_cells[i], states[i],
                                       y_fb[0]))
    if w_out is None:
        cells = [[dataclasses.replace(arena.cells[i][j], states=states[i][j])
                  for j in range(nm)] for i in range(nd)]
        return _with_cells(arena, cells), arena.y_prev
    ys = _sh_ensemble(lay, ys, [m[0] for m in masks], ens_weights, ensemble)
    y_out = [torch.where(masks[i][0][:, None], ys[i], arena.cells[i][0].y_prev)
             for i in range(nd)]
    cells = [[dataclasses.replace(arena.cells[i][j], states=states[i][j],
                                  y_prev=y_out[i].to(lay.devices[i, j]))
              for j in range(nm)] for i in range(nd)]
    return _with_cells(arena, cells), _join_rows(lay, y_out)


def _sh_closed_loop(params, w_out, arena, mask, n_steps, ens_weights, *,
                    batched, ensemble):
    lay = arena.layout
    nd, nm = lay.shape
    w_cells = lay.readouts(w_out)
    masks = _sh_masks(lay, mask)
    m0 = [m[0] for m in masks]
    states = [[c.states for c in row] for row in arena.cells]
    y = [row[0].y_prev for row in arena.cells]
    if ensemble in ("mean", "weighted"):
        red = _sh_ensemble(lay, y, m0, ens_weights, ensemble)
        y = [torch.where(m0[i][:, None], red[i], y[i]) for i in range(nd)]
    ys = [[] for _ in range(nd)]
    for _ in range(int(n_steps)):
        y_new = []
        for i in range(nd):
            y_i = [y[i].to(lay.devices[i, j]) for j in range(nm)]
            new = _tick(lay, i, states[i], y_i, y_i, batched=batched)
            states[i] = [torch.where(masks[i][j][:, None], new[j],
                                     states[i][j]) for j in range(nm)]
            y_new.append(_partial_readout(lay, i, w_cells[i], states[i],
                                          y[i]))
        y_new = _sh_ensemble(lay, y_new, m0, ens_weights, ensemble)
        y = [torch.where(m0[i][:, None], y_new[i], y[i]) for i in range(nd)]
        for i in range(nd):
            ys[i].append(y[i])
    cells = [[dataclasses.replace(arena.cells[i][j], states=states[i][j],
                                  y_prev=y[i].to(lay.devices[i, j]))
              for j in range(nm)] for i in range(nd)]
    out = [torch.stack(ys[i]) if ys[i] else y[i].new_zeros(
        (0,) + tuple(y[i].shape)) for i in range(nd)]
    return _with_cells(arena, cells), _join_rows(lay, out, 1)


def _sh_closed_loop_route(params, w_out, arena, *, ensemble):
    lay = arena.layout
    if w_out is None or params.mode != "diag" or lay.split_model:
        return "step"
    if ensemble in ("mean", "weighted") and lay.split_data:
        return "step"
    return closed_loop_route(lay.params[0, 0], lay.readouts(w_out)[0, 0],
                             arena.cells[0][0], ensemble=ensemble)


def _sh_closed_loop_fused(params, w_out, arena, mask, n_steps, ens_weights,
                          *, batched, ensemble, method):
    if _sh_closed_loop_route(params, w_out, arena,
                             ensemble=ensemble) == "step":
        return _sh_closed_loop(params, w_out, arena, mask, n_steps,
                               ens_weights, batched=batched,
                               ensemble=ensemble)
    lay = arena.layout
    nd, nm = lay.shape
    w_cells = lay.readouts(w_out)
    cells = [list(row) for row in arena.cells]
    ys = []
    for i in range(nd):
        for j in range(nm):
            cells[i][j], y = closed_loop_fused(
                lay.params[i, j], w_cells[i, j], cells[i][j],
                lay.cut(mask, i, j), n_steps, lay.cut(ens_weights, i, j),
                batched=batched, ensemble=ensemble, method=method)
            if j == 0:
                ys.append(y)
    return _with_cells(arena, cells), _join_rows(lay, ys, 1)


def _prefill_split(lay, i, w_row, row, loc, u, lengths, y_teacher, *,
                   batched, method, chunk, want_outputs):
    """:func:`prefill_wave` of data shard ``i`` on a split model axis: one
    scan a model shard over its columns (diag), or the dense recurrence
    with each step's columns gathered (standard); the readout partial a
    model shard.  Returns the shard's new cells and outputs."""
    nm = len(row)
    devs = [lay.devices[i, j] for j in range(nm)]
    dev0 = devs[0]
    idx = [_dev_index(loc, d) for d in devs]
    prm = [lay.params[i, j] for j in range(nm)]
    if batched:
        prm = [_rows(prm[j], idx[j]) for j in range(nm)]
    w = None if w_row is None else list(w_row)
    if w is not None and w[0].ndim == 3:
        w = [w[j][idx[j]] for j in range(nm)]
    cfg = prm[0].cfg
    u, lengths = u.to(dev0), lengths.to(dev0)
    y0 = row[0].y_prev[idx[0]]
    y_shift = None
    if cfg.use_feedback:
        y_teacher = y_teacher.to(dev0)
        y_shift = torch.cat([y0[:, None], y_teacher[:, :-1]], 1)

    def on(t, j):
        return None if t is None else t.to(devs[j])
    drives = [esn_fn.drive(prm[j], on(u, j), on(y_shift, j))
              for j in range(nm)]
    if lay.partial:
        states = [esn_fn.scan_states(prm[j], drives[j],
                                     row[j].states[idx[j]], method=method,
                                     chunk=chunk) for j in range(nm)]
    else:
        r, seq = row[0].states[idx[0]], []
        for t in range(u.shape[1]):
            r = torch.cat([esn_fn.step_states(prm[j], on(r, j),
                                              drives[j][..., t, :]).to(dev0)
                           for j in range(nm)], -1)
            seq.append(r)
        full = torch.stack(seq, -2)
        states = [on(full, j) for j in range(nm)]
    rows = [torch.arange(u.shape[0], device=d) for d in devs]
    last_t = [on(lengths - 1, j) for j in range(nm)]
    last = [states[j][rows[j], last_t[j]] for j in range(nm)]
    valid = (torch.arange(u.shape[1], device=dev0)[None, :]
             < lengths[:, None])[..., None]
    if cfg.use_feedback:
        y_next = y_teacher[rows[0], last_t[0]]
    if w is None:
        out = None
        if want_outputs:
            full = (torch.cat([on(s, 0) for s in states], -1) if lay.partial
                    else states[0])
            out = torch.where(valid, full, 0.0)
        y_next = y_next if cfg.use_feedback else y0
    elif want_outputs:
        y = _partial_readout(lay, i, w, states, y_shift)
        out = torch.where(valid, y, 0.0)
        if not cfg.use_feedback:
            y_next = y[rows[0], last_t[0]]
    else:
        out = None
        if not cfg.use_feedback:
            y_next = _partial_readout(lay, i, w, last, None)
    cells = [dataclasses.replace(
        row[j], states=row[j].states.index_copy(0, idx[j], last[j]),
        y_prev=row[j].y_prev.index_copy(0, idx[j], on(y_next, j)))
        for j in range(nm)]
    return cells, out


def _sh_prefill_wave(params, w_out, arena, slots, u, lengths, y_teacher, *,
                     batched, method, chunk, want_outputs):
    lay = arena.layout
    nm = lay.shape[1]
    w_cells = lay.readouts(w_out)
    cells = [list(row) for row in arena.cells]
    outs = []
    for i, (pos, loc) in _by_shard(lay, _slot_list(slots)).items():
        pos_t = torch.tensor(pos, device=u.device)
        u_i, len_i = u[pos_t], lengths[pos_t]
        yt_i = None if y_teacher is None else y_teacher[pos_t]
        w_row = None if w_cells is None else w_cells[i]
        if lay.split_model:
            cells[i], out = _prefill_split(
                lay, i, w_row, cells[i], loc, u_i, len_i, yt_i,
                batched=batched, method=method, chunk=chunk,
                want_outputs=want_outputs)
        else:
            for j in range(nm):
                dev = lay.devices[i, j]
                cells[i][j], o = prefill_wave(
                    lay.params[i, j], None if w_row is None else w_row[j],
                    cells[i][j], _dev_index(loc, dev), u_i.to(dev),
                    len_i.to(dev), None if yt_i is None else yt_i.to(dev),
                    batched=batched, method=method, chunk=chunk,
                    want_outputs=want_outputs)
                out = o if j == 0 else out
        if i in lay.data_owners():
            outs.append((pos_t, out))
    new = _with_cells(arena, cells)
    if not want_outputs:
        return new, None
    home = lay.home
    if len(outs) == 1 and outs[0][0].numel() == u.shape[0]:
        return new, outs[0][1].to(home)
    full = outs[0][1].new_empty((u.shape[0],) + tuple(outs[0][1].shape[1:]),
                                device=home)
    for pos_t, out in outs:
        full.index_copy_(0, pos_t.to(home), out.to(home))
    return new, full
