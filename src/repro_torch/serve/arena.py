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
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import dispatch as dispatch_mod
from ..core import esn as esn_fn

__all__ = [
    "SlotArena",
    "make_arena",
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
    return SlotArena(states=_set_row(arena.states, slot, h0),
                     y_prev=_set_row(arena.y_prev, slot, y0),
                     active=_set_row(arena.active, slot, True))


def place_many(arena: SlotArena, slots, h0s, y0s) -> SlotArena:
    """Write a whole wave of sessions in ONE scatter per tensor."""
    return SlotArena(states=arena.states.index_copy(0, slots, h0s),
                     y_prev=arena.y_prev.index_copy(0, slots, y0s),
                     active=arena.active.index_fill(0, slots, True))


def gather_rows(arena: SlotArena, slots):
    """``slots``'s (states, y_prev) rows, on the arena's device."""
    return arena.states[slots], arena.y_prev[slots]


def release(arena: SlotArena, slot: int) -> SlotArena:
    """Mark ``slot`` free.  The state tensors are left as they are."""
    return dataclasses.replace(arena,
                               active=_set_row(arena.active, slot, False))


def release_many(arena: SlotArena, slots) -> SlotArena:
    """Free a whole wave of slots in ONE scatter."""
    return dataclasses.replace(arena,
                               active=arena.active.index_fill(0, slots, False))


def force_output(arena: SlotArena, slot: int, y_true) -> SlotArena:
    """Teacher-force ``slot``: overwrite its feedback output ``y_prev[slot]``
    with ground truth, leaving the recurrent state untouched — the next
    ``decode_step`` / ``closed_loop`` of that slot drives from the true
    output (``ReservoirEngine.observe``).  Returns the rebuilt arena."""
    return dataclasses.replace(arena,
                               y_prev=_set_row(arena.y_prev, slot, y_true))


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


def apply_readout(w_out, x, *, batched: bool = False):
    """Features (B, F) through the readout.  Per-slot readouts are inferred
    from shape: a (B, F, D) ``w_out`` pairs row b of ``x`` with readout b."""
    if batched or w_out.ndim == 3:
        return torch.einsum("bf,bfd->bd", x, w_out)
    return x @ w_out


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


def _readout_step(params, w_out, states, y_feat, mask, w_ens, *, batched,
                  ensemble):
    """The readout of one step (and its ensemble reduce): ``y_feat`` is the
    feedback column the features carry."""
    x = esn_fn.assemble_features(params, states, y_feat)
    y = apply_readout(w_out, x, batched=batched)
    if ensemble in ("mean", "weighted"):
        y = _ensemble_reduce(y, mask, w_ens if ensemble == "weighted"
                             else None)
    return y


def decode_step(params, w_out, arena: SlotArena, u, mask, ens_weights=None,
                *, batched: bool = False, ensemble: str = "off"):
    """Advance the masked slots one token.  Returns ``(arena', y)`` where
    unmasked rows of ``y`` hold their previous output."""
    new = arena_step(params, arena.states, u, arena.y_prev, batched=batched)
    states = torch.where(mask[:, None], new, arena.states)
    if w_out is None:
        return dataclasses.replace(arena, states=states), arena.y_prev
    y = _readout_step(params, w_out, states, arena.y_prev, mask, ens_weights,
                      batched=batched, ensemble=ensemble)
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
                              batched=batched, ensemble=ensemble)
        y = torch.where(mask[:, None], y_new, y)
        ys.append(y)
    ys = torch.stack(ys) if ys else y.new_zeros((0,) + tuple(y.shape))
    return dataclasses.replace(arena, states=states, y_prev=y), ys


def closed_loop_fused(params, w_out, arena: SlotArena, mask, n_steps: int,
                      ens_weights=None, *, batched: bool = False,
                      ensemble: str = "off"):
    """:func:`closed_loop` through the fused K-token decode kernel: one
    launch runs all ``n_steps`` (``core.dispatch.run_decode_fused`` — the
    CUDA kernel on the GPU, the plain version elsewhere), including the
    ``mean`` ensemble's reduce and seed.  Dense params, a missing readout or
    ``weighted`` voting (the kernel reduces by plain mean only, as in the
    JAX package) take the step-at-a-time path; the fused path reads
    ``batched`` from the shape of ``lam_q``."""
    if w_out is None or params.mode != "diag" or ensemble == "weighted":
        return closed_loop(params, w_out, arena, mask, n_steps, ens_weights,
                           batched=batched, ensemble=ensemble)
    cfg = params.cfg
    w_drive = (params.win_q + params.wfb_q if cfg.use_feedback
               else params.win_q)
    states, y_prev, ys = dispatch_mod.run_decode_fused(
        params.lam_q, params.n_real, w_drive, w_out, arena.states,
        arena.y_prev, mask, int(n_steps), use_bias=cfg.use_bias,
        use_feedback=cfg.use_feedback, ensemble=ensemble)
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
    """
    cfg = params.cfg
    h0 = arena.states[slots]
    y0 = arena.y_prev[slots]
    if batched:
        params = _rows(params, slots)
        w_out = None if w_out is None else w_out[slots]
    pooled = w_out is not None and w_out.ndim == 3
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
        x = esn_fn.assemble_features(params, states, y_shift)
        y = x @ w_out if not pooled else torch.einsum("btf,bfd->btd", x,
                                                      w_out)
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
