"""Learn plane — streaming Gram accumulation, batched refit waves, the
per-tenant readout pool entries, and drift-triggered DPG ensemble growth.

The engine is a training system too (``learn=True``): every ``observe()``
teacher token both corrects the feedback column AND accumulates the
session's eigenbasis Gram sufficient statistics ``(G, C)``
(``core.ridge.gram_streaming`` rows, λ-decayed so old regimes fade);
:meth:`LearnPlane.refit_wave` solves ``ridge_solve_general(G, C,
eet_metric, α)`` for every dirty session as ONE batched solve on the
engine's device.  When a session's held-out streaming RMSE drifts past
``drift_threshold``, a fresh ``dpg_params`` reservoir member is sampled
on demand (DPG: O(N), no diagonalization) and folded into that session's
ensemble with validation-RMSE-weighted voting.

Training rows are buffered on the host (one batched copy of the post-step
arena per ``decode_step``, :meth:`LearnPlane.cache_post_step`) and folded
at refit time: one upload and one batched Gram per refit wave, never a
launch per token.  The refit's Cholesky runs on the device; a system it
cannot factor raises (nothing falls back to the host or to least squares).

Layering: this module imports only ``core`` and ``serve.arena`` — never
the exec or ingest planes or the engine facade.  Cross-plane effects
(scattering refit results into the exec plane's device pool, charging the
decode budget) go through callbacks the facade wires at construction.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Hashable, List, Optional

import numpy as np
import torch

from ..core import esn as esn_fn
from ..core import ridge as ridge_mod
from ..core.params import _leaf_names
from . import arena as arena_mod

__all__ = ["LearnPlane", "_GramAcc", "_Member", "_LearnState"]


def _host(v, dtype) -> np.ndarray:
    """``v`` (tensor on any device, or array) as a host array of ``dtype``."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype)


@dataclasses.dataclass
class _GramAcc:
    """Streaming sufficient statistics for one readout: the folded
    eigenbasis Gram pair ``(G, C)`` (device tensors) plus the not-yet-folded
    host row buffers and the held-out drift EWMA buffers (pre-observe
    prediction vs truth — prequential, so the 'validation' set is every
    teacher token *before* it trains)."""
    gram: Optional[torch.Tensor] = None     # folded (F, F)
    cg: Optional[torch.Tensor] = None       # folded (F, D_out)
    pairs: int = 0                          # rows folded so far
    skip_left: int = 0                      # washout rows still to discard
    drift: Optional[float] = None           # EWMA of held-out squared error
    buf_h: List = dataclasses.field(default_factory=list)
    buf_fb: List = dataclasses.field(default_factory=list)
    buf_y: List = dataclasses.field(default_factory=list)
    buf_pred: List = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Member:
    """A DPG-grown ensemble member: its own freshly sampled reservoir
    advancing in lock-step with the session's teacher stream from ``h=0``
    (the echo state property synchronizes it), plus its own
    :class:`_GramAcc`.  Its readout ``w`` stays None (no vote) until the
    first refit wave solves it."""
    params: object
    h: torch.Tensor                         # (N,) member state
    y_fb: torch.Tensor                      # member's own feedback column
    w: Optional[torch.Tensor] = None        # (F, D_out) once refit-trained
    steps_since_fb: int = 0
    pred_last: Optional[torch.Tensor] = None
    acc: _GramAcc = dataclasses.field(default_factory=_GramAcc)
    metric: Optional[torch.Tensor] = None   # cached EET metric


@dataclasses.dataclass
class _LearnState:
    """Per-session learn state (host-side, plane-owned; it does not travel
    through the session store: a parked session keeps its ``(G, C)`` as it
    keeps its uncollected decode buffer).  ``steps_since_fb`` gates
    accumulation: a feature row is a training pair only when exactly ONE
    decode step ran since the last teacher token."""
    tenant: Optional[Hashable] = None
    last_fb: Optional[np.ndarray] = None    # teacher value forced last
    steps_since_fb: int = 0
    dirty: bool = False
    acc: _GramAcc = dataclasses.field(default_factory=_GramAcc)
    members: List = dataclasses.field(default_factory=list)


def _fold_rows(params, h, fb, y, g0, c0, lam: float):
    """The refit fold: assemble the feature rows, apply the λ-decay row
    weights λ^((m-1-i)/2), accumulate the (G, C) Gram pair, and (when prior
    stats exist) decay-combine them.  Leading axes of ``h`` / ``fb`` /
    ``y`` / ``g0`` / ``c0`` are sessions: one batched Gram folds a whole
    refit wave (the JAX package's vmap)."""
    x = esn_fn.assemble_features(params, h, fb)
    m = x.shape[-2]
    if lam < 1.0:
        w = lam ** (torch.arange(m - 1, -1, -1, dtype=x.dtype,
                                 device=x.device) / 2.0)
        x = x * w[:, None]
        y = y * w[:, None]
    g, c = ridge_mod.gram_streaming(x, y)
    if g0 is not None:
        decay = lam ** m
        g = decay * g0 + g
        c = decay * c0 + c
    return g, c


class LearnPlane:
    """Owns every learn-while-serving structure: the per-session
    :class:`_LearnState` table, the per-tenant readout-pool *entries* (the
    device-side per-slot gather lives in the exec plane), the batched refit
    solver, and the post-step snapshot ``decode_step`` takes for observe().

    Facade-wired callbacks (never imported): ``session_slot(sid)`` resolves
    a hot session's slot, ``activate_pool()`` / ``sync_readouts(pairs)``
    scatter refit results into the exec plane's device pool,
    ``hot_serving(keys)`` lists the hot (sid, slot) pairs serving any of
    ``keys``, and ``charge(us)`` bills wave cost to the decode deadlines.
    """

    def __init__(self, params, cfg, dtype, *, batched: bool, enabled: bool,
                 tracker, refit_alpha: float, refit_decay: float,
                 refit_washout: int, drift_threshold: Optional[float],
                 drift_beta: float, growth_max: int, growth_sigma: float,
                 growth_washout: int, cost_model=None, autotune: bool = False):
        self.params = params
        self.cfg = cfg
        self._dtype = dtype
        self._np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self.device = params.device
        self._batched = bool(batched)
        self.enabled = bool(enabled)
        self.tracker = tracker
        self.cost_model = cost_model
        self._autotune = bool(autotune)
        self._refit_alpha = float(refit_alpha)
        self._refit_decay = float(refit_decay)
        self._refit_washout = int(refit_washout)
        self._drift_threshold = (None if drift_threshold is None
                                 else float(drift_threshold))
        self._drift_beta = float(drift_beta)
        self._growth_max = int(growth_max)
        self._growth_sigma = float(growth_sigma)
        self._growth_washout = int(growth_washout)
        self._growth_seed = int(getattr(cfg, "seed", 0) or 0) + 7001
        self.state: Dict[Hashable, _LearnState] = {}
        self.readouts: Dict[Hashable, torch.Tensor] = {}
        self._metric_cache: Dict[Hashable, torch.Tensor] = {}
        self._acc_cache = None          # (states_ref, states_np, y_prev_np)
        # Facade-wired cross-plane callbacks (see class docstring).
        self.session_slot = lambda sid: None
        self.activate_pool = lambda: None
        self.sync_readouts = lambda pairs: None
        self.hot_serving = lambda keys: []
        self.charge = lambda us: None

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v, self._np_dtype),
                               device=self.device)

    # ------------------------------------------------------- session table
    def note_admission(self, sid, tenant) -> None:
        """Create the session's learn state at admission (an engine with
        ``learn=False`` and no tenant key never allocates one)."""
        if tenant is None and not self.enabled:
            return
        ls = self.state.setdefault(sid, _LearnState())
        if tenant is not None:
            ls.tenant = tenant
        if ls.acc.pairs == 0 and not ls.acc.buf_h:
            ls.acc.skip_left = self._refit_washout

    def pop(self, sid) -> None:
        self.state.pop(sid, None)

    def clear(self) -> None:
        self.state.clear()
        self.readouts.clear()
        self._acc_cache = None

    def readout_key(self, sid) -> Hashable:
        """The readout-pool key serving ``sid``: its tenant when one was
        given at submit, else the sid itself (a private per-session pool)."""
        ls = self.state.get(sid)
        return sid if ls is None or ls.tenant is None else ls.tenant

    def pool_entry(self, sid):
        """The pool readout serving ``sid``, or None (the base readout)."""
        return self.readouts.get(self.readout_key(sid))

    def dirty_sids(self) -> List[Hashable]:
        return [s for s, ls in self.state.items() if ls.dirty]

    # --------------------------------------------------- pairing bookkeeping
    def note_steps(self, sids) -> None:
        """One teacher-forcible decode step elapsed for ``sids`` — the
        pairing counter observe() accumulation keys on."""
        if not self.state:
            return
        for sid in sids:
            ls = self.state.get(sid)
            if ls is not None:
                ls.steps_since_fb += 1

    def note_freerun(self, sids, n: int) -> None:
        """Free-running tokens break the teacher pairing: the next observe
        of these sessions forms no training pair, and grown members — which
        do not free-run — fall out of state sync and re-washout."""
        if not self.state:
            return
        for sid in sids:
            ls = self.state.get(sid)
            if ls is None:
                continue
            ls.steps_since_fb += n
            for mb in ls.members:
                mb.steps_since_fb += n
                mb.acc.skip_left = max(mb.acc.skip_left,
                                       self._growth_washout)

    def on_prompt_done(self, sid, y_teacher_last) -> None:
        """The prompt is the washout: the final teacher row re-arms the
        (state, feedback, truth) pairing, so the next decode_step + observe
        forms exactly the row offline ``fit(washout=T_prompt)`` keeps first.
        Grown members do not ride prefill waves; they resynchronize off the
        teacher stream and re-washout."""
        ls = self.state.get(sid)
        if ls is None:
            return
        ls.steps_since_fb = 0
        if self.cfg.use_feedback and y_teacher_last is not None:
            ls.last_fb = _host(y_teacher_last, self._np_dtype)
        for mb in ls.members:
            mb.steps_since_fb = 0
            mb.acc.skip_left = max(mb.acc.skip_left, self._growth_washout)
            if ls.last_fb is not None:
                mb.y_fb = self._tensor(ls.last_fb)

    def cache_post_step(self, arena) -> None:
        """ONE device-to-host copy of the post-step arena's (states, y_prev)
        for the observe() accumulation that typically follows (per-session
        row pulls would cost a copy per sid per token); keyed on the states
        tensor's identity, so any other wave invalidates it."""
        if not self.state:
            return
        both = torch.cat([arena.states, arena.y_prev], 1).cpu().numpy()
        n = arena.states.shape[1]
        self._acc_cache = (arena.states, both[:, :n], both[:, n:])

    def on_observe(self, sid, slot: int, y, arena) -> None:
        """The observe() accumulation: closes a (state, feedback, truth)
        training row IF exactly one decode step separates it from the
        previous teacher event.  ``y``: the teacher row, a host array.  The
        pre-observe ``y_prev`` is the model's prediction for this very
        token: it feeds the held-out drift EWMA before the truth overwrites
        it."""
        ls = self.state.get(sid) if self.enabled else None
        if ls is None:
            return
        y_np = _host(y, self._np_dtype)
        if ls.steps_since_fb == 1 and (not self.cfg.use_feedback
                                       or ls.last_fb is not None):
            cache = self._acc_cache
            if cache is not None and cache[0] is arena.states:
                # decode_step's snapshot: no extra copy, and the y_prev row
                # is the PRE-observe prediction even when an earlier observe
                # this step rewrote the arena.
                h_row, pred = cache[1][slot], cache[2][slot]
            else:
                h_row = arena.states[slot]
                pred = arena.y_prev[slot]
            if self._acc_pair(ls.acc, h_row, ls.last_fb, y_np, pred):
                ls.dirty = True
            for mb in ls.members:
                if mb.steps_since_fb == 1:
                    if self._acc_pair(
                            mb.acc, mb.h, mb.y_fb, y_np,
                            mb.pred_last if mb.w is not None else None):
                        ls.dirty = True
        if ls.members:
            y_dev = self._tensor(y_np)
        for mb in ls.members:
            # Teacher forcing resynchronizes every member's feedback channel
            # whether or not a pair formed.
            mb.y_fb = y_dev
            mb.steps_since_fb = 0
        ls.last_fb = y_np
        ls.steps_since_fb = 0

    def _acc_pair(self, acc: _GramAcc, h, fb, y_np, pred) -> bool:
        """Buffer one (state, feedback, truth) training row as host copies
        (the fold uploads them in one piece), and the pre-observe prediction
        for the drift EWMA.  Returns whether a training row was kept
        (washout rows only feed drift)."""
        if pred is not None:
            acc.buf_pred.append((_host(pred, self._np_dtype), y_np))
        if acc.skip_left > 0:
            acc.skip_left -= 1
            return False
        acc.buf_h.append(_host(h, self._np_dtype))
        acc.buf_fb.append(None if fb is None else _host(fb, self._np_dtype))
        acc.buf_y.append(y_np)
        return True

    # ---------------------------------------------------------------- folds
    def _fold_grouped(self, sids) -> None:
        """Batch the session folds of one refit wave: sessions sharing the
        engine params, one window length and one prior-stats shape fold in
        ONE batched :func:`_fold_rows` call — at the steady serve cadence
        that is all of them.  Stragglers fall through to the per-session
        :meth:`_fold_acc`."""
        lam = self._refit_decay
        use_fb = self.cfg.use_feedback
        groups: Dict[tuple, list] = {}
        for sid in sids:
            acc = self.state[sid].acc
            m = len(acc.buf_h)
            if not m or (use_fb and any(f is None for f in acc.buf_fb)):
                continue
            groups.setdefault((m, acc.gram is None), []).append(acc)
        for (m, fresh), accs in groups.items():
            if len(accs) < 2:
                continue              # a lone fold gains nothing
            h = self._tensor(np.stack([np.stack(a.buf_h) for a in accs]))
            y = self._tensor(np.stack([np.stack(a.buf_y) for a in accs]))
            fb = (self._tensor(np.stack([np.stack(a.buf_fb) for a in accs]))
                  if use_fb else None)
            g0 = c0 = None
            if not fresh:
                g0 = torch.stack([a.gram for a in accs])
                c0 = torch.stack([a.cg for a in accs])
            g, c = _fold_rows(self.params, h, fb, y, g0, c0, lam)
            for i, acc in enumerate(accs):
                acc.gram, acc.cg = g[i], c[i]
                acc.pairs += m
                acc.buf_h.clear()
                acc.buf_fb.clear()
                acc.buf_y.clear()

    def _fold_acc(self, acc: _GramAcc, params) -> None:
        """Fold the buffered rows into the running ``(G, C)`` — λ-decayed:
        row i of an m-row window weighs λ^(m-1-i) in both G and C, and the
        folded stats decay by λ^m (the weights one decayed offline fit over
        the whole stream uses).  Also folds the buffered predictions into
        the drift EWMA."""
        m = len(acc.buf_h)
        if m:
            h = self._tensor(np.stack(acc.buf_h))
            y = self._tensor(np.stack(acc.buf_y))
            fb = (self._tensor(np.stack(acc.buf_fb))
                  if self.cfg.use_feedback else None)
            acc.gram, acc.cg = _fold_rows(params, h, fb, y, acc.gram, acc.cg,
                                          self._refit_decay)
            acc.pairs += m
            acc.buf_h.clear()
            acc.buf_fb.clear()
            acc.buf_y.clear()
        if acc.buf_pred:
            preds = np.stack([p for p, _ in acc.buf_pred])
            ys = np.stack([t for _, t in acc.buf_pred])
            errs = np.mean((preds - ys) ** 2, axis=1)
            acc.buf_pred.clear()
            b = self._drift_beta
            d = acc.drift
            for e in errs:
                d = float(e) if d is None else b * d + (1.0 - b) * float(e)
            acc.drift = d

    def _session_params(self, sid):
        """The param struct whose features / metric govern ``sid``'s refit:
        the slot's reservoir on a param-batched engine (slot i IS reservoir
        i, and batched engines never park, so the slot is live)."""
        if not self._batched:
            return self.params
        slot = self.session_slot(sid)
        p = self.params
        return dataclasses.replace(p, **{
            k: None if getattr(p, k) is None else getattr(p, k)[slot]
            for k in _leaf_names(p)})

    def _metric(self, params) -> torch.Tensor:
        """The refit metric: EET blockdiag(I, QᵀQ) for diag params (paper
        Eq. 29 — refit trains in the eigenbasis), identity for standard."""
        if params.mode == "diag":
            return esn_fn.eet_metric(params)
        return torch.eye(self.cfg.n_features, dtype=self._dtype,
                         device=self.device)

    def _metric_of(self, params, cache_key: Hashable = None):
        """:meth:`_metric`, cached under ``cache_key`` (the slot on a
        param-batched engine, None otherwise): a constant of the frozen
        params that costs more to build than the solve."""
        m = self._metric_cache.get(cache_key)
        if m is None:
            m = self._metric_cache[cache_key] = self._metric(params)
        return m

    # ------------------------------------------------------------- ensemble
    def _maybe_grow(self, sid, ls: _LearnState) -> None:
        """DPG ensemble growth: when the session's held-out streaming RMSE
        drifts past the threshold, sample a fresh reservoir member
        (``dpg_params`` from seed ``cfg.seed + 7001 + k``) starting at h=0;
        it votes only after its first refit.  The drift EWMA resets so one
        excursion cannot cascade to ``growth_max_members``."""
        if (self._drift_threshold is None or self._batched
                or ls.acc.drift is None
                or len(ls.members) >= self._growth_max
                or ls.acc.drift ** 0.5 <= self._drift_threshold):
            return
        self._growth_seed += 1
        p = esn_fn.dpg_params(
            dataclasses.replace(self.cfg, seed=self._growth_seed),
            "noisy_golden", sigma=self._growth_sigma, device=self.device)
        fb0 = (torch.zeros((self.cfg.d_out,), dtype=self._dtype,
                           device=self.device)
               if ls.last_fb is None else self._tensor(ls.last_fb))
        mb = _Member(params=p, h=torch.zeros((self.cfg.n,), dtype=self._dtype,
                                             device=self.device), y_fb=fb0)
        mb.acc.skip_left = self._growth_washout
        ls.members.append(mb)
        ls.acc.drift = None
        self.tracker.log_wave({"kind": "growth", "sid": sid,
                               "members": len(ls.members)})

    def vote(self, sid, u_vec, y_primary):
        """The decode_step ensemble hook: a session with grown members
        returns the validation-RMSE-weighted vote over primary + members
        (the members advance here, teacher-driven off the same input)."""
        ls = self.state.get(sid)
        if ls is None or not ls.members:
            return y_primary
        return self._step_members(ls, u_vec, y_primary)

    def _step_members(self, ls: _LearnState, u_vec, y_primary):
        """Advance the session's members one teacher-driven step and return
        the weighted vote over primary + members (weight 1/(mse+eps);
        members without a trained readout or a drift estimate abstain)."""
        u = self._tensor(u_vec)[None]
        w0 = (1.0 if ls.acc.drift is None
              else 1.0 / (ls.acc.drift + 1e-6))
        votes = [(np.asarray(y_primary, np.float64), w0)]
        for mb in ls.members:
            fb_col = mb.y_fb[None] if self.cfg.use_feedback else None
            h = esn_fn.step_states(mb.params, mb.h[None],
                                   esn_fn.drive(mb.params, u, fb_col))[0]
            mb.h = h
            mb.steps_since_fb += 1
            if mb.w is None:
                continue
            x = esn_fn.assemble_features(mb.params, h[None], fb_col)
            pred = arena_mod.apply_readout(mb.w, x)[0]
            mb.pred_last = pred
            mb.y_fb = pred
            if mb.acc.drift is not None:
                votes.append((_host(pred, np.float64),
                              1.0 / (mb.acc.drift + 1e-6)))
        if len(votes) == 1:
            return y_primary
        total = sum(w for _, w in votes)
        fused = sum(p * w for p, w in votes) / total
        return fused.astype(np.asarray(y_primary).dtype)

    def drift_rmse(self, sid) -> Optional[float]:
        """The session's held-out streaming RMSE estimate (sqrt of the
        prequential squared-error EWMA), folding any buffered rows first.
        None until a post-washout teacher pair landed."""
        ls = self.state.get(sid)
        if ls is None:
            return None
        self._fold_acc(ls.acc, self._session_params(sid))
        return None if ls.acc.drift is None else ls.acc.drift ** 0.5

    # ---------------------------------------------------------------- refit
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def refit_wave(self, sids, *, alpha: Optional[float] = None
                   ) -> Dict[Hashable, torch.Tensor]:
        """The batched refit wave: fold every target's buffers, stack the
        (G, C, metric) rows (sessions and their grown members), ONE batched
        generalized ridge solve, and scatter the results into the readout
        pool (and, through ``sync_readouts``, the exec plane's device
        pool).  Timed to a wait for the solve; under autotune the time feeds
        the cost model's ``c_refit(B)`` surface, and the decode deadlines
        are charged either way."""
        if not sids:
            return {}
        a = self._refit_alpha if alpha is None else float(alpha)
        t0 = time.perf_counter()
        if not self._batched:
            self._fold_grouped(sids)
        rows = []                     # (sid, member-or-None, g, c, metric)
        for sid in sids:
            ls = self.state[sid]
            p = self._session_params(sid)
            self._fold_acc(ls.acc, p)
            if ls.acc.gram is not None:
                rows.append((sid, None, ls.acc.gram, ls.acc.cg,
                             self._metric_of(
                                 p, self.session_slot(sid)
                                 if self._batched else None)))
            for mb in ls.members:
                self._fold_acc(mb.acc, mb.params)
                if mb.acc.gram is not None:
                    if mb.metric is None:
                        mb.metric = self._metric(mb.params)
                    rows.append((sid, mb, mb.acc.gram, mb.acc.cg,
                                 mb.metric))
            self._maybe_grow(sid, ls)
            ls.dirty = False
        if not rows:
            return {}
        w = ridge_mod.ridge_solve_general(torch.stack([r[2] for r in rows]),
                                          torch.stack([r[3] for r in rows]),
                                          torch.stack([r[4] for r in rows]),
                                          a)
        self._sync()
        us = (time.perf_counter() - t0) * 1e6
        self.tracker.log_wave({"kind": "refit", "rows": len(rows),
                               "us": us})
        if self._autotune and self.cost_model is not None:
            self.cost_model.observe_refit(len(rows), us)
        self.charge(us)
        out: Dict[Hashable, torch.Tensor] = {}
        touched = set()
        for (sid, mb, *_), wi in zip(rows, w):
            if mb is None:
                self.activate_pool()
                key = self.readout_key(sid)
                self.readouts[key] = wi
                touched.add(key)
                out[sid] = wi
            else:
                mb.w = wi
        if touched:
            # One scatter for every hot session serving any refit key.
            self.sync_readouts(self.hot_serving(touched))
        return out
