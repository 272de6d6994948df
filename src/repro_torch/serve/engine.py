"""ReservoirEngine — the thin facade over the serving planes.

Four planes with one-way imports, and this module the only one that sees
all of them: ``serve.telemetry`` (observability: ``Tracker`` seam +
``StatsAggregator``), ``serve.ingest`` (control: session table, admission,
backpressure), ``serve.exec_plane`` (data: the slot arena and every device
launch), ``serve.learn`` (streaming refit, drift, DPG growth).  Cross-plane
effects travel through callbacks this facade wires at construction.
Lifecycle: ``submit`` -> ``flush`` -> ``decode_step`` /
``decode_closed_loop`` / ``observe`` / ``queue_inputs`` -> ``release``;
with ``learn=True`` every ``observe`` also accumulates the session's
readout statistics and ``refit`` / ``flush(refit=True)`` re-solve them.

The engine runs on one device, the GPU unless ``device="cpu"`` is passed;
params and readout are moved there at construction.  ``mesh=`` (a
``launch.mesh.Mesh``) places the slot arena on a (data, model) device mesh
instead (``sharding.rules.plan_arena``: slots on ``data``, N on ``model``;
``serve.arena.ShardedArena``); the engine's device is then the mesh's
first, where it keeps the params and readout whole.  ``park_host_rows`` /
``cold_dir`` back the slot arena with the tiered session store
(``serve.store``: a host pool and a cold tier of ``.npz`` records),
and :meth:`ReservoirEngine.snapshot` / :meth:`ReservoirEngine.restore`
serialize the whole engine in the JAX package's snapshot layout.
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..launch.mesh import check_mesh
from ..core.params import DiagParams, Readout, StandardParams, params_to
from . import store as store_mod
from .cost import WaveCostModel, cost_key
from .exec_plane import DecodeResult, EvictResult, ExecPlane
from .ingest import AdmissionFull, IngestPlane, SessionStats, SessionTable
from .learn import LearnPlane
from .scheduler import WaveScheduler
from .telemetry import (EngineStats, MultiTracker, ProfilerTracker,
                        StatsAggregator, Tracker, make_tracker)

__all__ = ["SessionStats", "DecodeResult", "EvictResult", "EngineStats",
           "AdmissionFull", "ReservoirEngine"]

def _batch_size(params) -> int:
    """The number of reservoirs in a stacked (param-batched) struct."""
    lead = params.lam_q if params.mode == "diag" else params.w
    if lead.ndim != 2 + (params.mode == "standard"):
        raise ValueError("a param-batched engine needs a stacked param "
                         "struct (core.params.stack_params)")
    return int(lead.shape[0])


def _coerce_model(model, readout):
    """Accept a param struct or a ``LinearESN`` facade (its params, and its
    readout unless one is passed); normalize the readout."""
    if isinstance(model, (StandardParams, DiagParams)):
        params = model
    elif isinstance(getattr(model, "params", None),
                    (StandardParams, DiagParams)):
        params = model.params
        if readout is None:
            readout = model.readout
    else:
        raise ValueError(f"model must be a StandardParams or DiagParams "
                         f"struct or a LinearESN, got {type(model).__name__}")
    if readout is not None and not isinstance(readout, Readout):
        readout = Readout(readout if isinstance(readout, torch.Tensor)
                          else torch.tensor(np.asarray(readout)))
    return params, readout


class ReservoirEngine:
    """Batched multi-session serving over an immutable reservoir param
    struct.

    ``model``: a ``core.params`` struct or a ``LinearESN`` facade;
    ``readout``: its trained :class:`Readout` (the engine snapshots both at
    construction — build it after fitting).  ``decode_slo_us``: the
    engine-wide decode deadline that interleaved flushes hold (a session's
    own ``submit(decode_slo_us=)`` overrides it); ``decode_wave_tokens``:
    tokens per interleaved decode wave, or ``"auto"`` to pick K each flush
    from the cost model.  ``autotune`` times every wave and decode launch
    into the cost model (``cost_model``, built keyed by this device when
    autotune, a decode SLO or ``"auto"`` needs one).  ``tracker``: a
    ``serve.telemetry.Tracker`` or spec string (``"null"``,
    ``"jsonl:PATH"``); ``profile_dir`` adds ``torch.profiler`` capture
    windows (``tracker.capture(name)``).  ``max_queued`` bounds the
    admission queue.  ``pipeline_depth`` waves may stay in flight while the
    host plans the next; 0 waits after every wave.  ``park_host_rows``: the
    rows of the host pool behind the arena (a full arena then admits by
    parking its least-recently-used idle sessions, and touching a parked
    session promotes it); ``cold_dir``: the cold tier the pool spills to.
    ``device``: where the engine runs (``None`` means the GPU); ``mesh``:
    the device mesh its arena is sharded over (``device`` then must be of
    the mesh's device type, and is the mesh's first device).
    ``ensemble`` fuses the slots of a param batch (:meth:`from_param_batch`).
    ``learn=True``: learn while serving — ``observe`` accumulates each
    session's eigenbasis ``(G, C)`` (λ = ``refit_decay`` a token, the first
    ``refit_washout`` pairs dropped), :meth:`refit` solves them with
    ``refit_alpha`` (default ``cfg.ridge_alpha``) into the session's tenant
    pool entry (``submit(tenant=)``), and a session whose held-out RMSE
    (EWMA ``drift_beta``) passes ``drift_threshold`` grows up to
    ``growth_max_members`` DPG members (``growth_sigma``, washout
    ``growth_washout``) that vote weighted by their RMSE.
    """

    def __init__(self, model, max_slots: int = 8, *,
                 readout: Optional[Readout] = None, bucket_min: int = 16,
                 ensemble: str = "off", chunk_max: Optional[int] = None,
                 decode_wave_tokens=1, pipeline_depth: int = 2,
                 tracker=None, max_queued: Optional[int] = None,
                 device=None, mesh=None, autotune: bool = False,
                 cost_model: Optional[WaveCostModel] = None,
                 decode_slo_us: Optional[float] = None,
                 park_host_rows: Optional[int] = None,
                 cold_dir: Optional[str] = None, learn: bool = False,
                 refit_alpha: Optional[float] = None,
                 refit_decay: float = 1.0, refit_washout: int = 0,
                 drift_threshold: Optional[float] = None,
                 drift_beta: float = 0.9, growth_max_members: int = 3,
                 growth_sigma: float = 0.1, growth_washout: int = 64,
                 profile_dir: Optional[str] = None,
                 _param_batch: bool = False):
        params, readout = _coerce_model(model, readout)
        if mesh is not None:
            check_mesh(mesh)
            if device is not None and torch.device(device).type != \
                    mesh.home.type:
                raise ValueError(f"device={device!r} is not of the mesh's "
                                 f"device type {mesh.home.type!r}")
            device = mesh.home
        self.mesh = mesh
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        # The readout in default (row-major) strides: a snapshot stores it
        # so, and BLAS takes another route (other roundings) for a (F, 1)
        # readout strided as a column, as a ridge solve returns it — a
        # restored engine resumes bit for bit only on the same layout.
        self.readout = (None if readout is None else Readout(
            readout.w_out.to(self.device).clone(
                memory_format=torch.contiguous_format)))
        self.cfg = self.params.cfg
        self._batched = bool(_param_batch)
        self.max_slots = int(max_slots)
        if self.max_slots < 1:
            raise ValueError(
                f"max_slots must be >= 1, got {self.max_slots} (an engine "
                f"with 0 slots queues every session forever)")
        if self._batched:
            b = _batch_size(self.params)
            if self.max_slots != b:
                raise ValueError(
                    f"param batch of {b} reservoirs needs max_slots == {b}, "
                    f"got {self.max_slots} (slot i runs reservoir i)")
        if ensemble not in ("off", "mean", "weighted"):
            raise ValueError(f"ensemble must be 'off', 'mean' or 'weighted', "
                             f"got {ensemble!r}")
        if ensemble != "off" and not (self._batched and
                                      self.readout is not None):
            raise ValueError(
                f"ensemble={ensemble!r} fuses the per-reservoir predictions "
                f"of a param-batched engine — use from_param_batch with a "
                f"readout")
        self.ensemble = ensemble
        plan = None
        if mesh is not None:
            from ..sharding import rules as sharding_rules
            plan = sharding_rules.plan_arena(
                mesh, self.params, self.max_slots, batched=self._batched,
                readout=None if self.readout is None else self.readout.w_out)
        self._learn_knobs(learn, refit_alpha, refit_decay, refit_washout,
                          drift_threshold, drift_beta, growth_max_members,
                          growth_sigma, growth_washout)
        if int(pipeline_depth) < 0:
            raise ValueError(f"pipeline_depth must be >= 0, "
                             f"got {pipeline_depth}")
        if decode_slo_us is not None and decode_slo_us <= 0:
            raise ValueError(
                f"decode_slo_us must be positive (got {decode_slo_us}); "
                f"use None to disable decode-aware planning")
        # "auto" resolves K per interleaved flush from the fitted c_dec(B, K)
        # surface; 1 until then.
        decode_k_auto = decode_wave_tokens == "auto"
        if decode_k_auto:
            decode_wave_tokens = 1
        if not isinstance(decode_wave_tokens, (int, np.integer)):
            raise ValueError(
                f"decode_wave_tokens must be an int >= 1 or 'auto', "
                f"got {decode_wave_tokens!r}")
        if decode_wave_tokens < 1:
            raise ValueError(f"decode_wave_tokens must be >= 1, "
                             f"got {decode_wave_tokens}")
        decode_slo_us = (None if decode_slo_us is None
                         else float(decode_slo_us))
        self._autotune = bool(autotune)
        self._dtype = self.params.dtype
        # Paged session store: the arena becomes a cache of hot sessions
        # over a host pool and an optional cold tier.
        if cold_dir is not None and park_host_rows is None:
            raise ValueError(
                "cold_dir needs park_host_rows — the cold tier is the "
                "spill target of the host pool, not a direct demote target")
        if park_host_rows is not None and self._batched:
            raise ValueError(
                "param-batched engine: slot i IS reservoir i, so a parked "
                "session cannot be promoted into whichever slot is free — "
                "paging is unsupported (park/re-admit via release + "
                "submit(sid, h0=..., slot=...) instead)")
        self._park_host_rows = (None if park_host_rows is None
                                else int(park_host_rows))
        self._cold_dir = cold_dir
        store = None
        if self._park_host_rows is not None:
            # A synchronous engine gets a synchronous store (no I/O lane),
            # so the reference really is serialized end to end.
            store = store_mod.SessionStore(
                self.cfg.n, self.cfg.d_out,
                torch.empty((), dtype=self._dtype).numpy().dtype,
                host_rows=self._park_host_rows, cold_dir=cold_dir,
                io_workers=2 if int(pipeline_depth) > 0 else 0)
        # Decode-aware planning and page-wave pricing need a cost surface;
        # engine-built models are keyed by (device type, n, d_out), so
        # persisted observations never price another machine or model size.
        if cost_model is None and (autotune or decode_slo_us is not None
                                   or decode_k_auto or self._learn
                                   or store is not None):
            cost_model = WaveCostModel(key=cost_key(
                self.device.type, self.cfg.n, self.cfg.d_out))
        # Observability: the aggregator is always first in the fan-out, so
        # stats() counters and a user trace derive from the SAME events.
        self._agg = StatsAggregator()
        cuda = self.device.type == "cuda"
        if isinstance(tracker, Tracker):
            user: Optional[Tracker] = tracker
            if profile_dir:
                user = MultiTracker([user, ProfilerTracker(profile_dir,
                                                           cuda=cuda)])
        elif tracker is not None or profile_dir is not None:
            user = make_tracker(tracker, profile_dir=profile_dir, cuda=cuda)
        else:
            user = None
        self.tracker: Tracker = (MultiTracker([self._agg, user])
                                 if user is not None else self._agg)
        sched = WaveScheduler(bucket_min=bucket_min, chunk_max=chunk_max,
                              cost_model=cost_model)
        self._table = SessionTable(self.max_slots)
        self._exec = ExecPlane(
            self.params, self.readout, self.cfg, self._dtype,
            batched=self._batched, ensemble=self.ensemble,
            max_slots=self.max_slots, plan=plan,
            pipeline_depth=int(pipeline_depth),
            decode_slo_us=decode_slo_us,
            decode_wave_tokens=int(decode_wave_tokens),
            decode_k_auto=decode_k_auto, store=store, cost_model=cost_model,
            autotune=self._autotune, tracker=self.tracker,
            table=self._table, scheduler=sched)
        self._ingest = IngestPlane(
            self.cfg, self._exec._np_dtype, batched=self._batched,
            max_slots=self.max_slots, table=self._table, scheduler=sched,
            default_decode_slo_us=decode_slo_us, max_queued=max_queued)
        self._learn_plane = LearnPlane(
            self.params, self.cfg, self._dtype, batched=self._batched,
            enabled=self._learn, tracker=self.tracker,
            refit_alpha=self._refit_alpha, refit_decay=self._refit_decay,
            refit_washout=self._refit_washout,
            drift_threshold=self._drift_threshold,
            drift_beta=self._drift_beta, growth_max=self._growth_max,
            growth_sigma=self._growth_sigma,
            growth_washout=self._growth_washout,
            cost_model=cost_model, autotune=self._autotune)
        self._wire_planes()

    def _learn_knobs(self, learn, refit_alpha, refit_decay, refit_washout,
                     drift_threshold, drift_beta, growth_max_members,
                     growth_sigma, growth_washout) -> None:
        """Check and keep the learn-while-serving options, with the JAX
        engine's checks."""
        self._learn = bool(learn)
        if self._learn and self.readout is None:
            raise ValueError(
                "learn=True needs a base readout — streaming refit solves "
                "per-session readouts into a pool seeded from it")
        if self._learn and self.ensemble != "off":
            raise ValueError(
                "learn=True is per-session teacher attribution; a fused "
                "ensemble engine serves ONE logical stream — refit the "
                "members offline and set_ensemble_weights() instead")
        if not 0.0 < float(refit_decay) <= 1.0:
            raise ValueError(f"refit_decay must be in (0, 1], "
                             f"got {refit_decay}")
        if int(refit_washout) < 0:
            raise ValueError(f"refit_washout must be >= 0, "
                             f"got {refit_washout}")
        if drift_threshold is not None and drift_threshold <= 0:
            raise ValueError(f"drift_threshold must be positive (got "
                             f"{drift_threshold}); use None to disable "
                             f"DPG ensemble growth")
        if not 0.0 <= float(drift_beta) < 1.0:
            raise ValueError(f"drift_beta must be in [0, 1), "
                             f"got {drift_beta}")
        self._refit_alpha = float(self.cfg.ridge_alpha if refit_alpha is None
                                  else refit_alpha)
        self._refit_decay = float(refit_decay)
        self._refit_washout = int(refit_washout)
        self._drift_threshold = (None if drift_threshold is None
                                 else float(drift_threshold))
        self._drift_beta = float(drift_beta)
        self._growth_max = int(growth_max_members)
        self._growth_sigma = float(growth_sigma)
        self._growth_washout = int(growth_washout)

    def _wire_planes(self) -> None:
        """Cross-plane runtime effects travel through these callbacks so
        imports stay one-way; the closures read live facade state."""
        ex, ig, ln = self._exec, self._ingest, self._learn_plane
        # exec -> learn (teacher pairing, voting, refit) and -> ingest
        # (open-loop input queues).
        ex.note_admission = ln.note_admission
        ex.on_prompt_done = ln.on_prompt_done
        ex.note_freerun = ln.note_freerun
        ex.note_steps = ln.note_steps
        ex.cache_post_step = ln.cache_post_step
        ex.vote = ln.vote
        ex.on_observe = ln.on_observe
        ex.pool_entry = ln.pool_entry
        ex.learn_active = lambda: self._learn
        ex.dirty_sids = ln.dirty_sids
        ex.refit_wave = ln.refit_wave
        ex.input_depth = ig.input_depth
        ex.pop_inputs = ig.pop_inputs

        def forget(sid):
            # One release hook: the learn state leaves with the session and
            # its still-queued open-loop inputs are dropped.
            ln.pop(sid)
            ig.drop_inputs(sid)
        ex.pop_learn = forget
        # ingest -> exec (a pinned placement) and -> learn (learn state).
        ig.place = ex.place
        ig.note_admission = ln.note_admission
        ig.in_store = lambda sid: ex.store is not None and sid in ex.store
        # learn -> exec (refit results into the device pool) and -> the
        # session table / scheduler (slot resolve, wave-cost charge).
        ln.session_slot = lambda sid: self._table.sessions[sid].slot
        ln.activate_pool = ex.activate_pool
        ln.sync_readouts = ex.sync_slot_readouts
        ln.hot_serving = lambda keys: [
            (sid, st.slot) for sid, st in self._table.sessions.items()
            if ln.readout_key(sid) in keys]
        # Through the property: reset() swaps the scheduler instance.
        ln.charge = lambda us: self.scheduler.charge_decode_cost(us)

    @classmethod
    def from_param_batch(cls, params, readout=None, *, ensemble: str = "off",
                         **kwargs) -> "ReservoirEngine":
        """Engine over a *batch* of independently seeded reservoirs (a
        ``core.params.stack_params`` struct): slot ``i`` is bound to
        reservoir ``i`` and readout ``readout.w_out[i]`` ((B, F, D)).
        ``ensemble="mean"`` averages the B predictions into ONE output per
        step (B reservoirs vote on one stream; closed loop through the fused
        kernel's mean route), ``"weighted"`` by :meth:`set_ensemble_weights`
        (the step-at-a-time path, as in the JAX package).  ``kwargs``: the
        constructor's options."""
        if not isinstance(params, (StandardParams, DiagParams)):
            raise ValueError(f"from_param_batch takes a stacked param "
                             f"struct, got {type(params).__name__}")
        return cls(params, max_slots=_batch_size(params), readout=readout,
                   ensemble=ensemble, _param_batch=True, **kwargs)

    # ------------------------------------------------------------ plane views
    @property
    def scheduler(self) -> WaveScheduler:
        return self._exec.scheduler

    @scheduler.setter
    def scheduler(self, sched: WaveScheduler) -> None:
        self._exec.scheduler = sched
        self._ingest.scheduler = sched

    @property
    def arena(self):
        return self._exec.arena

    @property
    def states(self):
        return self._exec.arena.states

    @property
    def y_prev(self):
        return self._exec.arena.y_prev

    @property
    def sessions(self):
        return self._table.sessions

    @property
    def active_sessions(self):
        return self._table.active

    @property
    def ready_sessions(self):
        return self._table.ready

    @property
    def free_slots(self) -> int:
        return self._table.free_slots

    @property
    def pending(self):
        """The scheduler's queue (len/iter-able) — sessions awaiting a slot."""
        return self.scheduler

    @property
    def pipeline_depth(self) -> int:
        return self._exec.pipeline_depth

    @property
    def store(self):
        """The tiered session store (None on an unpaged engine)."""
        return self._exec.store

    @property
    def parked_sessions(self) -> List[Hashable]:
        """Sessions parked in the store's tiers (host pool or cold records):
        decodable through transparent promotion, absent from
        :attr:`active_sessions` / :attr:`ready_sessions` (the hot set)."""
        return [] if self.store is None else self.store.sids

    @property
    def cost_model(self):
        return self._exec.cost_model

    @cost_model.setter
    def cost_model(self, model) -> None:
        self._exec.cost_model = model
        self._learn_plane.cost_model = model
        self.scheduler.cost_model = model

    @property
    def decode_slo_us(self):
        return self._exec.decode_slo_us

    @decode_slo_us.setter
    def decode_slo_us(self, value) -> None:
        self._exec.decode_slo_us = value
        self._ingest.default_decode_slo_us = value

    @property
    def decode_wave_tokens(self) -> int:
        return self._exec.decode_wave_tokens

    @decode_wave_tokens.setter
    def decode_wave_tokens(self, value: int) -> None:
        self._exec.decode_wave_tokens = int(value)

    @property
    def param_batched(self) -> bool:
        return self._batched

    @property
    def w_out(self):
        return None if self.readout is None else self.readout.w_out

    def set_ensemble_weights(self, weights) -> None:
        """Per-reservoir voting weights for ``ensemble='weighted'`` —
        typically ``1 / (rmse_i**2 + eps)`` from each member's held-out
        RMSE.  ``None`` restores uniform voting (= the plain mean)."""
        if self.ensemble != "weighted":
            raise ValueError(
                f"set_ensemble_weights needs ensemble='weighted' "
                f"(engine has ensemble={self.ensemble!r})")
        self._exec._ens_weights = (
            None if weights is None else torch.as_tensor(
                np.asarray(weights), dtype=self._dtype,
                device=self.device).reshape(self.max_slots))

    # ------------------------------------------------------------- lifecycle
    def submit(self, sid: Hashable, u=None, y_teacher=None, *, h0=None,
               y0=None, slot: Optional[int] = None,
               tenant: Optional[Hashable] = None,
               decode_slo_us: Optional[float] = None) -> Optional[int]:
        """Queue ``sid`` for wave-batched admission (:meth:`flush` drains
        the queue).  ``u``: (T, d_in) prompt; ``h0``/``y0``: a parked state
        to resume from (numpy or tensor, e.g. a released one); ``slot=``
        pins an admission-only placement; ``tenant=`` keys the readout pool
        (sessions of one tenant serve, and refit, one readout);
        ``decode_slo_us=`` overrides the engine-wide decode deadline for
        this session.  At ``max_queued`` capacity raises
        :class:`AdmissionFull`."""
        return self._ingest.submit(sid, u, y_teacher, h0=h0, y0=y0,
                                   slot=slot, tenant=tenant,
                                   decode_slo_us=decode_slo_us)

    def flush(self, *, method: str = "auto", chunk: int = 128,
              want_outputs: bool = False,
              max_waves: Optional[int] = None,
              decode_interleave: bool = False,
              decode_sids=None, refit: bool = False
              ) -> Dict[Hashable, object]:
        """Drain the admission queue, one batched prefill per same-bucket
        wave; returns sid -> per-step outputs for prompts *completed* this
        flush (None unless ``want_outputs``).  ``decode_interleave=True``
        (needs ``decode_slo_us`` — engine-wide, or per-session deadlines
        covering an explicit ``decode_sids`` set) alternates SLO-protected
        decode waves of ``decode_wave_tokens`` tokens with prefill: tighter
        deadlines decode first, and due sessions with rows buffered via
        :meth:`queue_inputs` advance teacher-driven instead of free-running.
        Planning only reorders waves, so every output is bit-exact against
        the decode-blind schedule.  ``refit=True`` (needs ``learn=True``)
        batch-refits the dirty sessions after the drain."""
        if refit and not self._learn:
            raise ValueError("flush(refit=True) needs learn=True on the "
                             "engine — nothing accumulates (G, C) otherwise")
        return self._exec.flush(method=method, chunk=chunk,
                                want_outputs=want_outputs,
                                max_waves=max_waves,
                                decode_interleave=decode_interleave,
                                decode_sids=decode_sids, refit=refit)

    def queue_inputs(self, sid: Hashable, u) -> int:
        """Buffer open-loop input rows ((d_in,) or (K, d_in)) for ``sid``;
        interleaved flushes drain them in teacher-driven decode waves.
        Returns the queue depth."""
        return self._ingest.queue_inputs(sid, u)

    def decode_step(self, inputs):
        """One open-loop token for each sid in ``inputs`` (sid -> input)."""
        return self._exec.decode_step(inputs)

    def observe(self, sid: Hashable, y_true) -> None:
        """Teacher-force ``sid``: ``y_true`` replaces its fed-back output
        before the next decode step (under ``ensemble="mean"``, every ready
        session's)."""
        self._exec.observe(sid, y_true)

    def decode_closed_loop(self, n_steps: int, sids=None):
        """Free-run ``n_steps`` tokens for ``sids`` (default: every ready
        session) through the fused decode; sid -> (n_steps, d_out)."""
        return self._exec.decode_closed_loop(n_steps, sids)

    def collect_decoded(self, sid: Optional[Hashable] = None) -> DecodeResult:
        """Drain every buffered decoded token (or just ``sid``'s)."""
        return self._exec.collect_decoded(sid)

    def state_of(self, sid: Hashable):
        """A ready or parked session's current state as a host array (a
        parked one is read in place, never promoted)."""
        return self._exec.state_of(sid)

    def release(self, sid: Hashable, *, drop: bool = False) -> EvictResult:
        """Hand ``sid``'s state back and forget the session.  Returns an
        :class:`EvictResult` (unpacks as ``(state, y_prev)``; ``.decoded``
        carries uncollected tokens).  ``drop=True`` discards the state."""
        return self._exec.release(sid, drop=drop)

    def evict(self, sid: Hashable) -> EvictResult:
        """Deprecated alias of :meth:`release`, as in the JAX package."""
        return self.release(sid)

    # ------------------------------------------------- learn-while-serving
    @property
    def _learn_state(self):
        return self._learn_plane.state

    @property
    def _readouts(self):
        return self._learn_plane.readouts

    def refit(self, sid: Optional[Hashable] = None, *,
              alpha: Optional[float] = None) -> Dict[Hashable, torch.Tensor]:
        """Solve fresh readouts from the streaming ``(G, C)`` — one batched
        solve over every dirty session (or just ``sid``).  Each lands in the
        session's tenant pool entry (hot slots re-scatter at once) and is
        returned per sid; it matches an offline ``core.esn.fit`` of the
        concatenated teacher stream ("the prompt is the washout")."""
        if not self._learn:
            raise ValueError("refit needs learn=True on the engine — "
                             "nothing accumulates (G, C) otherwise")
        if sid is None:
            sids = self._learn_plane.dirty_sids()
        else:
            if sid not in self._learn_plane.state:
                raise KeyError(f"session {sid!r} has no learn state (was it "
                               f"admitted with learn=True on the engine?)")
            sids = [sid]
        return self._learn_plane.refit_wave(sids, alpha=alpha)

    def _sync_key(self, key) -> None:
        """Re-scatter every hot session serving ``key`` (a tenant's hot
        sessions switch together)."""
        self._exec.sync_slot_readouts(
            [(sid, st.slot) for sid, st in self.sessions.items()
             if self._learn_plane.readout_key(sid) == key])

    def set_readout(self, key: Hashable, w_out) -> None:
        """Install or replace the pool readout of ``key`` (a tenant, or a
        sid for a private readout): hot sessions serving it switch on their
        next wave, later admissions gather it at placement.  Takes a
        ``Readout`` or a bare (F, D_out) array or tensor."""
        w = getattr(w_out, "w_out", w_out)
        w = (w if isinstance(w, torch.Tensor) else torch.tensor(
            np.asarray(w))).to(device=self.device, dtype=self._dtype)
        want = (self.cfg.n_features, self.cfg.d_out)
        if tuple(w.shape) != want:
            raise ValueError(f"pool readout for {key!r} must be {want}, "
                             f"got {tuple(w.shape)}")
        self._exec.activate_pool()
        self._readouts[key] = w
        self._sync_key(key)

    def readout_for(self, sid):
        """The (F, D_out) readout serving ``sid`` now: its tenant's (or
        its own) pool entry when one exists, else the base."""
        w = self._learn_plane.pool_entry(sid)
        if w is not None:
            return w
        if not self._batched:
            return self.w_out
        return self._exec._base_readout(self.sessions[sid].slot)

    def drift_rmse(self, sid: Hashable) -> Optional[float]:
        """The session's held-out streaming RMSE (sqrt of the prequential
        squared-error EWMA); None before its first post-washout pair."""
        return self._learn_plane.drift_rmse(sid)

    def reset(self) -> None:
        """Drop all sessions (active, queued and parked), their learn state
        and the readout pools, and zero the arena.  The cumulative
        :meth:`stats` counters (not the promote-latency window) and the
        cost model are kept."""
        self._exec.reset()
        self._learn_plane.clear()
        self._ingest.clear()
        self._agg.promote_us.clear()
        old = self.scheduler
        self.scheduler = WaveScheduler(bucket_min=old.bucket_min,
                                       max_wave=old.max_wave,
                                       chunk_max=old.chunk_max,
                                       cost_model=old.cost_model)

    # ----------------------------------------------------- snapshot/restore
    def snapshot(self, path: str) -> str:
        """Serialize the whole engine to the directory ``path`` (atomic:
        tmp-rename after a ``_COMPLETE`` marker), in the JAX package's
        layout.  See ``serve.store.snapshot_engine``."""
        return store_mod.snapshot_engine(self, path)

    @classmethod
    def restore(cls, path: str, *, device=None,
                mesh=None) -> "ReservoirEngine":
        """Rebuild an engine on ``device`` (``None``: the GPU) from a
        snapshot written by either package and resume it bit-exactly;
        ``mesh`` re-places the arena on a (possibly different) device mesh.
        Stats counters start fresh.  See ``serve.store.restore_engine``."""
        return store_mod.restore_engine(cls, path, device=device, mesh=mesh)

    # ---------------------------------------------------------------- stats
    def stats(self) -> EngineStats:
        """Engine-lifetime serving counters as a frozen
        :class:`EngineStats`."""
        d = self._agg.snapshot()
        if self.cost_model is not None:
            wave_costs = self.cost_model.records()
        else:           # no model: best effort from the (bounded) wave log
            wave_costs = [{"b": w["rows"], "t_bucket": w["t_bucket"],
                           "us": w["us"]} for w in d["wave_log"]
                          if w["us"] is not None and w["rows"] > 0]
        d.update(
            sessions_active=len(self.sessions),
            sessions_ready=len(self.ready_sessions),
            sessions_queued=len(self.scheduler),
            sessions_parked=0 if self.store is None else len(self.store),
            store=None if self.store is None else self.store.stats(),
            chunks_in_flight=sum(st.prefill_pending
                                 for st in self.sessions.values()),
            pipeline_depth=self.pipeline_depth,
            pipeline_inflight=len(self._exec._inflight),
            sessions_dirty=sum(ls.dirty
                               for ls in self._learn_plane.state.values()),
            wave_costs=wave_costs)
        return EngineStats(**d)

    def clear_decode_gaps(self) -> None:
        self._agg.clear_gaps()
