"""ReservoirEngine — the thin facade over the serving planes.

Three planes with one-way imports, and this module the only one that sees
all of them: ``serve.telemetry`` (observability: ``Tracker`` seam +
``StatsAggregator``), ``serve.ingest`` (control: session table, admission,
backpressure), ``serve.exec_plane`` (data: the slot arena and every device
launch).  Lifecycle: ``submit`` -> ``flush`` -> ``decode_step`` /
``decode_closed_loop`` / ``observe`` / ``queue_inputs`` -> ``release``.

The engine runs on one device, the GPU unless ``device="cpu"`` is passed;
params and readout are moved there at construction.  Options of the JAX
engine whose planes are not ported yet (paging, learning, a device mesh)
raise ``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

from typing import Dict, Hashable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.params import DiagParams, Readout, StandardParams, params_to
from .cost import WaveCostModel, cost_key
from .exec_plane import DecodeResult, EvictResult, ExecPlane
from .ingest import AdmissionFull, IngestPlane, SessionStats, SessionTable
from .scheduler import WaveScheduler
from .telemetry import (EngineStats, MultiTracker, ProfilerTracker,
                        StatsAggregator, Tracker, make_tracker)

__all__ = ["SessionStats", "DecodeResult", "EvictResult", "EngineStats",
           "AdmissionFull", "ReservoirEngine"]

#: Constructor options of the JAX engine that later slices port, with the
#: ROADMAP item that brings each.
_NOT_PORTED = {
    "mesh": "A11 (sharded arena)",
    "park_host_rows": "A8 (serve/store.py paging)",
    "cold_dir": "A8 (serve/store.py paging)",
    "learn": "A9 (serve/learn.py learn-while-serving)",
}


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
    host plans the next; 0 waits after every wave.  ``device``: where the
    engine runs (``None`` means the GPU).  ``ensemble`` fuses the slots of
    a param batch (:meth:`from_param_batch`).
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
                 profile_dir: Optional[str] = None,
                 _param_batch: bool = False):
        requested = {"mesh": mesh, "park_host_rows": park_host_rows,
                     "cold_dir": cold_dir, "learn": learn}
        for name, value in requested.items():
            if value not in (None, False):
                raise NotImplementedError(
                    f"{name}= is not ported yet: ROADMAP {_NOT_PORTED[name]}")
        params, readout = _coerce_model(model, readout)
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.readout = (None if readout is None else
                        Readout(readout.w_out.to(self.device)))
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
        # Decode-aware planning needs a cost surface; engine-built models
        # are keyed by (device type, n, d_out), so persisted observations
        # never price another machine or model size.
        if cost_model is None and (autotune or decode_slo_us is not None
                                   or decode_k_auto):
            cost_model = WaveCostModel(key=cost_key(
                self.device.type, self.cfg.n, self.cfg.d_out))
        self._dtype = self.params.dtype
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
            max_slots=self.max_slots, pipeline_depth=int(pipeline_depth),
            decode_slo_us=decode_slo_us,
            decode_wave_tokens=int(decode_wave_tokens),
            decode_k_auto=decode_k_auto, cost_model=cost_model,
            autotune=self._autotune, tracker=self.tracker,
            table=self._table, scheduler=sched)
        self._ingest = IngestPlane(
            self.cfg, self._exec._np_dtype, batched=self._batched,
            max_slots=self.max_slots, table=self._table, scheduler=sched,
            default_decode_slo_us=decode_slo_us, max_queued=max_queued)
        self._ingest.place = self._exec.place
        self._exec.input_depth = self._ingest.input_depth
        self._exec.pop_inputs = self._ingest.pop_inputs
        # Queued open-loop inputs leave with their session.
        self._exec.pop_learn = self._ingest.drop_inputs

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
    def cost_model(self):
        return self._exec.cost_model

    @cost_model.setter
    def cost_model(self, model) -> None:
        self._exec.cost_model = model
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
               decode_slo_us: Optional[float] = None) -> Optional[int]:
        """Queue ``sid`` for wave-batched admission (:meth:`flush` drains
        the queue).  ``u``: (T, d_in) prompt; ``h0``/``y0``: a parked state
        to resume from (numpy or tensor, e.g. a released one); ``slot=``
        pins an admission-only placement; ``decode_slo_us=`` overrides the
        engine-wide decode deadline for this session.  At ``max_queued``
        capacity raises :class:`AdmissionFull`."""
        return self._ingest.submit(sid, u, y_teacher, h0=h0, y0=y0,
                                   slot=slot, decode_slo_us=decode_slo_us)

    def flush(self, *, method: str = "auto", chunk: int = 128,
              want_outputs: bool = False,
              max_waves: Optional[int] = None,
              decode_interleave: bool = False,
              decode_sids=None) -> Dict[Hashable, object]:
        """Drain the admission queue, one batched prefill per same-bucket
        wave; returns sid -> per-step outputs for prompts *completed* this
        flush (None unless ``want_outputs``).  ``decode_interleave=True``
        (needs ``decode_slo_us`` — engine-wide, or per-session deadlines
        covering an explicit ``decode_sids`` set) alternates SLO-protected
        decode waves of ``decode_wave_tokens`` tokens with prefill: tighter
        deadlines decode first, and due sessions with rows buffered via
        :meth:`queue_inputs` advance teacher-driven instead of free-running.
        Planning only reorders waves, so every output is bit-exact against
        the decode-blind schedule."""
        return self._exec.flush(method=method, chunk=chunk,
                                want_outputs=want_outputs,
                                max_waves=max_waves,
                                decode_interleave=decode_interleave,
                                decode_sids=decode_sids)

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
        """A ready session's current state as a host array."""
        return self._exec.state_of(sid)

    def release(self, sid: Hashable, *, drop: bool = False) -> EvictResult:
        """Hand ``sid``'s state back and forget the session.  Returns an
        :class:`EvictResult` (unpacks as ``(state, y_prev)``; ``.decoded``
        carries uncollected tokens).  ``drop=True`` discards the state."""
        return self._exec.release(sid, drop=drop)

    def reset(self) -> None:
        """Drop all sessions (active + queued) and zero the arena.  The
        cumulative :meth:`stats` counters and the cost model are kept."""
        self._exec.reset()
        self._ingest.clear()
        old = self.scheduler
        self.scheduler = WaveScheduler(bucket_min=old.bucket_min,
                                       max_wave=old.max_wave,
                                       chunk_max=old.chunk_max,
                                       cost_model=old.cost_model)

    # ---------------------------------------------------------------- stats
    def stats(self) -> EngineStats:
        """Engine-lifetime serving counters as a frozen :class:`EngineStats`
        (fields of planes not ported yet read zero / None)."""
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
            sessions_parked=0, store=None,
            chunks_in_flight=sum(st.prefill_pending
                                 for st in self.sessions.values()),
            pipeline_depth=self.pipeline_depth,
            pipeline_inflight=len(self._exec._inflight),
            sessions_dirty=0, wave_costs=wave_costs)
        return EngineStats(**d)

    def clear_decode_gaps(self) -> None:
        self._agg.clear_gaps()
