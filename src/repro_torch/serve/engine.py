"""ReservoirEngine — the thin facade over the serving planes.

Three planes with one-way imports, and this module the only one that sees
all of them: ``serve.telemetry`` (observability: ``Tracker`` seam +
``StatsAggregator``), ``serve.ingest`` (control: session table, admission,
backpressure), ``serve.exec_plane`` (data: the slot arena and every device
launch).  Lifecycle: ``submit`` -> ``flush`` -> ``decode_step`` /
``decode_closed_loop`` -> ``release``.

The engine runs on one device, the GPU unless ``device="cpu"`` is passed;
params and readout are moved there at construction.  Options of the JAX
engine whose planes are not ported yet raise ``NotImplementedError`` naming
the ROADMAP item that brings them.
"""
from __future__ import annotations

from typing import Dict, Hashable, Optional

import torch

from .. import resolve_device
from ..core.params import DiagParams, Readout, StandardParams, params_to
from .exec_plane import DecodeResult, EvictResult, ExecPlane
from .ingest import AdmissionFull, IngestPlane, SessionStats, SessionTable
from .scheduler import WaveScheduler
from .telemetry import (EngineStats, MultiTracker, StatsAggregator, Tracker,
                        make_tracker)

__all__ = ["SessionStats", "DecodeResult", "EvictResult", "EngineStats",
           "AdmissionFull", "ReservoirEngine"]

#: Constructor options of the JAX engine that later slices port, with the
#: ROADMAP item that brings each.
_NOT_PORTED = {
    "mesh": "A11 (sharded arena)",
    "autotune": "A6 (serve/cost.py cost model)",
    "cost_model": "A6 (serve/cost.py cost model)",
    "decode_slo_us": "A7 (decode-SLO interleave)",
    "park_host_rows": "A8 (serve/store.py paging)",
    "cold_dir": "A8 (serve/store.py paging)",
    "learn": "A9 (serve/learn.py learn-while-serving)",
    "profile_dir": "A6 (ProfilerTracker -> torch.profiler)",
}


class ReservoirEngine:
    """Batched multi-session serving over an immutable reservoir param
    struct.

    ``model``: a ``core.params`` struct; ``readout``: its trained
    :class:`Readout` (the engine snapshots both at construction — build it
    after fitting).  ``tracker``: a ``serve.telemetry.Tracker`` or spec
    string (``"null"``, ``"jsonl:PATH"``).  ``max_queued`` bounds the
    admission queue.  ``pipeline_depth`` waves may stay in flight while the
    host plans the next; 0 waits after every wave.  ``device``: where the
    engine runs (``None`` means the GPU).
    """

    def __init__(self, model, max_slots: int = 8, *,
                 readout: Optional[Readout] = None, bucket_min: int = 16,
                 ensemble: str = "off", chunk_max: Optional[int] = None,
                 decode_wave_tokens=1, pipeline_depth: int = 2,
                 tracker=None, max_queued: Optional[int] = None,
                 device=None, mesh=None, autotune: bool = False,
                 cost_model=None, decode_slo_us: Optional[float] = None,
                 park_host_rows: Optional[int] = None,
                 cold_dir: Optional[str] = None, learn: bool = False,
                 profile_dir: Optional[str] = None):
        requested = {"mesh": mesh, "autotune": autotune,
                     "cost_model": cost_model,
                     "decode_slo_us": decode_slo_us,
                     "park_host_rows": park_host_rows, "cold_dir": cold_dir,
                     "learn": learn, "profile_dir": profile_dir}
        for name, value in requested.items():
            if value not in (None, False):
                raise NotImplementedError(
                    f"{name}= is not ported yet: ROADMAP {_NOT_PORTED[name]}")
        if decode_wave_tokens != 1:
            # Only interleaved decode waves are sized by it.
            raise NotImplementedError(
                "decode_wave_tokens= is not ported yet: ROADMAP "
                f"{_NOT_PORTED['decode_slo_us']}")
        if ensemble != "off":
            raise NotImplementedError(
                f"ensemble={ensemble!r} serves a param batch "
                f"(from_param_batch), not ported yet: ROADMAP A5 "
                f"(param-batched arena)")
        if not isinstance(model, (StandardParams, DiagParams)):
            raise ValueError(f"model must be a StandardParams or DiagParams "
                             f"struct, got {type(model).__name__}")
        self.device = resolve_device(device)
        self.params = params_to(model, self.device)
        if readout is not None and not isinstance(readout, Readout):
            readout = Readout(torch.as_tensor(readout))
        self.readout = (None if readout is None else
                        Readout(readout.w_out.to(self.device)))
        self.cfg = self.params.cfg
        self.max_slots = int(max_slots)
        if self.max_slots < 1:
            raise ValueError(
                f"max_slots must be >= 1, got {self.max_slots} (an engine "
                f"with 0 slots queues every session forever)")
        if int(pipeline_depth) < 0:
            raise ValueError(f"pipeline_depth must be >= 0, "
                             f"got {pipeline_depth}")
        self._dtype = self.params.dtype
        # Observability: the aggregator is always first in the fan-out, so
        # stats() counters and a user trace derive from the SAME events.
        self._agg = StatsAggregator()
        user = (tracker if isinstance(tracker, Tracker) or tracker is None
                else make_tracker(tracker))
        self.tracker: Tracker = (MultiTracker([self._agg, user])
                                 if user is not None else self._agg)
        sched = WaveScheduler(bucket_min=bucket_min, chunk_max=chunk_max)
        self._table = SessionTable(self.max_slots)
        self._exec = ExecPlane(
            self.params, self.readout, self.cfg, self._dtype,
            max_slots=self.max_slots, pipeline_depth=int(pipeline_depth), tracker=self.tracker,
            table=self._table, scheduler=sched)
        self._ingest = IngestPlane(
            self.cfg, self._exec._np_dtype, batched=False,
            max_slots=self.max_slots, table=self._table, scheduler=sched,
            max_queued=max_queued)
        self._ingest.place = self._exec.place

    @classmethod
    def from_param_batch(cls, params, readout=None, **kwargs):
        """A param-batched engine (slot i runs reservoir i) — not ported."""
        raise NotImplementedError(
            "from_param_batch is not ported yet: ROADMAP A5 (param-batched "
            "arena and ensemble voting)")

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
    def w_out(self):
        return None if self.readout is None else self.readout.w_out

    # ------------------------------------------------------------- lifecycle
    def submit(self, sid: Hashable, u=None, y_teacher=None, *, h0=None,
               y0=None, slot: Optional[int] = None) -> Optional[int]:
        """Queue ``sid`` for wave-batched admission (:meth:`flush` drains
        the queue).  ``u``: (T, d_in) prompt; ``h0``/``y0``: a parked state
        to resume from (numpy or tensor, e.g. a released one); ``slot=``
        pins an admission-only placement.  At ``max_queued`` capacity
        raises :class:`AdmissionFull`."""
        return self._ingest.submit(sid, u, y_teacher, h0=h0, y0=y0,
                                   slot=slot)

    def flush(self, *, method: str = "auto", chunk: int = 128,
              want_outputs: bool = False,
              max_waves: Optional[int] = None) -> Dict[Hashable, object]:
        """Drain the admission queue, one batched prefill per same-bucket
        wave; returns sid -> per-step outputs for prompts *completed* this
        flush (None unless ``want_outputs``)."""
        return self._exec.flush(method=method, chunk=chunk,
                                want_outputs=want_outputs,
                                max_waves=max_waves)

    def decode_step(self, inputs):
        """One open-loop token for each sid in ``inputs`` (sid -> input)."""
        return self._exec.decode_step(inputs)

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
        cumulative :meth:`stats` counters are kept."""
        self._exec.reset()
        self._ingest.clear()
        old = self.scheduler
        self.scheduler = WaveScheduler(bucket_min=old.bucket_min,
                                       max_wave=old.max_wave,
                                       chunk_max=old.chunk_max)

    # ---------------------------------------------------------------- stats
    def stats(self) -> EngineStats:
        """Engine-lifetime serving counters as a frozen :class:`EngineStats`
        (fields of planes not ported yet read zero / None)."""
        d = self._agg.snapshot()
        d.update(
            sessions_active=len(self.sessions),
            sessions_ready=len(self.ready_sessions),
            sessions_queued=len(self.scheduler),
            sessions_parked=0, store=None,
            chunks_in_flight=sum(st.prefill_pending
                                 for st in self.sessions.values()),
            pipeline_depth=self.pipeline_depth,
            pipeline_inflight=len(self._exec._inflight),
            sessions_dirty=0,
            wave_costs=[{"b": w["rows"], "t_bucket": w["t_bucket"],
                         "us": w["us"]} for w in d["wave_log"]
                        if w["us"] is not None and w["rows"] > 0])
        return EngineStats(**d)

    def clear_decode_gaps(self) -> None:
        self._agg.clear_gaps()
