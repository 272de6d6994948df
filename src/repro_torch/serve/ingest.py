"""Ingest (control) plane — the session table, admission validation, the
submit surface, per-session open-loop input queues, and the bounded
admission policy the asyncio front end applies backpressure through.

No device work happens here: admission coerces and validates everything on
host and parks it in the ``WaveScheduler``; the exec plane commits slots
and dispatches waves when ``flush`` drains the queue.  Placement (the one
device effect a slot-pinned submit needs) reaches the exec plane through a
facade-wired callback, so the import graph stays one-way (this module
never imports ``exec_plane`` or ``engine``).  Prompts and parked states
arrive as numpy arrays or tensors on any device and are kept on the host.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Hashable, List, Optional

import numpy as np

from .scheduler import PrefillRequest, host_array

__all__ = ["AdmissionFull", "IngestPlane", "SessionStats", "SessionTable"]


class AdmissionFull(RuntimeError):
    """Raised by ``submit`` when the engine was built with a bounded
    admission queue (``max_queued=``) and the queue is at capacity — the
    open-loop front end's backpressure signal (it sheds or retries instead
    of queueing unbounded latency)."""


@dataclasses.dataclass(slots=True)
class SessionStats:
    """Per-session accounting (host-side).
    ``prefill_pending``: the session holds a slot but chunk waves of its
    prompt are still queued — decode is blocked until the last chunk lands.
    ``last_use``: monotone engine tick of the session's last prefill/decode/
    observe touch — the LRU key paging demotes by (``slot`` is -1 while the
    session is parked in the ``serve.store`` tiers)."""
    slot: int
    tokens_prefilled: int = 0
    tokens_decoded: int = 0
    prefill_pending: bool = False
    last_use: int = 0


class SessionTable:
    """The hot-session roster both serving planes share: the slot->sid
    array, the sid->``SessionStats`` map, and the monotone LRU clock.
    Plain state with derived views — mutation policy lives in the planes
    (ingest admits, exec places/releases)."""

    def __init__(self, max_slots: int):
        self.slots: List[Optional[Hashable]] = [None] * int(max_slots)
        self.sessions: Dict[Hashable, SessionStats] = {}
        self.use_clock = 0

    def tick(self) -> int:
        """Advance the LRU clock (every session touch gets a fresh monotone
        stamp — wall time would make snapshot restores non-deterministic).
        """
        self.use_clock += 1
        return self.use_clock

    @property
    def active(self) -> List[Hashable]:
        """Sessions holding a slot — including chunk-in-flight ones (see
        :attr:`ready` for the decodable subset)."""
        return [s for s in self.slots if s is not None]

    @property
    def ready(self) -> List[Hashable]:
        """Slot-holding sessions whose prompt has fully landed (no chunk
        waves pending) — the set decode may touch."""
        return [s for s in self.slots
                if s is not None and not self.sessions[s].prefill_pending]

    @property
    def free_slots(self) -> int:
        return self.slots.count(None)

    def demotable(self, protect=frozenset()) -> List[Hashable]:
        """Hot sessions eligible to park, least-recently-used first: ready
        (no chunk waves in flight — a mid-prompt slot's carry is owed to
        the scheduler's queued chunks) and not protected."""
        cands = [(st.last_use, sid) for sid, st in self.sessions.items()
                 if not st.prefill_pending and sid not in protect]
        cands.sort(key=lambda c: c[0])
        return [sid for _, sid in cands]

    def clear(self) -> None:
        self.slots = [None] * len(self.slots)
        self.sessions.clear()
        self.use_clock = 0


class IngestPlane:
    """Admission policy over the shared session table and scheduler.  The
    default decode SLO and the slot-pinned placement callback are wired by
    the facade; everything else is host bookkeeping."""

    def __init__(self, cfg, dtype, *, batched: bool, max_slots: int,
                 table: SessionTable, scheduler,
                 default_decode_slo_us: Optional[float] = None,
                 max_queued: Optional[int] = None):
        self.cfg = cfg
        self._dtype = dtype
        self._batched = bool(batched)
        self.max_slots = int(max_slots)
        self.table = table
        self.scheduler = scheduler
        self.default_decode_slo_us = default_decode_slo_us
        self.max_queued = None if max_queued is None else int(max_queued)
        # Open-loop input buffers: inputs queued ahead of the wave that
        # will consume them (exec's _driven_wave drains these under the
        # decode SLO).
        self._inputs: Dict[Hashable, deque] = {}
        # ---- facade-wired cross-plane callbacks --------------------------
        self.place = lambda sid, slot, h0, y0: slot
        self.note_admission = lambda sid, tenant: None
        self.in_store = lambda sid: False

    # ---------------------------------------------------------- validation
    def coerce_state(self, h0, y0):
        """Validate/coerce a parked (state, feedback) pair at the call site
        — nothing mis-shaped may enter the admission queue."""
        if h0 is not None:
            h0 = host_array(h0, self._dtype).reshape(self.cfg.n)
        if y0 is not None:
            y0 = host_array(y0, self._dtype).reshape(self.cfg.d_out)
        return h0, y0

    def validate_prompt(self, u, y_teacher):
        """Shape/width checks for submit() prompts.  Prompts land on the
        host, where flush() pads them into wave arrays anyway."""
        u = host_array(u, self._dtype)
        if u.ndim != 2 or u.shape[-1] != self.cfg.d_in:
            raise ValueError(
                f"prompt must be (T, d_in={self.cfg.d_in}), got {u.shape}")
        if u.shape[0] == 0:
            raise ValueError("prefill needs at least one token (got T=0)")
        if self.cfg.use_feedback:
            if y_teacher is None:
                raise ValueError("feedback model: prefill is teacher-forced, "
                                 "pass y_teacher")
            y_teacher = host_array(y_teacher, self._dtype)
            if y_teacher.shape[0] != u.shape[0]:
                raise ValueError(
                    f"y_teacher length {y_teacher.shape[0]} != prompt length "
                    f"{u.shape[0]} (one teacher output per prompt token)")
            if y_teacher.ndim != 2 or y_teacher.shape[1] != self.cfg.d_out:
                raise ValueError(
                    f"y_teacher must be (T, d_out={self.cfg.d_out}), got "
                    f"{y_teacher.shape}")
        elif y_teacher is not None:
            raise ValueError(
                "y_teacher passed to a non-feedback model (cfg.use_feedback "
                "is False) — it would be silently ignored; drop it or build "
                "the model with use_feedback=True")
        return u, y_teacher

    # ----------------------------------------------------------- admission
    def submit(self, sid: Hashable, u=None, y_teacher=None, *, h0=None,
               y0=None, slot: Optional[int] = None,
               tenant: Optional[Hashable] = None,
               decode_slo_us: Optional[float] = None) -> Optional[int]:
        """The one admission body behind ``ReservoirEngine.submit`` (see the
        facade docstring for the full contract).  ``decode_slo_us=``
        overrides the engine-wide default for THIS session's per-request
        decode deadline."""
        if (sid in self.table.sessions or self.scheduler.has(sid)
                or self.in_store(sid)):
            raise KeyError(f"session {sid!r} already admitted")
        if decode_slo_us is not None and not decode_slo_us > 0:
            raise ValueError(
                f"decode_slo_us must be positive microseconds, got "
                f"{decode_slo_us!r}")
        slo = (self.default_decode_slo_us if decode_slo_us is None
               else float(decode_slo_us))
        if slot is not None:
            if u is not None:
                raise ValueError(
                    "slot-pinned submit is admission-only: submit the "
                    "prompt without slot= (wave admission assigns slots) "
                    "or decode the pinned session open-loop")
            if not 0 <= slot < self.max_slots:
                raise ValueError(f"slot {slot} out of range "
                                 f"[0, {self.max_slots})")
            if self.table.slots[slot] is not None:
                raise ValueError(
                    f"slot {slot} is occupied by "
                    f"{self.table.slots[slot]!r} "
                    f"(pinned admission never queues)")
            h0, y0 = self.coerce_state(h0, y0)
            out = self.place(sid, slot, h0, y0)
            self.note_admission(sid, tenant)
            if slo is not None:
                self.scheduler.track_decode(sid, slo)
            return out
        if self._batched and h0 is not None:
            raise ValueError(
                "param-batched engine: a parked state belongs to the "
                "reservoir (= slot) it was released from — re-admit with "
                "submit(sid, h0=..., slot=<original slot>) so it cannot "
                "land under different weights")
        if self.max_queued is not None and len(self.scheduler) >= \
                self.max_queued:
            raise AdmissionFull(
                f"admission queue at capacity ({self.max_queued} queued) — "
                f"flush() to drain, or shed the request")
        # Everything is validated/coerced HERE, before the request enters the
        # queue: flush() commits host bookkeeping (slot table, sessions) as
        # it builds each wave, so a mis-shaped array surfacing there would
        # leave the engine permanently corrupted (admitted sessions with
        # empty states and a lost prompt).
        if u is not None:
            u, y_teacher = self.validate_prompt(u, y_teacher)
        elif y_teacher is not None:
            raise ValueError("y_teacher without a prompt — admission-only "
                             "submits carry state, not teacher tokens")
        h0, y0 = self.coerce_state(h0, y0)
        self.scheduler.submit(PrefillRequest(sid=sid, u=u,
                                             y_teacher=y_teacher,
                                             h0=h0, y0=y0, tenant=tenant))
        if slo is not None:
            self.scheduler.track_decode(sid, slo)
        return None

    # --------------------------------------------------- open-loop inputs
    def queue_inputs(self, sid: Hashable, u) -> int:
        """Buffer caller-supplied input rows for ``sid`` so interleaved
        flushes can advance the session teacher-driven (``flush(
        decode_interleave=True)`` pops these in K-token driven waves).
        Accepts one ``(d_in,)`` row or a ``(K, d_in)`` batch; returns the
        queue depth after the append."""
        u = host_array(u, self._dtype)
        if u.ndim == 1:
            u = u[None]
        if u.ndim != 2 or u.shape[-1] != self.cfg.d_in:
            raise ValueError(
                f"queued inputs must be (d_in={self.cfg.d_in},) rows or a "
                f"(K, d_in) batch, got {u.shape}")
        q = self._inputs.setdefault(sid, deque())
        for row in u:
            q.append(row)
        return len(q)

    def input_depth(self, sid: Hashable) -> int:
        q = self._inputs.get(sid)
        return 0 if q is None else len(q)

    def pop_inputs(self, sid: Hashable, k: int) -> List[np.ndarray]:
        q = self._inputs.get(sid)
        out = [q.popleft() for _ in range(min(k, 0 if q is None else len(q)))]
        if q is not None and not q:
            del self._inputs[sid]
        return out

    def drop_inputs(self, sid: Hashable) -> None:
        self._inputs.pop(sid, None)

    def clear(self) -> None:
        self._inputs.clear()
