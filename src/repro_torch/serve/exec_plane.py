"""Exec (data) plane — wave dispatch against the slot arena, the bounded
in-flight window with slot-granular taint tracking, tiered paging waves,
and SLO-interleaved decode (free-running and teacher-driven), single-step
and closed-loop decode, teacher forcing.

Everything that touches the device lives here: the prefill / decode /
place / release calls into ``serve.arena``, the page waves between the
arena and the session store's host pool, the decode output buffers, and
the flush drain loop that turns the scheduler's planned waves into
launches.  PyTorch runs these eagerly; a wave's launches are queued on the
device's current stream and the host goes on planning.  The in-flight
window bounds how far it runs ahead: each wave records a CUDA event, and the
host waits on the oldest event once more than ``pipeline_depth`` waves are
outstanding (``pipeline_depth=0`` waits after every wave — the synchronous
reference) or, under a decode SLO, once the waves' summed predicted cost
passes it.  On the CPU every launch has finished when it returns, so the
waits are no-ops.  Every wall time this plane measures ends in a wait for
the launch's event, never around an unsynchronised launch.

**Paging** (engine built with ``park_host_rows``): a demote gathers the
victim slots' rows on the device, copies them ``non_blocking`` into a
pinned staging buffer and waits for that copy's event before the store
reads it; a promote stages the fetched rows in the same pinned buffer,
copies them to the device ``non_blocking``, scatters them with one
``place_many`` and waits (a promote is on a decode's critical path).  The
arena has value semantics (``serve.arena``): no launch writes a tensor that
an older arena value holds, so — as on the JAX package's donation-free
backends — a pipelined demote may gather rows that no in-flight wave
writes from the **gather base**, the arena as of the oldest in-flight
wave's inputs.  That gather runs on a side stream which waits only for the
event of the work that produced the base, so the page-out overlaps the
in-flight scans instead of queueing behind them on the current stream.
Mutations outside the tracked wave path taint the slots they touch
(``_pipeline_taint``) or drop the base (``_pipeline_invalidate``).

**Per-tenant readouts**: the waves serve the engine-wide readout until a
refit or ``set_readout`` activates the per-slot pool ((max_slots, F, D),
one row per slot, re-scattered at every placement and promotion).  The
pool has value semantics like the arena: a refit builds a new pool tensor,
so a wave in flight keeps the one it was launched with.

**On a device mesh** (an engine built with ``mesh=``) the arena is a
``serve.arena.ShardedArena`` laid out by the engine's plan
(``sharding.rules.plan_arena``): this plane builds it (``_fresh_arena``,
:meth:`ExecPlane.place_arena`) and hands it to the same ``serve.arena``
calls, with slot indices on the host (each shard takes its own rows).

Control-plane state (session table, admission queue, open-loop input
queues) reaches this plane through the facade-wired ``table``,
``scheduler`` and callbacks; so do the learn plane's effects (teacher
pairing, the post-step snapshot, voting, refit waves).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from ..core import dispatch
from . import arena as arena_mod
from .scheduler import WaveItem, bucket_length, host_array

__all__ = ["ExecPlane", "DecodeResult", "EvictResult"]


@dataclasses.dataclass(frozen=True)
class DecodeResult:
    """What :meth:`ReservoirEngine.collect_decoded` returns.

    ``tokens``: sid -> (n_tokens, D_out) tensor; ``waves``: per-launch
    metadata dicts (``kind`` "step" / "closed_loop" / "interleave" /
    "driven", ``rows``, ``tokens`` per row, ``us`` wall time when timed,
    ``fused`` whether the K-token fused kernel path ran) for the launches
    whose tokens this result drained.  Mapping-shaped on
    ``tokens``.
    """
    tokens: Dict[Hashable, torch.Tensor]
    waves: Tuple[dict, ...] = ()

    def __getitem__(self, sid):
        return self.tokens[sid]

    def __iter__(self):
        return iter(self.tokens)

    def __len__(self) -> int:
        return len(self.tokens)

    def __contains__(self, sid) -> bool:
        return sid in self.tokens

    def keys(self):
        return self.tokens.keys()

    def values(self):
        return self.tokens.values()

    def items(self):
        return self.tokens.items()

    def get(self, sid, default=None):
        return self.tokens.get(sid, default)


class EvictResult(tuple):
    """What :meth:`ReservoirEngine.release` returns: unpacks as
    ``(state, y_prev)`` and carries ``.decoded`` — the
    :class:`DecodeResult` of any tokens the session had buffered but not yet
    collected."""

    def __new__(cls, state, y_prev, decoded: DecodeResult):
        self = super().__new__(cls, (state, y_prev))
        self.decoded = decoded
        return self

    @property
    def state(self):
        return self[0]

    @property
    def y_prev(self):
        return self[1]


def _record_event(device: torch.device):
    """A marker for the work queued so far on ``device``'s current stream
    (None on the CPU, where that work is already done)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _wait(marker) -> None:
    if marker is not None:
        marker.synchronize()


def _pinned(shape, dtype) -> torch.Tensor:
    """A page-locked host tensor (raises if the allocation fails)."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


class ExecPlane:
    """Owns the arena and every device launch.  ``table`` (the ingest
    plane's session table) and ``scheduler`` are facade-wired references;
    the ``tracker`` receives every wave / decode / pipeline event."""

    def __init__(self, params, readout, cfg, dtype, *, batched: bool,
                 ensemble: str, max_slots: int, plan, pipeline_depth: int,
                 decode_slo_us: Optional[float], decode_wave_tokens: int,
                 decode_k_auto: bool, store, cost_model, autotune: bool,
                 tracker, table, scheduler):
        self.params = params
        self.readout = readout
        self.cfg = cfg
        self._dtype = dtype
        self._np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self.device = params.device
        self._batched = bool(batched)
        self.ensemble = ensemble
        self.max_slots = int(max_slots)
        self.pipeline_depth = int(pipeline_depth)
        self.decode_slo_us = decode_slo_us
        self.decode_wave_tokens = int(decode_wave_tokens)
        self._decode_k_auto = bool(decode_k_auto)
        self.store = store
        self.cost_model = cost_model
        self._autotune = bool(autotune)
        self.tracker = tracker
        self.table = table
        self.scheduler = scheduler
        self._ens_weights = None
        self._slot_w = None
        self._layout = (None if plan is None
                        else arena_mod.ArenaLayout.build(plan, params))
        self.arena = self._fresh_arena()
        self._chunk_outs: Dict[Hashable, List] = {}
        self._decode_buf: Dict[Hashable, List] = {}
        self._decode_meta: List[dict] = []
        # The launched-but-unwaited waves, oldest first: each wave's event
        # (``marker``), the cost model's predicted cost of it (the SLO window
        # bound), the slots it writes, and the arena value right after it.
        # ``_arena_base`` is the arena as of the oldest in-flight wave's
        # inputs and ``_base_event`` marks the work that produced it; a
        # demote may gather rows no in-flight wave writes from it
        # (``_demote_wave``).  ``_base_valid`` drops when an untracked path
        # mutates unknown rows; ``_base_dirty`` holds the known ones.
        self._inflight: collections.deque = collections.deque()
        self._arena_base = None
        self._base_event = None
        self._base_valid = False
        self._base_dirty: set = set()
        # Paging on the card: pinned staging rows for page waves (one set:
        # every page wave waits for its own copies before it returns) and
        # the side stream of the overlap demote.
        self._stage = self._side = None
        if store is not None and self.device.type == "cuda":
            self._stage = (_pinned((self.max_slots, cfg.n), dtype),
                           _pinned((self.max_slots, cfg.d_out), dtype))
            self._side = torch.cuda.Stream(self.device)
        # ---- facade-wired cross-plane callbacks (learn / ingest) ---------
        self.note_admission = lambda sid, tenant: None
        self.on_prompt_done = lambda sid, y_last: None
        self.note_freerun = lambda sids, n: None
        self.note_steps = lambda sids: None
        self.cache_post_step = lambda arena: None
        self.vote = lambda sid, u_vec, y: y
        self.on_observe = lambda sid, slot, y, arena: None
        self.pool_entry = lambda sid: None
        self.learn_active = lambda: False
        self.pop_learn = lambda sid: None
        self.input_depth = lambda sid: 0
        self.pop_inputs = lambda sid, k: []
        self.dirty_sids = lambda: []
        self.refit_wave = lambda sids: {}

    def _fresh_arena(self):
        return self.place_arena(arena_mod.make_arena(
            self.cfg.n, self.cfg.d_out, self.max_slots, self._dtype,
            self.device))

    def place_arena(self, arena: arena_mod.SlotArena):
        """``arena`` as this plane holds it: sharded on the mesh when the
        engine has one, else as it is."""
        if self._layout is None:
            return arena
        return arena_mod.shard_arena(self._layout, arena)

    def _tensor(self, v, dtype=None):
        return torch.as_tensor(v, dtype=dtype, device=self.device)

    @property
    def w_out(self):
        return None if self.readout is None else self.readout.w_out

    def _kw(self) -> dict:
        return dict(batched=self._batched, ensemble=self.ensemble)

    # ---------------------------------------------------- pipelined executor
    def _base_mark(self):
        """Before a launch the window may admit: the event of everything
        queued so far when the window is empty and paging may gather from
        the arena value the launch reads (the next gather base)."""
        if self.store is None or self.pipeline_depth == 0 or self._inflight:
            return None
        return _record_event(self.device)

    def _inflight_admit(self, pred_us: float, slots, arena_before,
                        base_event) -> None:
        """Admit the wave just launched into the in-flight window, then
        retire from the front until the window is legal again: at most
        ``pipeline_depth`` waves deep and — under a decode SLO — the summed
        *predicted* cost of the waves in flight under it (every queued wave
        is latency someone's next token waits behind).  ``slots``: the
        slots the wave writes; ``arena_before`` / ``base_event``: the arena
        it read and the event of the work that produced it."""
        if not self._inflight:
            # The window was empty: the value the wave read is the gather
            # base, captured past every earlier untracked mutation.
            self._arena_base = arena_before
            self._base_event = base_event
            self._base_valid = True
            self._base_dirty = set()
        self._inflight.append({"marker": _record_event(self.device),
                               "pred_us": float(pred_us),
                               "slots": frozenset(slots),
                               "arena_after": self.arena})
        while len(self._inflight) > self.pipeline_depth or (
                self.decode_slo_us is not None and len(self._inflight) > 1
                and sum(e["pred_us"] for e in self._inflight)
                > self.decode_slo_us):
            self._inflight_retire()
        self.tracker.log_wave({"kind": "pipeline",
                               "inflight": len(self._inflight)})

    def _inflight_retire(self) -> None:
        """Wait for the oldest in-flight wave (the wait is the host's
        pipeline-idle time) and advance the gather base past it."""
        e = self._inflight.popleft()
        t0 = time.perf_counter()
        _wait(e["marker"])
        self.tracker.log_wave({"kind": "host_block",
                               "us": (time.perf_counter() - t0) * 1e6})
        if self._base_valid:
            self._arena_base, self._base_event = e["arena_after"], e["marker"]
        if not self._inflight:
            self._arena_base = self._base_event = None

    def _drain_inflight(self) -> None:
        while self._inflight:
            self._inflight_retire()

    def _window_settled(self) -> None:
        """The host just waited for work downstream of every in-flight wave
        (a timed launch, a promote's scatter): forget the window without
        further waits."""
        self._inflight.clear()
        self._pipeline_invalidate()

    def _pipeline_invalidate(self) -> None:
        """An arena mutation outside the tracked wave path whose rows are
        unknown: the gather base vouches for no row until the window turns
        over."""
        self._arena_base = self._base_event = None
        self._base_valid = False
        self._base_dirty = set()

    def _pipeline_taint(self, slots) -> None:
        """A mutation of known slots outside the tracked wave path (a
        release, a single placement, teacher forcing): only those slots
        fall back to ordered gathers."""
        if self._base_valid:
            self._base_dirty.update(slots)

    def _inflight_dirty_slots(self) -> set:
        dirty: set = set()
        for e in self._inflight:
            dirty |= e["slots"]
        return dirty

    def _sync_us(self, t0: float) -> float:
        """Wait for everything queued so far (the launch just made and every
        wave before it on the stream), settle the whole in-flight window it
        covered, and return the microseconds since ``t0``."""
        _wait(_record_event(self.device))
        self._window_settled()
        return (time.perf_counter() - t0) * 1e6

    # ---------------------------------------------------------------- paging
    def _arena_index(self, slots) -> torch.Tensor:
        """Slot indices for a ``serve.arena`` call: on the host for a
        sharded arena (each shard takes its own rows), else
        :meth:`_index`."""
        if self._layout is not None:
            return torch.tensor(list(slots), dtype=torch.int64)
        return self._index(slots)

    def _index(self, slots) -> torch.Tensor:
        """``slots`` as an index tensor on the device.  On the card it goes
        through page-locked memory ``non_blocking`` on the current stream: a
        pageable copy would wait for every launch queued before it (the
        caching host allocator keeps the pinned source until the copy has
        run)."""
        idx = torch.tensor(list(slots), dtype=torch.int64)
        if self.device.type != "cuda":
            return idx
        return idx.pin_memory().to(self.device, non_blocking=True)

    def _rows_to_host(self, arena, slots, after=None):
        """``slots``'s (states, y_prev) rows of ``arena`` as host arrays.
        On the card: one ``index_select`` per tensor, copied ``non_blocking``
        into the pinned staging rows, and a wait for that copy's event
        before the rows are read.  ``after``: run on the side stream, which
        waits only for this event (the work that produced ``arena``)."""
        if self.device.type != "cuda":
            s, y = arena_mod.gather_rows(arena, self._arena_index(slots))
            return s.numpy(), y.numpy()
        k = len(slots)
        stream = (torch.cuda.current_stream(self.device) if after is None
                  else self._side)
        with torch.cuda.stream(stream):
            if after is not None:
                stream.wait_event(after)
            s, y = arena_mod.gather_rows(arena, self._arena_index(slots))
            self._stage[0][:k].copy_(s, non_blocking=True)
            self._stage[1][:k].copy_(y, non_blocking=True)
            done = _record_event(self.device)
        _wait(done)
        return self._stage[0][:k].numpy(), self._stage[1][:k].numpy()

    def _rows_to_arena(self, slots, states, ys) -> None:
        """Scatter host rows into ``slots`` (one ``place_many``) and wait
        until they are resident.  On the card the rows go through the
        pinned staging buffer, copied ``non_blocking``."""
        if self.device.type != "cuda":
            h0s, y0s = torch.from_numpy(states), torch.from_numpy(ys)
        else:
            k = len(slots)
            self._stage[0][:k].numpy()[:] = states
            self._stage[1][:k].numpy()[:] = ys
            h0s = self._stage[0][:k].to(self.device, non_blocking=True)
            y0s = self._stage[1][:k].to(self.device, non_blocking=True)
        self.arena = arena_mod.place_many(self.arena,
                                          self._arena_index(slots), h0s, y0s)
        _wait(_record_event(self.device))

    def _capacity(self, protect=frozenset()) -> int:
        """Admission capacity: free slots, plus — on a paged engine — every
        demotable hot session (capacity is sessions, not slots)."""
        cap = self.table.free_slots
        if self.store is not None:
            cap += len(self.table.demotable(protect))
        return cap

    def _note_page(self, rows: int, us: float, *, promote: bool) -> None:
        """Page-wave accounting: the telemetry event, the cost model's page
        surface (autotune only: in pipelined serving a blocking transfer
        also drains queued waves, which would poison the fit), and the
        decode deadlines (a page wave spends latency the budget sees)."""
        self.tracker.log_wave({"kind": "page", "promote": promote,
                               "rows": rows, "us": us})
        if self._autotune and self.cost_model is not None:
            self.cost_model.observe_page(rows, us)
        self.scheduler.charge_decode_cost(us)

    def _demote_wave(self, sids: List[Hashable]) -> None:
        """Park ``sids``: their slot rows to the host in one gather per
        tensor, the slots freed in one scatter, and the rows (plus each
        session's accounting struct) handed to the store.  A pipelined
        engine gathers from the gather base when no in-flight wave and no
        untracked mutation touched the victim slots — those rows are the
        same in both values (waves write only their own slots) — on the
        side stream, so the copy overlaps the in-flight scans (the overlap
        fast path, counted by ``overlap_demote`` events); otherwise the
        gather is ordered behind everything queued."""
        if not sids:
            return
        slots = [self.table.sessions[s].slot for s in sids]
        fast = (self._inflight and self._base_valid
                and self._arena_base is not None
                and not (set(slots) & (self._inflight_dirty_slots()
                                       | self._base_dirty)))
        if fast:
            self.tracker.log_wave({"kind": "overlap_demote",
                                   "rows": len(sids)})
        t0 = time.perf_counter()
        states, ys = (self._rows_to_host(self._arena_base, slots,
                                         after=self._base_event) if fast
                      else self._rows_to_host(self.arena, slots))
        us = (time.perf_counter() - t0) * 1e6
        stats = []
        for sid in sids:
            st = self.table.sessions.pop(sid)
            self.table.slots[st.slot] = None
            st.slot = -1
            stats.append(st)
        self.arena = arena_mod.release_many(self.arena,
                                            self._arena_index(slots))
        self.store.park_many(sids, states, ys, stats)
        self._note_page(len(sids), us, promote=False)

    def _promote_wave(self, sids: List[Hashable]) -> None:
        """Un-park ``sids`` into free slots: one store fetch (host rows or
        cold records), one ``place_many``, and a wait until the states are
        resident — a promote is on someone's decode critical path, so its
        measured latency (``promote_us_p95``) must be real.  The wait covers
        every in-flight wave, so the window settles."""
        if not sids:
            return
        t0 = time.perf_counter()
        states, ys, stats = self.store.fetch_many(sids)
        slots = []
        for sid, st in zip(sids, stats):
            slot = self.table.slots.index(None)
            self.table.slots[slot] = sid
            st.slot = slot
            self.table.sessions[sid] = st
            slots.append(slot)
        self._rows_to_arena(slots, states, ys)
        # Promoted sessions re-enter on fresh slots: their tenant's pool
        # readout serves them from the next wave.
        self.sync_slot_readouts(list(zip(sids, slots)))
        self._window_settled()
        self._note_page(len(sids), (time.perf_counter() - t0) * 1e6,
                        promote=True)

    def _ensure_hot(self, sids, protect=frozenset()) -> None:
        """Promote any parked sessions in ``sids`` — called at the top of
        every decode and observe path, so touching a parked session just
        works: the LRU idle hot sessions page out to make room."""
        if self.store is None:
            return
        parked = [s for s in sids if s in self.store]
        if not parked:
            return
        # The cold reads start on the store's I/O lane now, overlapping the
        # demote below; the promote's fetch consumes their futures.
        self.store.prefetch_many(parked)
        need = len(parked) - self.table.free_slots
        if need > 0:
            victims = self.table.demotable(set(sids) | set(protect))[:need]
            if len(victims) < need:
                raise RuntimeError(
                    f"cannot promote {len(parked)} parked session(s): "
                    f"{self.table.free_slots} free slot(s), "
                    f"{len(victims)} demotable — decode at most "
                    f"max_slots={self.max_slots} sessions per wave")
            self._demote_wave(victims)
        self._promote_wave(parked)

    def _make_room(self, wave: List[WaveItem], protect=frozenset()) -> None:
        """Demote enough LRU idle sessions that the wave's fresh rows find
        free slots (the scheduler's capacity counted them, so the victims
        exist)."""
        if self.store is None:
            return
        need = sum(it.first for it in wave) - self.table.free_slots
        if need > 0:
            self._demote_wave(self.table.demotable(protect)[:need])

    # -------------------------------------------- per-tenant readouts (device)
    def _wave_w(self):
        """The readout the waves serve: the (max_slots, F, D_out) per-slot
        pool once any tenant readout has diverged from the base, else the
        engine-wide ``w_out`` (no pool cost until then)."""
        return self.w_out if self._slot_w is None else self._slot_w

    def activate_pool(self) -> None:
        """Materialize the per-slot readout pool, seeded with the base
        readout in every slot (a param-batched engine's stacked readout
        already is the pool)."""
        if self._slot_w is not None:
            return
        if self.readout is None:
            raise ValueError("per-tenant readout pools need a base readout")
        w = self.w_out
        if not self._batched:
            w = w.expand((self.max_slots,) + tuple(w.shape))
        self._slot_w = w.contiguous()

    def _base_readout(self, slot: int):
        return (None if self.readout is None
                else self.w_out[slot] if self._batched else self.w_out)

    def _pool_readout(self, sid, slot: int):
        w = self.pool_entry(sid)
        return self._base_readout(slot) if w is None else w

    def sync_slot_readouts(self, pairs) -> None:
        """Scatter each (sid, slot) pair's effective readout into the pool —
        called at every placement and promotion.  A new pool tensor
        (``index_copy``, not in place), so waves in flight keep theirs.
        No-op while the pool is dormant."""
        if self._slot_w is None:
            return
        pairs = list(pairs)
        if not pairs:
            return
        ws = torch.stack([self._pool_readout(sid, slot).to(self._slot_w)
                          for sid, slot in pairs])
        self._slot_w = self._slot_w.index_copy(
            0, self._index(slot for _, slot in pairs), ws)

    # ------------------------------------------------------------------ flush
    def flush(self, *, method: str = "auto", chunk: int = 128,
              want_outputs: bool = False,
              max_waves: Optional[int] = None,
              decode_interleave: bool = False,
              decode_sids=None, refit: bool = False
              ) -> Dict[Hashable, object]:
        """The drain loop behind ``ReservoirEngine.flush``: pop same-bucket
        waves from the scheduler and run each as one batched prefill; with
        ``decode_interleave`` run the protected decoders' decode waves
        whenever the next prefill wave would overrun their SLO budget.
        Planning only reorders waves, so every output is bit-exact against
        the decode-blind schedule.  ``refit``: then one refit wave over the
        learn plane's dirty sessions — after the due decode wave when its
        predicted cost would overrun the decode budget."""
        if not decode_interleave:
            decode_sids = []
        else:
            decode_sids = self._protected(decode_sids)
        results: Dict[Hashable, object] = {}
        protect = frozenset(decode_sids)
        waves_run = 0
        just_decoded = False
        while max_waves is None or waves_run < max_waves:
            # Paged engine: capacity counts demotable hot sessions too (a
            # full arena admits by parking its LRU idle sessions); the true
            # free-slot count lets the budget fit price the demote page
            # wave the overflow forces.
            capacity = self._capacity(protect)
            free = (self.table.free_slots if self.store is not None
                    else None)
            if not self.scheduler.has_runnable(capacity):
                break
            budget = (self._decode_budget(decode_sids)
                      if decode_sids else None)
            wave = self.scheduler.next_wave(capacity, budget_us=budget,
                                            free_slots=free)
            if not wave:
                if not just_decoded:
                    # Runnable prefill exists but is over the decode budget:
                    # a decode wave runs instead and resets the clock.  It
                    # does not count toward max_waves (a flush(max_waves=1)
                    # loop under an unsatisfiable SLO must still progress).
                    self._decode_due(decode_sids)
                    just_decoded = True
                    continue
                # Fresh budget: waive the shrink-efficiency floor — a
                # slow-but-SLO-compliant part-wave beats blowing the budget.
                wave = self.scheduler.next_wave(
                    capacity, budget_us=self._decode_budget(decode_sids),
                    shrink_floor=0.0, free_slots=free)
                if not wave:
                    # Not even one row fits the SLO: run unbudgeted rather
                    # than spin decode-only forever.
                    wave = self.scheduler.next_wave(capacity,
                                                    free_slots=free)
                    if not wave:
                        break
            just_decoded = False
            waves_run += 1
            self._make_room(wave, protect)
            self._run_wave(wave, capacity, results, method=method,
                           chunk=chunk, want_outputs=want_outputs)
            if (self.pipeline_depth > 0 and not self._autotune
                    and self.store is not None):
                # Plan one wave ahead against the slot table (already
                # updated at launch) and page its victims out now: the
                # demote gathers untouched rows from the gather base, so it
                # overlaps the scan just launched.  The next iteration pops
                # exactly this wave (peek is exact) and finds its slots
                # free.
                planned = self.scheduler.peek_wave(self._capacity(protect))
                if planned:
                    self._make_room(planned, protect)
        if refit:
            dirty = self.dirty_sids()
            if dirty and decode_sids and self.cost_model is not None:
                b = self._decode_budget(decode_sids)
                if (b is not None and
                        self.cost_model.predict_refit_us(len(dirty)) > b):
                    # The refit wave would blow the decode budget: decode
                    # first (fresh budget), then solve.
                    self._decode_due(decode_sids)
            self.refit_wave(dirty)
        return results

    def _protected(self, decode_sids) -> List[Hashable]:
        """Validate an interleaved flush and resolve its protected decoders
        (default: every ready session), tracking each one's deadline and
        resolving ``decode_wave_tokens="auto"`` for this flush."""
        if self.decode_slo_us is None:
            # Per-session SLOs (submit(decode_slo_us=...)) license the flush
            # only for an explicit, fully-tracked protected set.
            if (decode_sids is None or not decode_sids
                    or any(self.scheduler.decode_slo_of(s) is None
                           for s in decode_sids)):
                raise ValueError(
                    "decode_interleave=True needs decode_slo_us set on the "
                    "engine — the latency budget that prices when a decode "
                    "wave must preempt prefill")
        driven_ok = (decode_sids is not None and decode_sids
                     and all(self.input_depth(s) > 0 for s in decode_sids))
        if self.readout is None or (self.cfg.d_in != self.cfg.d_out
                                    and not driven_ok):
            raise ValueError(
                "interleaved decode waves free-run (closed loop): the engine "
                "needs a trained readout and d_in == d_out")
        if decode_sids is not None:
            decode_sids = list(dict.fromkeys(decode_sids))
            # A parked decoder is still a valid protected decoder: promote
            # it now so the ready check sees it.
            self._ensure_hot(decode_sids)
        ready = self.table.ready
        if decode_sids is None:
            decode_sids = list(ready)
        else:
            missing = [s for s in decode_sids if s not in set(ready)]
            if missing:
                raise KeyError(f"decode_sids must be ready sessions; not "
                               f"ready: {missing!r}")
        if self.decode_slo_us is not None:
            for s in decode_sids:
                if self.scheduler.decode_slo_of(s) is None:
                    self.scheduler.track_decode(s, self.decode_slo_us)
        if self._decode_k_auto and self.cost_model is not None:
            # K-adaptive wave sizing from the fitted c_dec(B, K) surface,
            # capped so the whole wave fits the tightest SLO in the set.
            slo = self.decode_slo_us
            if decode_sids:
                slo = min(self.scheduler.decode_slo_of(s)
                          for s in decode_sids)
            self.decode_wave_tokens = self.cost_model.best_decode_k(
                max(1, len(decode_sids)), slo_us=slo)
        return decode_sids

    def _decode_budget(self, decode_sids) -> Optional[float]:
        """Remaining decode latency budget in microseconds: the minimum over
        the protected decoders' deadlines tracked in the scheduler, with the
        decode wave's own predicted cost c_dec(B, K) reserved up front (the
        gap the SLO bounds ends when the wave's tokens exist)."""
        if self.cost_model is None:
            return None
        reserve = self.cost_model.predict_decode_us(len(decode_sids),
                                                    self.decode_wave_tokens)
        return self.scheduler.decode_budget(reserve, among=decode_sids)

    def _decode_due(self, decode_sids) -> None:
        """Run the interleaved decode wave(s) for the *due* subset of the
        protected decoders (all of them under one engine-wide SLO).
        Sessions with queued open-loop inputs advance teacher-driven
        (:meth:`_driven_wave`); the rest free-run."""
        reserve = (self.cost_model.predict_decode_us(
            len(decode_sids), self.decode_wave_tokens)
            if self.cost_model is not None else 0.0)
        due = self.scheduler.due_decode_sids(reserve, among=decode_sids)
        if not due:
            due = list(decode_sids)
        driven = [s for s in due if self.input_depth(s) > 0]
        free = [s for s in due if self.input_depth(s) == 0]
        if free and self.cfg.d_in == self.cfg.d_out:
            self._decode_wave(free)
        if driven:
            self._driven_wave(driven)

    def _dispatch_decode(self, launch, sids, *, tokens: int, block: bool,
                         interleave: bool = False, kind: str = "closed_loop",
                         slots=None):
        """Every decode launch goes through here.  ``launch`` makes the call
        and stores the new arena.  Timed when ``block`` (an interleaved wave:
        its tokens must exist before the deadline resets) or under autotune:
        the clock stops after a wait for the launch's event, which also
        retires the queued prefill waves it depends on; autotune records the
        whole K-token wave as ONE point on c_dec(B, K).  Otherwise the
        launch joins the in-flight window at its predicted cost as a writer
        of ``slots`` (its decode mask)."""
        timed = (block or self._autotune) and sids and tokens
        arena_before, base_event = self.arena, self._base_mark()
        t0 = time.perf_counter() if timed else None
        out = launch()
        us = None
        if t0 is not None:
            us = self._sync_us(t0)
            if self._autotune:
                self.cost_model.observe_decode(len(sids), us, k=tokens)
        elif self.pipeline_depth > 0 and slots is not None:
            pred = (self.cost_model.predict_decode_us(len(sids), tokens)
                    if self.cost_model is not None and sids and tokens
                    else 1.0)
            self._inflight_admit(pred, slots, arena_before, base_event)
        else:
            self._pipeline_invalidate()
        if sids and tokens:
            self._note_decode(sids, us=us, tokens=tokens,
                              interleave=interleave, kind=kind)
        return out

    def _decode_wave(self, sids: List) -> None:
        """One interleaved decode wave: every due decoder free-runs
        ``decode_wave_tokens`` tokens in one fused launch, buffered for
        ``collect_decoded``.  Always waits until its tokens exist: the
        decode SLO is a latency contract."""
        k = self.decode_wave_tokens
        slots = self._take(sids, k)

        def launch():
            self.arena, ys = arena_mod.closed_loop_fused(
                self.params, self._wave_w(), self.arena, self._mask(slots), k,
                self._ens_weights, **self._kw())
            return ys

        ys = self._dispatch_decode(launch, sids, tokens=k, block=True,
                                   interleave=True, kind="interleave")
        self.note_freerun(sids, k)
        self._buffer(sids, ys)

    def _driven_wave(self, sids: List) -> None:
        """One interleaved *teacher-driven* decode wave: drain up to
        ``decode_wave_tokens`` queued inputs per session (capped by the
        shallowest queue, so every row steps the same K) through ONE
        ``arena.driven_loop`` call — bit-identical to K ``decode_step``
        calls on the same inputs."""
        k = min([self.decode_wave_tokens]
                + [self.input_depth(s) for s in sids])
        if k < 1:
            return
        u_seq = np.zeros((k, self.max_slots, self.cfg.d_in), self._np_dtype)
        for sid in sids:
            u_seq[:, self.table.sessions[sid].slot] = np.stack(
                self.pop_inputs(sid, k))
        slots = self._take(sids, k)

        def launch():
            self.arena, ys = arena_mod.driven_loop(
                self.params, self._wave_w(), self.arena, self._mask(slots),
                self._tensor(u_seq), self._ens_weights, **self._kw())
            return ys

        ys = self._dispatch_decode(launch, sids, tokens=k, block=True,
                                   interleave=True, kind="driven")
        self.note_freerun(sids, k)
        self._buffer(sids, ys)

    def _take(self, sids, tokens: int) -> List[int]:
        """Account ``tokens`` decoded tokens to each session; their slots."""
        slots = []
        for sid in sids:
            st = self.table.sessions[sid]
            st.tokens_decoded += tokens
            st.last_use = self.table.tick()
            slots.append(st.slot)
        return slots

    def _buffer(self, sids, ys) -> None:
        """Buffer each session's column of ``ys`` (K, B, D) for
        ``collect_decoded``."""
        for sid in sids:
            self._decode_buf.setdefault(sid, []).append(
                ys[:, self.table.sessions[sid].slot])

    def _note_decode(self, sids, *, us=None, tokens: int = 1,
                     interleave: bool = False,
                     kind: str = "closed_loop") -> None:
        """Decode accounting shared by every decode path: ONE telemetry
        event, the per-launch metadata ``collect_decoded`` reports, and the
        scheduler's deadline reset for these sessions."""
        wall = time.perf_counter()
        route = ("step" if kind in ("step", "driven") else
                 arena_mod.closed_loop_route(self.params, self._wave_w(),
                                             self.arena,
                                             ensemble=self.ensemble))
        self._decode_meta.append({"kind": kind, "rows": len(sids),
                                  "tokens": int(tokens), "us": us,
                                  "fused": route == "fused",
                                  "_pending": set(sids)})
        self.tracker.log_wave({"kind": "decode", "wall": wall,
                               "sids": list(sids), "rows": len(sids),
                               "tokens": int(tokens), "us": us,
                               "mode": "interleave" if interleave else kind,
                               "route": route})
        self.scheduler.note_decoded(sids, wall=wall)

    # -------------------------------------------------------------- prefill
    def _run_wave(self, wave: List[WaveItem], capacity: int,
                  results: Dict[Hashable, object], *, method: str,
                  chunk: int, want_outputs: bool) -> None:
        from .ingest import SessionStats
        arena_before, base_event = self.arena, self._base_mark()
        touched: set = set()
        fresh = [it for it in wave if it.first]
        if fresh:
            h0s = np.zeros((len(fresh), self.cfg.n), self._np_dtype)
            y0s = np.zeros((len(fresh), self.cfg.d_out), self._np_dtype)
            slots = []
            for i, it in enumerate(fresh):
                slot = self.table.slots.index(None)
                self.table.slots[slot] = it.sid
                self.table.sessions[it.sid] = SessionStats(
                    slot=slot, prefill_pending=not it.last,
                    last_use=self.table.tick())
                if it.req.h0 is not None:
                    h0s[i] = it.req.h0
                if it.req.y0 is not None:
                    y0s[i] = it.req.y0
                slots.append(slot)
                self.note_admission(it.sid, it.req.tenant)
            touched.update(slots)
            self.arena = arena_mod.place_many(
                self.arena, self._arena_index(slots), self._tensor(h0s),
                self._tensor(y0s))
            # Freshly placed slots serve their tenant's pool readout from
            # their first wave, not the engine-wide base.
            self.sync_slot_readouts(
                [(it.sid, s) for it, s in zip(fresh, slots)])
        prompts = [it for it in wave if it.req.u is not None]
        if not prompts:
            self._record_wave(0, len(wave), len(fresh), capacity, 0, None)
            if fresh and self.pipeline_depth > 0 and not self._autotune:
                self._inflight_admit(1.0, touched, arena_before, base_event)
            return                  # admission-only wave (bucket 0)
        # Max over the rows: a padded-up remainder chunk rides a wave whose
        # bucket is set by its longest row; its own padded tail is inert.
        t_bucket = max(bucket_length(it.length,
                                     bucket_min=self.scheduler.bucket_min)
                       for it in prompts)
        bw = len(prompts)
        u_pad = np.zeros((bw, t_bucket, self.cfg.d_in), self._np_dtype)
        lengths = np.zeros((bw,), np.int64)
        yt_pad = (np.zeros((bw, t_bucket, self.cfg.d_out), self._np_dtype)
                  if self.cfg.use_feedback else None)
        for i, it in enumerate(prompts):
            u_pad[i, :it.length] = it.req.u[it.start:it.stop]
            lengths[i] = it.length
            if yt_pad is not None:
                yt_pad[i, :it.length] = it.req.y_teacher[it.start:it.stop]
        slot_list = [self.table.sessions[it.sid].slot for it in prompts]
        touched.update(slot_list)
        wave_method = method
        if wave_method == "auto" and self.params.mode == "diag":
            wave_method = dispatch.resolve_method(t_bucket, device=self.device,
                                                  chunk=chunk)
        t0 = None
        if self._autotune:
            # Settle the predecessors before the clock starts, so the timed
            # c(B, T) record is this wave's own.
            self._drain_inflight()
            t0 = time.perf_counter()
        self.arena, out = arena_mod.prefill_wave(
            self.params, self._wave_w(), self.arena,
            self._arena_index(slot_list),
            self._tensor(u_pad), self._tensor(lengths),
            None if yt_pad is None else self._tensor(yt_pad),
            batched=self._batched, method=wave_method, chunk=chunk,
            want_outputs=want_outputs)
        us = None
        if t0 is not None:
            # Timing a wave means waiting for it: autotune trades a host
            # sync per wave for a cost model that tracks this machine.
            us = self._sync_us(t0)
            self.cost_model.observe(bw, t_bucket, us)
        elif self.pipeline_depth == 0:
            # Strict synchronous reference: every wave lands before the host
            # plans the next.
            tb0 = time.perf_counter()
            _wait(_record_event(self.device))
            self.tracker.log_wave({"kind": "host_block",
                                   "us": (time.perf_counter() - tb0) * 1e6})
        else:
            self._inflight_admit(self.cost_model.predict_us(bw, t_bucket)
                                 if self.cost_model is not None else 1.0,
                                 touched, arena_before, base_event)
        self._record_wave(t_bucket, len(wave), len(fresh), capacity,
                          int(lengths.sum()), us)
        # Charge the decode deadlines with what this wave cost (measured
        # under autotune, else predicted): the budget interleaved flushes
        # plan against is the prefill cost since the last decode wave.
        if us is not None:
            self.scheduler.charge_decode_cost(us)
        elif self.cost_model is not None:
            self.scheduler.charge_decode_cost(
                self.cost_model.predict_us(bw, t_bucket))
        for i, it in enumerate(prompts):
            st = self.table.sessions[it.sid]
            st.tokens_prefilled += int(lengths[i])
            st.last_use = self.table.tick()
            if want_outputs:
                self._chunk_outs.setdefault(it.sid, []).append(
                    out[i, :int(lengths[i])])
            if it.last:
                st.prefill_pending = False
                self.on_prompt_done(
                    it.sid,
                    None if it.req.y_teacher is None
                    else it.req.y_teacher[it.stop - 1])
                # Pop unconditionally so a later session reusing the sid
                # never inherits this one's chunk outputs.
                chunks = self._chunk_outs.pop(it.sid, None)
                results[it.sid] = (None if not want_outputs
                                   else torch.cat(chunks))

    def _record_wave(self, t_bucket: int, rows: int, fresh: int,
                     capacity: int, tokens: int,
                     us: Optional[float]) -> None:
        self.tracker.log_wave({"kind": "prefill", "t_bucket": t_bucket,
                               "rows": rows, "fresh": fresh,
                               "capacity": capacity, "tokens": tokens,
                               "occupancy": rows / self.max_slots,
                               "us": us})

    # ------------------------------------------------------------- lifecycle
    def place(self, sid, slot: int, h0, y0) -> int:
        from .ingest import SessionStats
        h0 = np.zeros(self.cfg.n, self._np_dtype) if h0 is None else h0
        y0 = np.zeros(self.cfg.d_out, self._np_dtype) if y0 is None else y0
        self.arena = arena_mod.place(self.arena, slot, h0, y0)
        self._pipeline_taint([slot])
        self.table.slots[slot] = sid
        self.table.sessions[sid] = SessionStats(slot=slot)
        self.sync_slot_readouts([(sid, slot)])
        return slot

    def release(self, sid: Hashable, *, drop: bool = False):
        """The one session-release body (see the facade docstring)."""
        self.scheduler.untrack_decode(sid)
        if self.store is not None and sid in self.store:
            decoded = self.collect_decoded(sid)
            self.tracker.log_wave({"kind": "release", "sid": sid})
            self.pop_learn(sid)
            states, ys, _ = self.store.fetch_many([sid])
            if drop:
                return EvictResult(None, None, decoded)
            return EvictResult(states[0], ys[0], decoded)
        if sid not in self.table.sessions:
            try:
                req = self.scheduler.cancel(sid)
            except KeyError:
                raise KeyError(
                    f"session {sid!r} is neither active nor queued") from None
            self.pop_learn(sid)
            decoded = self.collect_decoded(sid)
            if drop:
                return EvictResult(None, None, decoded)
            return EvictResult(req.h0, req.y0, decoded)
        decoded = self.collect_decoded(sid)
        st = self.table.sessions.pop(sid)
        if st.prefill_pending:
            # The chunk remainder is still queued; the arena slot holds the
            # partial carry.
            self.scheduler.cancel(sid)
        self._chunk_outs.pop(sid, None)
        self.tracker.log_wave({"kind": "release", "sid": sid})
        self.pop_learn(sid)
        if drop:
            state = y = None
        else:
            state = self.arena.states[st.slot]
            y = self.arena.y_prev[st.slot]
        self.table.slots[st.slot] = None
        self.arena = arena_mod.release(self.arena, st.slot)
        # The freed slot may be re-placed outside the wave bookkeeping: the
        # base can no longer vouch for it, but every other row is untouched.
        self._pipeline_taint([st.slot])
        for req in self.scheduler:
            if req.u is None:
                self.scheduler.cancel(req.sid)
                self.place(req.sid, st.slot, req.h0, req.y0)
                break
        return EvictResult(state, y, decoded)

    def reset(self) -> None:
        self._drain_inflight()
        self._pipeline_invalidate()
        self.arena = self._fresh_arena()
        self.table.clear()
        if self.store is not None:
            self.store.clear()
        self._chunk_outs.clear()
        self._slot_w = None
        self._decode_buf.clear()
        self._decode_meta.clear()
        self.tracker.log_wave({"kind": "reset"})

    def _active(self, sid: Hashable):
        """Resolve an *admitted, decodable* session, with descriptive errors
        for the natural submit-then-use flow."""
        try:
            st = self.table.sessions[sid]
        except KeyError:
            if self.scheduler.has(sid):
                raise KeyError(
                    f"session {sid!r} is queued, not yet admitted — flush() "
                    f"(or wait for a release) before using it") from None
            raise
        if st.prefill_pending:
            raise KeyError(
                f"session {sid!r} still has prefill chunk waves in flight — "
                f"flush() until its prompt completes before decoding")
        return st

    def state_of(self, sid: Hashable) -> np.ndarray:
        if self.store is not None and sid in self.store:
            # A read-only peek: inspecting a parked session never promotes.
            return self.store.peek(sid)[0]
        return self.arena.states[self._active(sid).slot].cpu().numpy()

    # ---------------------------------------------------------------- decode
    def _mask(self, slots) -> torch.Tensor:
        mask = np.zeros((self.max_slots,), bool)
        mask[list(slots)] = True
        return self._tensor(mask)

    def decode_step(self, inputs: Dict[Hashable, "np.ndarray"]):
        """One batched open-loop token for the sessions in ``inputs``
        (sid -> (d_in,) input).  Returns sid -> (d_out,) host output."""
        # Decoding a parked session promotes it; then resolve every sid and
        # validate every vector before mutating anything.
        self._ensure_hot(list(inputs))
        stats = {sid: self._active(sid) for sid in inputs}
        vecs = {sid: np.asarray(vec, self._np_dtype).reshape(self.cfg.d_in)
                for sid, vec in inputs.items()}
        u = np.zeros((self.max_slots, self.cfg.d_in), self._np_dtype)
        for sid, vec in vecs.items():
            u[stats[sid].slot] = vec
        slots = self._take(list(vecs), 1)
        self.note_steps(list(vecs))

        def launch():
            self.arena, y = arena_mod.decode_step(
                self.params, self._wave_w(), self.arena, self._tensor(u),
                self._mask(slots), self._ens_weights, **self._kw())
            return y

        y = self._dispatch_decode(launch, list(vecs), tokens=1, block=False,
                                  kind="step", slots=slots)
        if self.learn_active():
            # The learn plane copies the post-step arena to the host in one
            # piece for the observe() accumulation that typically follows.
            self.cache_post_step(self.arena)
        if self.readout is None:
            return {}
        y = y.cpu().numpy()
        out = {sid: y[stats[sid].slot] for sid in inputs}
        for sid in out:
            # A session that grew DPG members returns the weighted vote over
            # primary + members (the members advance in the learn plane).
            out[sid] = self.vote(sid, vecs[sid], out[sid])
        for sid, row in out.items():
            self._decode_buf.setdefault(sid, []).append(
                self._tensor(row)[None])
        return out

    def observe(self, sid: Hashable, y_true) -> None:
        """Teacher forcing: ``y_true`` replaces ``sid``'s fed-back output, so
        its next decode step drives from the truth.  Under
        ``ensemble="mean"`` every ready session's feedback row takes it (the
        fused prediction fed every stepped slot)."""
        self._ensure_hot([sid])        # a parked sid promotes
        st = self._active(sid)
        st.last_use = self.table.tick()
        y_host = host_array(y_true, self._np_dtype).reshape(self.cfg.d_out)
        # The learn plane reads the PRE-observe rows (or its post-step
        # snapshot), so it runs before the arena rewrite below.
        self.on_observe(sid, st.slot, y_host, self.arena)
        y = self._tensor(y_host)
        if self.ensemble == "mean":
            ready = [self.table.sessions[s].slot for s in self.table.ready]
            self._pipeline_taint(ready)
            self.arena = arena_mod.force_output(self.arena, ready, y)
            return
        self._pipeline_taint([st.slot])
        self.arena = arena_mod.force_output(self.arena, st.slot, y)

    def decode_closed_loop(self, n_steps: int, sids=None):
        """Free-run ``n_steps`` tokens for ``sids`` (default: every ready
        session) in one fused launch.  Returns sid -> (n_steps, d_out)
        device tensor."""
        if self.readout is None:
            raise ValueError("closed-loop decode needs a trained readout")
        if self.cfg.d_in != self.cfg.d_out:
            raise ValueError("closed loop requires d_in == d_out")
        targets = list(dict.fromkeys(
            self.table.ready if sids is None else sids))
        self._ensure_hot(targets)      # parked targets promote
        stats = {sid: self._active(sid) for sid in targets}  # validate first
        slots = self._take(targets, n_steps)

        def launch():
            self.arena, ys = arena_mod.closed_loop_fused(
                self.params, self._wave_w(), self.arena, self._mask(slots),
                int(n_steps), self._ens_weights, **self._kw())
            return ys

        ys = self._dispatch_decode(launch, targets, tokens=n_steps,
                                   block=False, slots=slots)
        self.note_freerun(targets, n_steps)
        out = {sid: ys[:, stats[sid].slot] for sid in targets}
        for sid, arr in out.items():
            self._decode_buf.setdefault(sid, []).append(arr)
        return out

    def collect_decoded(self, sid: Optional[Hashable] = None) -> DecodeResult:
        """Drain the decoded tokens every decode path buffered (all
        sessions, or just ``sid``).  Buffers clear on read."""
        if sid is not None:
            chunks = self._decode_buf.pop(sid, [])
            arr = (torch.cat(chunks) if chunks else
                   torch.zeros((0, self.cfg.d_out), dtype=self._dtype,
                               device=self.device))
            waves = []
            for meta in list(self._decode_meta):
                pending = meta["_pending"]
                if sid in pending:
                    waves.append({k: v for k, v in meta.items()
                                  if k != "_pending"})
                    pending.discard(sid)
                    if not pending:
                        self._decode_meta.remove(meta)
            return DecodeResult(tokens={sid: arr}, waves=tuple(waves))
        out = {s: torch.cat(c) for s, c in self._decode_buf.items()}
        self._decode_buf.clear()
        waves = tuple({k: v for k, v in meta.items() if k != "_pending"}
                      for meta in self._decode_meta)
        self._decode_meta.clear()
        return DecodeResult(tokens=out, waves=waves)
