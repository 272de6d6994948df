"""WaveScheduler — host-side admission layer of the serving stack.

Replaces the engine's synchronous FIFO-on-add admission: requests *accumulate*
(:meth:`WaveScheduler.submit`), are grouped into power-of-two prompt-length
**buckets**, and drain in **waves** (:meth:`WaveScheduler.next_wave`) — each
wave is a same-bucket group that the arena layer runs as ONE
``(B_wave, T_bucket)`` batched prefill instead of B sequential scans.
Bucketing by padded length is what makes the batching free: every wave of a
bucket reuses one compiled trace, and the arena's length-gather makes the
padded tail steps inert.

Two orthogonal extensions ride on the same queue:

* **Chunked long prompts** (``chunk_max``): a prompt longer than
  ``chunk_max`` drains as K sequential chunks — each chunk is a row in an
  ordinary wave, resumed from the slot's carried state
  (``arena.prefill_wave`` starts every row from the arena, so chunk K+1
  continues chunk K bit-exactly).  Only the *first* chunk consumes a free
  slot; later chunks are **continuations** of a slot the session already
  holds, so they are runnable even at zero free capacity.  After a non-final
  chunk the request re-enters at the queue *tail* (chunk-granularity
  round-robin): a 500k-token prompt yields the arena between chunks instead
  of monopolizing it.
* **Cost-model planning** (``cost_model``): with a
  :class:`~repro_torch.serve.cost.WaveCostModel` attached, :meth:`next_wave`
  runs a two-wave lookahead — it may *defer* the oldest request's wave by exactly
  one wave when committing the free-slot budget to another bucket first
  strictly improves predicted tokens-per-second over the two-wave horizon
  (the fix for fragmenting buckets under-filling waves).  The deferral is
  **committed**: the very next wave must serve the deferred anchor, so the
  no-starvation bound only gains a one-wave slack.
* **Decode-aware budgets** (``next_wave(budget_us=...)``): the engine passes
  the remaining decode latency budget when ready-to-decode sessions are
  waiting (``decode_slo_us`` minus the prefill cost already charged since
  their last decode wave, minus the fused K-token decode wave's own
  reserved cost ``c_dec(B, K)`` — planning prices the whole multi-token
  wave, not K single steps).  A candidate wave whose predicted cost exceeds
  the budget is *shrunk* from the tail (youngest rows first — the anchor is
  never trimmed away) until it fits; when even the anchor alone cannot fit,
  the wave is deferred entirely (``[]`` returns, nothing pops) and the
  engine interleaves a decode wave before retrying.  The budget only ever
  removes or delays rows — arrival order within a bucket is untouched, so
  the fairness bounds survive with the decode waves inserted between.  The
  engine's streaming-refit waves (``flush(refit=True)``) are priced on the
  same budget via the cost model's ``c_refit(B)`` surface: a refit that
  would blow the decode SLO yields to a decode wave first.
* **Page-cost pricing** (``next_wave(free_slots=...)``): with a paged
  session store (``serve.store``) the engine's ``capacity`` counts
  demotable hot sessions, so a wave may admit more fresh rows than there
  are free slots — the overflow is a demote page wave the engine runs
  first.  Passing the *true* free-slot count lets the budget fit charge
  each candidate wave ``c_page(fresh - free_slots)`` on top of its prefill
  cost, so promote/demote waves compete with prefill and decode under the
  same latency budget instead of being a blind spot.
* **Pipelined planning** (``peek_wave``): the exact wave ``next_wave``
  would pop, computed without popping — the pipelined engine plans wave
  k+1 against predicted post-wave occupancy while wave k is still in
  flight.  **Mixed-kind waves** ride on :meth:`bucket_of`: a chunked
  prompt's remainder chunk pads up into the full chunk bucket when the
  cost model prices the extra inert scan steps below the extra wave
  dispatch a separate small wave would cost.

Scheduling invariants, all pinned by test:

* **No starvation**: the wave is formed around the *oldest* pending request
  (global arrival order), topped up with younger same-bucket requests.  With
  a cost model the anchor may be deferred, but at most one wave and never
  twice in a row: over any two consecutive waves the front of the arrival
  order strictly drains.
* **Evict-while-queued**: :meth:`cancel` removes a request before admission
  — or mid-chunk-sequence — and hands it back with its progress cursor, so
  the engine can return the partial carry (the slot state of the chunks that
  already ran) instead of leaking orphan chunks into a reassigned slot.

The scheduler is pure host bookkeeping: no torch imports, no device state —
that all lives a layer down in ``serve.arena``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np

__all__ = ["PrefillRequest", "WaveItem", "bucket_length", "WaveScheduler",
           "host_array"]


def host_array(v, dtype):
    """``v`` (numpy array, sequence, or tensor on any device) as a host
    numpy array of ``dtype``.  Here, below both planes, so that the ingest
    and exec planes share it without importing each other."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype)

#: Deferral margin: the lookahead plan must beat serving the anchor first by
#: this factor in predicted tok/s before the anchor is pushed back one wave —
#: fairness is the default, reordering has to pay for itself.
_DEFER_MARGIN = 1.05

#: Budget-shrink efficiency floor: a decode-budget-trimmed wave must retain
#: at least this fraction of the full wave's predicted tokens-per-second.
#: When wave cost is alpha-dominated (dispatch overhead), a shrunk wave pays
#: nearly the full cost for a fraction of the tokens — deferring (decode
#: now, full wave on the fresh budget) is strictly better for throughput
#: and equally SLO-safe; shrinking only wins in the beta-dominated regime.
_SHRINK_EFFICIENCY = 0.9


@dataclasses.dataclass
class PrefillRequest:
    """One queued admission: session id, optional prompt, optional parked
    state.  ``u`` is None for admission-only requests
    (``submit(sid, h0=...)`` with no prompt) — they ride bucket 0.
    ``done`` is the chunk cursor: tokens already drained into the arena by
    earlier chunk waves (0 for whole-prompt requests).  ``tenant`` is the
    engine's readout-pool key (sessions sharing a tenant serve — and
    refit — one readout).  Arrival order is the queue's list order; the
    engine validates/coerces every array *before* a request is
    constructed."""
    sid: Hashable
    u: Optional[object] = None            # (T, D_in) prompt or None
    y_teacher: Optional[object] = None    # (T, D_out) for feedback models
    h0: Optional[object] = None           # parked state to resume from
    y0: Optional[object] = None
    done: int = 0                         # tokens consumed by popped chunks
    tenant: Optional[Hashable] = None     # readout-pool key (engine-owned)

    @property
    def length(self) -> int:
        return 0 if self.u is None else int(self.u.shape[0])


@dataclasses.dataclass(frozen=True)
class WaveItem:
    """One row of a popped wave: the request plus the ``[start, stop)`` token
    window this wave consumes.  ``first`` rows are admissions (the engine
    must allocate a slot and place ``h0``/``y0``); non-first rows continue a
    slot the session already holds.  ``last`` rows complete the prompt (the
    session becomes decodable)."""
    req: PrefillRequest
    start: int
    stop: int
    first: bool
    last: bool

    @property
    def sid(self) -> Hashable:
        return self.req.sid

    @property
    def length(self) -> int:
        return self.stop - self.start


def bucket_length(t: int, *, bucket_min: int = 16) -> int:
    """Padded prompt length for a T-token prompt: the next power of two, at
    least ``bucket_min`` (tiny prompts share one trace instead of compiling
    per length).  T=0 (admission-only) stays bucket 0."""
    if t <= 0:
        return 0
    return max(bucket_min, 1 << (t - 1).bit_length())


class WaveScheduler:
    """Accumulate requests; drain them as same-bucket waves, oldest first
    (modulo the committed one-wave lookahead deferral)."""

    def __init__(self, *, bucket_min: int = 16,
                 max_wave: Optional[int] = None,
                 chunk_max: Optional[int] = None,
                 cost_model=None):
        self.bucket_min = int(bucket_min)
        # Legacy static cap on rows per wave (None: the caller's capacity,
        # i.e. free slots).  Kept as an override/baseline knob — the cost
        # model is the replacement for tuning it by hand.  The engine
        # preserves it across reset().
        self.max_wave = max_wave
        if chunk_max is not None and int(chunk_max) < 1:
            raise ValueError(f"chunk_max must be >= 1, got {chunk_max}")
        self.chunk_max = None if chunk_max is None else int(chunk_max)
        self.cost_model = cost_model
        self._queue: List[PrefillRequest] = []
        self._sids: set = set()           # O(1) membership for has()
        self._deferred: Optional[Hashable] = None
        # Per-session decode deadlines: sid -> [slo_us, charged_us, stamp].
        # ``charged_us`` is the predicted/measured non-decode cost (prefill,
        # page, refit waves) accrued since the sid's last decode; ``stamp``
        # the wall time of that decode.  The consumed budget is the larger
        # of the two — host overhead eats latency no cost model predicts.
        # The globals seed fresh entries so a newly tracked sid inherits
        # the cost charged since the last decode of ANY session (exactly
        # the engine-wide clock this table replaces).
        self._decode: Dict[Hashable, list] = {}
        self._decode_charge = 0.0
        self._decode_stamp = time.perf_counter()

    # ------------------------------------------------------------- queueing
    def submit(self, req: PrefillRequest) -> None:
        if req.sid in self._sids:
            raise KeyError(f"session {req.sid!r} already queued")
        self._queue.append(req)
        self._sids.add(req.sid)

    def has(self, sid: Hashable) -> bool:
        return sid in self._sids

    def cancel(self, sid: Hashable) -> PrefillRequest:
        """Remove a not-yet-finished request (client disconnected); returns
        it so the caller can hand back the parked ``(h0, y0)``.  For a
        chunk-in-flight request the returned ``req.done`` records how many
        tokens earlier chunk waves already drained — the *partial carry*
        lives in the arena slot, and the engine (which owns the slot table)
        returns it from :meth:`ReservoirEngine.release`."""
        for i, r in enumerate(self._queue):
            if r.sid == sid:
                self._sids.discard(sid)
                if self._deferred == sid:
                    self._deferred = None
                return self._queue.pop(i)
        raise KeyError(f"session {sid!r} is not queued")

    def __len__(self) -> int:
        return len(self._queue)

    def __iter__(self):
        return iter(self._queue)

    @property
    def pending_sids(self):
        return [r.sid for r in self._queue]

    # ---------------------------------------------------------------- waves
    def _next_len(self, req: PrefillRequest) -> int:
        """Length of the request's next chunk (the whole remainder when
        chunking is off or the remainder fits)."""
        rem = req.length - req.done
        if self.chunk_max is not None and rem > self.chunk_max:
            return self.chunk_max
        return rem

    def _base_bucket(self, req: PrefillRequest) -> int:
        """The unpadded bucket of the request's next chunk."""
        return bucket_length(self._next_len(req), bucket_min=self.bucket_min)

    def bucket_of(self, req: PrefillRequest) -> int:
        """Bucket the request's *next chunk* rides (== the whole prompt's
        bucket when chunking is off).

        **Mixed-kind waves**: a chunked prompt's *remainder* chunk (shorter
        than ``chunk_max``) pads **up** into the full chunk bucket when the
        cost model says the extra inert scan steps are cheaper than the
        extra wave dispatch a separate small-bucket wave would cost — i.e.
        when other requests are riding the chunk bucket right now, so the
        remainder can join their wave as one more row (marginal cost ~
        ``beta_T``) instead of paying its own ``alpha_T``.  Padded rows are
        bit-exact by construction: the engine pads every row to the wave
        bucket and gathers the final state at the true length, so the extra
        steps are inert."""
        b = self._base_bucket(req)
        if (self.cost_model is None or self.chunk_max is None
                or req.done == 0):
            return b
        b_chunk = bucket_length(self.chunk_max, bucket_min=self.bucket_min)
        if b >= b_chunk:
            return b
        others = sum(1 for r in self._queue
                     if r.sid != req.sid and self._base_bucket(r) == b_chunk)
        if not others:
            return b                     # no wave to join — padding is waste
        sep = self.cost_model.predict_us(1, b)
        joined = (self.cost_model.predict_us(others + 1, b_chunk)
                  - self.cost_model.predict_us(others, b_chunk))
        return b_chunk if joined < sep else b

    def _item(self, req: PrefillRequest) -> WaveItem:
        ln = self._next_len(req)
        return WaveItem(req=req, start=req.done, stop=req.done + ln,
                        first=(req.done == 0),
                        last=(req.done + ln >= req.length))

    def _gather(self, bucket: int, capacity: int, skip=frozenset()
                ) -> List[WaveItem]:
        """The wave ``bucket`` would get right now: queue-order items, fresh
        (slot-consuming) rows capped by ``capacity``, continuations free,
        total rows capped by ``max_wave`` when set."""
        items: List[WaveItem] = []
        fresh = 0
        for r in self._queue:
            if r.sid in skip or self.bucket_of(r) != bucket:
                continue
            it = self._item(r)
            if it.first:
                if fresh >= capacity:
                    continue
                fresh += 1
            items.append(it)
            if self.max_wave is not None and len(items) >= self.max_wave:
                break
        return items

    def _anchor(self, capacity: int) -> Optional[PrefillRequest]:
        """Oldest *runnable* request: continuations always run (their slot is
        already held); fresh admissions need free capacity."""
        for r in self._queue:
            if r.done > 0 or capacity > 0:
                return r
        return None

    def has_runnable(self, capacity: int) -> bool:
        """Would :meth:`next_wave` have work right now (ignoring any decode
        budget)?  A non-popping probe: the engine's interleaved flush uses it
        to tell "queue drained / nothing admissible" apart from "prefill
        deferred for decode" — only the latter warrants a decode wave and a
        retry."""
        return self._anchor(max(0, int(capacity))) is not None

    def next_wave(self, capacity: int, *,
                  budget_us: Optional[float] = None,
                  shrink_floor: float = _SHRINK_EFFICIENCY,
                  free_slots: Optional[int] = None
                  ) -> List[WaveItem]:
        """Pop the next wave.  Returns [] when nothing is runnable.

        Without a cost model: the wave is anchored on the globally-oldest
        runnable request and topped up with younger same-bucket work — every
        pop strictly drains the front of the arrival order (no starvation).

        With a cost model: a two-wave lookahead may serve another bucket
        first when that strictly improves predicted tok/s over both waves
        (see :meth:`_plan_deferral`); the deferral is committed, so the
        anchor is served in the immediately-following wave.

        ``budget_us`` (needs a cost model): the remaining decode latency
        budget.  The popped wave's predicted cost must fit it — the wave is
        shrunk from its tail until it does, and deferred entirely (``[]``,
        nothing pops, queue untouched) when even one row cannot fit or the
        surviving wave would fall under ``shrink_floor`` of the full wave's
        predicted tok/s.  The caller owns the follow-up policy (run a
        decode wave, then retry — passing ``shrink_floor=0.0`` on the
        fresh-budget retry accepts *any* SLO-compliant wave rather than
        blowing the budget on the full one).

        ``free_slots`` (paged engines): the true free-slot count when
        ``capacity`` also counts demotable hot sessions.  The budget fit
        then adds the cost model's ``c_page(fresh_rows - free_slots)`` to
        each candidate wave — admitting beyond the free slots means the
        engine pages the overflow out first, and that page wave spends the
        same latency budget.  The lookahead deferral ignores page cost (it
        compares same-capacity plans, where the page term is near-equal);
        the budget fit is where an unpriced page wave would break an SLO.
        """
        wave, deferring, anchor = self._plan_wave(capacity,
                                                  budget_us=budget_us,
                                                  shrink_floor=shrink_floor,
                                                  free_slots=free_slots)
        if not wave:
            # Deferred for decode (or nothing runnable): nothing pops and
            # commitments are untouched — the engine retries after its
            # decode wave with a fresh budget, so the lookahead re-plans
            # the same queue.
            return []
        # Only a *popped* wave consumes or creates a commitment: a pending
        # deferral is honored by this wave (the anchor leads it), and a new
        # one is recorded only when the lookahead's alternative actually ran.
        self._deferred = anchor.sid if deferring else None
        return self._pop(wave)

    def peek_wave(self, capacity: int, *,
                  budget_us: Optional[float] = None,
                  shrink_floor: float = _SHRINK_EFFICIENCY,
                  free_slots: Optional[int] = None) -> List[WaveItem]:
        """The wave :meth:`next_wave` would pop right now, **without popping
        it** — no queue mutation, no deferral commitment, no chunk cursor
        advance.  The pipelined engine plans wave *k+1* against *predicted*
        post-wave occupancy while wave *k* is still in flight on the device:
        planning is pure host bookkeeping, so the pipeline never drains
        waiting for ground truth it can compute.  The peek is exact: called
        with the same arguments on the same queue state, ``next_wave``
        returns precisely this wave (pinned by test)."""
        wave, _, _ = self._plan_wave(capacity, budget_us=budget_us,
                                     shrink_floor=shrink_floor,
                                     free_slots=free_slots)
        return wave

    def _plan_wave(self, capacity: int, *, budget_us, shrink_floor,
                   free_slots):
        """Shared planning core of :meth:`next_wave` / :meth:`peek_wave`:
        returns ``(wave, deferring, anchor)`` without mutating anything."""
        capacity = max(0, int(capacity))
        anchor = self._anchor(capacity)
        if anchor is None:
            return [], False, None
        abucket = self.bucket_of(anchor)
        wave = self._gather(abucket, capacity)
        defer_allowed = (self.cost_model is not None
                         and self._deferred is None)
        deferring = False
        if defer_allowed:
            alt = self._plan_deferral(anchor, abucket, wave, capacity)
            if alt is not None:
                wave, deferring = alt, True
        if budget_us is not None and self.cost_model is not None:
            wave = self._fit_budget(wave, budget_us, shrink_floor,
                                    free_slots=free_slots)
        return wave, deferring, anchor

    def _wave_cost(self, wave: List[WaveItem], bucket: int,
                   free_slots: Optional[int]) -> float:
        """Predicted cost of popping ``wave`` now: the prefill wave itself
        plus — on a paged engine — the demote page wave its over-free-slot
        fresh rows force (``c_page`` of the overflow; 0 when everything
        fits the free slots)."""
        cost = self.cost_model.predict_us(len(wave), bucket)
        if free_slots is not None:
            overflow = sum(it.first for it in wave) - max(0, int(free_slots))
            cost += self.cost_model.predict_page_us(overflow)
        return cost

    def _fit_budget(self, wave: List[WaveItem], budget_us: float,
                    shrink_floor: float,
                    free_slots: Optional[int] = None) -> List[WaveItem]:
        """Shrink ``wave`` until its predicted cost fits ``budget_us``, or
        defer it entirely.  Rows drop youngest-first (the list is
        queue-ordered, so the oldest — the anchor, when this is the anchor's
        wave — is trimmed last); dropped rows simply stay queued.  Returns
        [] when no row fits, or when the surviving wave would keep less than
        ``shrink_floor`` of the full wave's predicted tok/s (the
        alpha-dominated regime, where a part-wave pays almost the whole
        dispatch cost — the caller decodes now and retries on a fresh
        budget, waiving the floor there if SLO compliance is at stake).
        Cost includes the forced page wave when ``free_slots`` is given —
        shrinking sheds fresh rows, so it shrinks the page wave too."""
        if not wave:
            return wave
        # Max over the rows, not wave[0]: a padded-up remainder chunk rides
        # a wave whose bucket is set by its longest row.
        bucket = max(bucket_length(it.length, bucket_min=self.bucket_min)
                     for it in wave)
        full_tokens = sum(it.length for it in wave)
        full_cost = self._wave_cost(wave, bucket, free_slots)
        if full_cost <= budget_us:
            return wave
        shrunk = wave
        while shrunk and self._wave_cost(shrunk, bucket,
                                         free_slots) > budget_us:
            shrunk = shrunk[:-1]
        if not shrunk:
            return []
        tokens = sum(it.length for it in shrunk)
        cost = self._wave_cost(shrunk, bucket, free_slots)
        if tokens * full_cost < shrink_floor * full_tokens * cost:
            return []
        return shrunk

    def _pop(self, items: List[WaveItem]) -> List[WaveItem]:
        """Commit a gathered wave: finished requests leave the queue; a
        request with chunks remaining advances its cursor and re-enters at
        the tail (chunk round-robin — other buckets' waves interleave)."""
        done_sids = set()
        requeue: List[PrefillRequest] = []
        for it in items:
            if it.last:
                done_sids.add(it.sid)
                self._sids.discard(it.sid)
            else:
                it.req.done = it.stop
                requeue.append(it.req)
        if done_sids or requeue:
            drop = set(done_sids)
            drop.update(r.sid for r in requeue)
            self._queue = [r for r in self._queue if r.sid not in drop]
            self._queue.extend(requeue)
        return items

    # ----------------------------------------------------- decode deadlines
    def track_decode(self, sid: Hashable, slo_us: float) -> None:
        """Register (or re-SLO) a decoding session.  A fresh entry inherits
        the globally-accrued charge/stamp, so tracking a sid mid-serve does
        not grant it a free budget reset.  Per-session SLOs are what make
        serve tiers real: a premium sid with a tight ``slo_us`` comes due —
        and decodes — ahead of relaxed ones (see :meth:`due_decode_sids`)."""
        if slo_us is None or slo_us <= 0:
            raise ValueError(f"decode SLO for {sid!r} must be positive, "
                             f"got {slo_us}")
        ent = self._decode.get(sid)
        if ent is None:
            self._decode[sid] = [float(slo_us), self._decode_charge,
                                 self._decode_stamp]
        else:
            ent[0] = float(slo_us)

    def untrack_decode(self, sid: Hashable) -> None:
        self._decode.pop(sid, None)

    def decode_slo_of(self, sid: Hashable) -> Optional[float]:
        ent = self._decode.get(sid)
        return None if ent is None else ent[0]

    @property
    def tracked_decoders(self) -> List[Hashable]:
        return list(self._decode)

    def charge_decode_cost(self, us: float) -> None:
        """Charge non-decode wave cost (prefill / page / refit, predicted or
        measured) against every tracked session's budget."""
        self._decode_charge += us
        for ent in self._decode.values():
            ent[1] += us

    def note_decoded(self, sids, wall: Optional[float] = None) -> None:
        """A decode wave just produced tokens for ``sids``: their charge
        and wall stamp reset — and so do the globals (the engine-wide
        "cost since the last decode" clock restarts on any decode)."""
        wall = time.perf_counter() if wall is None else wall
        self._decode_charge = 0.0
        self._decode_stamp = wall
        for sid in sids:
            ent = self._decode.get(sid)
            if ent is not None:
                ent[1] = 0.0
                ent[2] = wall

    def _decode_budgets(self, reserve_us: float, among=None
                        ) -> List[Tuple[float, Hashable]]:
        now = time.perf_counter()
        out = []
        sel = None if among is None else set(among)
        for sid, (slo, charged, stamp) in self._decode.items():
            if sel is not None and sid not in sel:
                continue
            elapsed = max(charged, (now - stamp) * 1e6)
            out.append((slo - elapsed - reserve_us, sid))
        return out

    def decode_budget(self, reserve_us: float = 0.0,
                      among=None) -> Optional[float]:
        """Remaining decode latency budget in microseconds: the *tightest*
        tracked session's ``slo - consumed - reserve`` (``reserve_us``: the
        upcoming decode wave's own predicted cost — the gap the SLO bounds
        ends when tokens exist, not when the wave starts).  ``among``
        restricts to a subset (a flush's protected decoders).  None when no
        session is tracked."""
        b = self._decode_budgets(reserve_us, among)
        return min(v for v, _ in b) if b else None

    def due_decode_sids(self, reserve_us: float = 0.0,
                        among=None) -> List[Hashable]:
        """The sessions the next decode wave should serve, most urgent
        first: every tracked sid whose remaining budget is spent (<= 0),
        or — when the planner preempts early, before anyone is overdue —
        the sids tied (~1us) with the tightest budget.  Uniform SLOs tie
        everything, so the wave serves all tracked decoders exactly as the
        engine-wide clock did; mixed SLOs are where premium sessions
        decode first while relaxed ones keep waiting."""
        b = self._decode_budgets(reserve_us, among)
        if not b:
            return []
        b.sort(key=lambda e: e[0])
        due = [sid for v, sid in b if v <= 0.0]
        if due:
            return due
        floor = b[0][0]
        return [sid for v, sid in b if v <= floor + 1.0]

    # ------------------------------------------------------------- lookahead
    def _score(self, waves: List[Tuple[int, List[WaveItem]]]) -> float:
        """Predicted true-tokens-per-microsecond over a plan's waves."""
        tokens = sum(it.length for _, w in waves for it in w)
        us = sum(self.cost_model.predict_us(len(w), b)
                 for b, w in waves if w)
        return tokens / max(us, 1.0)

    def _best_follower(self, capacity: int, skip) -> Tuple[int,
                                                           List[WaveItem]]:
        """Highest-predicted-throughput wave among the remaining buckets."""
        best, best_tps = (0, []), -1.0
        seen = set()
        for r in self._queue:
            if r.sid in skip:
                continue
            b = self.bucket_of(r)
            if b in seen:
                continue
            seen.add(b)
            w = self._gather(b, capacity, skip=skip)
            if not w:
                continue
            tps = self._score([(b, w)])
            if tps > best_tps:
                best, best_tps = (b, w), tps
        return best

    def _plan_deferral(self, anchor: PrefillRequest, abucket: int,
                       anchor_wave: List[WaveItem], capacity: int
                       ) -> Optional[List[WaveItem]]:
        """Two-wave lookahead: should another bucket's wave run *before* the
        anchor's?  Deferral changes the plan's composition only through the
        free-slot budget (the deferring wave may admit more rows than the
        leftover capacity after the anchor wave would have allowed) — when
        both orders compose identically the scores tie and fairness wins.

        Returns the deferring wave, or None to serve the anchor first.  When
        the anchor is a fresh admission one slot is reserved for it, so the
        committed follow-up wave can always run.
        """
        anchor_sids = {it.sid for it in anchor_wave}
        cap_after_a = capacity - sum(it.first for it in anchor_wave)
        plan_a = [(abucket, anchor_wave),
                  self._best_follower(cap_after_a, anchor_sids)]
        best_alt, best_score = None, self._score(plan_a) * _DEFER_MARGIN
        reserve = 1 if anchor.done == 0 else 0
        seen = set()
        for r in self._queue:
            b = self.bucket_of(r)
            if b == abucket or b in seen:
                continue
            seen.add(b)
            w1 = self._gather(b, capacity - reserve)
            if not w1:
                continue
            skip = {it.sid for it in w1}
            cap_left = capacity - sum(it.first for it in w1)
            w2 = self._gather(abucket, cap_left, skip=skip)
            if anchor.sid not in {it.sid for it in w2}:
                continue             # the commitment must be honorable
            score = self._score([(b, w1), (abucket, w2)])
            if score > best_score:
                best_alt, best_score = w1, score
        return best_alt
