"""Asyncio open-loop front end on the ingest seam (the JAX package's
``serve/frontend.py``).

``OpenLoopServer`` wraps a ``ReservoirEngine`` in an *open-loop* serving
process: requests arrive on the submitter's clock (not when the engine
happens to be free), admission is bounded
(:class:`~repro_torch.serve.ingest.AdmissionFull` is the backpressure
signal, surfaced to the caller instead of queueing unbounded latency), and
every decoded token streams to its consumer through a per-session
``asyncio.Queue`` the moment the serving loop drains it — per-token
streaming, with wall-clock stamps that TTFT / inter-token latencies are
read from.

Everything here is host-side orchestration over the facade's public
surface (``submit`` / ``queue_inputs`` / ``flush`` / ``collect_decoded`` /
``release``): the engine's calls do the device work, and the drained
tokens leave the loop as host numpy rows.  No imports from the serving
planes beyond the ingest exception type; stdlib and numpy only.

Typical use::

    server = OpenLoopServer(engine, decode_interleave=True)
    await server.start()
    handle = await server.submit("s0", prompt, n_decode=32)
    async for tok in handle:          # per-token streaming
        consume(tok.y)
    await server.drain()              # graceful: finish in-flight, stop
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Dict, Hashable, List, Optional

import numpy as np

from .ingest import AdmissionFull

__all__ = ["AdmissionFull", "OpenLoopServer", "StreamToken", "SessionHandle"]


@dataclasses.dataclass(frozen=True, slots=True)
class StreamToken:
    """One decoded token as it leaves the serving loop: ``y`` is the
    (D_out,) prediction as a host numpy array, ``index`` its position in
    the session's decode stream, ``t_wall`` the wall clock at drain time
    (the consumer-visible emission instant)."""
    index: int
    t_wall: float
    y: np.ndarray


class SessionHandle:
    """The consumer side of one streamed session: an async iterator of
    :class:`StreamToken` that ends when the session's decode quota is
    served (or the server drains it).  ``tokens()`` collects the rest."""

    def __init__(self, sid: Hashable, n_decode: int):
        self.sid = sid
        self.n_decode = int(n_decode)
        self.t_submit = time.perf_counter()
        self.t_admitted: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self.delivered = 0          # tokens routed into the stream so far
        self._queue: asyncio.Queue = asyncio.Queue()
        self._closed = False

    def __aiter__(self):
        return self

    async def __anext__(self) -> StreamToken:
        tok = await self._queue.get()
        if tok is None:
            raise StopAsyncIteration
        return tok

    async def tokens(self) -> List[StreamToken]:
        """Drain the stream to completion and return every token."""
        return [tok async for tok in self]

    # -- server side -------------------------------------------------------
    def _push(self, tok: StreamToken) -> None:
        if self.t_first is None:
            self.t_first = tok.t_wall
        self.delivered += 1
        self._queue.put_nowait(tok)

    def _close(self) -> None:
        if not self._closed:
            self._closed = True
            self.t_done = time.perf_counter()
            self._queue.put_nowait(None)


class OpenLoopServer:
    """Open-loop serving loop over one engine.

    ``decode_interleave=True`` routes decode through SLO-protected
    interleaved flushes (needs ``decode_slo_us`` engine-wide or per
    session); otherwise decode runs as explicit closed-loop waves after
    the prefill queue drains each cycle.  ``max_waves_per_cycle`` bounds
    prefill work per loop iteration so a deep admission queue cannot
    starve token drain (None: drain fully).  ``idle_sleep_s`` is the poll
    interval when nothing is runnable.

    Admission honors the engine's bounded queue: a ``submit`` racing a
    full queue raises :class:`AdmissionFull` to the caller — shed or
    retry there; the server never buffers unadmitted requests.
    """

    def __init__(self, engine, *, decode_interleave: bool = False,
                 max_waves_per_cycle: Optional[int] = None,
                 idle_sleep_s: float = 0.001):
        self.engine = engine
        self.decode_interleave = bool(decode_interleave)
        self.max_waves_per_cycle = max_waves_per_cycle
        self.idle_sleep_s = float(idle_sleep_s)
        self._sessions: Dict[Hashable, SessionHandle] = {}
        self._task: Optional[asyncio.Task] = None
        self._draining = False
        self._wake = asyncio.Event()

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("server already started")
        self._draining = False
        self._task = asyncio.get_running_loop().create_task(self._serve())

    async def drain(self) -> None:
        """Graceful shutdown: stop admitting, keep serving until every
        in-flight session has its full decode quota streamed, then stop
        the loop.  Consumers see their streams complete normally."""
        self._draining = True
        self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None

    async def abort(self) -> None:
        """Hard stop: cancel the loop and close every open stream (their
        iterators end early; partial tokens already pushed stay valid)."""
        self._draining = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        for h in self._sessions.values():
            h._close()
        self._sessions.clear()

    # ------------------------------------------------------------ admission
    async def submit(self, sid: Hashable, u=None, y_teacher=None, *,
                     h0=None, y0=None, tenant: Optional[Hashable] = None,
                     decode_slo_us: Optional[float] = None,
                     n_decode: int = 0) -> SessionHandle:
        """Admit one request (same contract as ``engine.submit`` plus
        ``n_decode``: how many tokens to free-run/drive after the prompt
        lands).  Raises :class:`AdmissionFull` when the bounded queue is at
        capacity and ``RuntimeError`` while draining.  Returns the
        :class:`SessionHandle` to stream tokens from."""
        if self._draining:
            raise RuntimeError("server is draining — not admitting")
        if sid in self._sessions:
            raise KeyError(f"session {sid!r} already streaming")
        handle = SessionHandle(sid, n_decode)
        # May raise AdmissionFull/ValueError — nothing registered yet.
        self.engine.submit(sid, u, y_teacher, h0=h0, y0=y0, tenant=tenant,
                           decode_slo_us=decode_slo_us)
        handle.t_admitted = time.perf_counter()
        self._sessions[sid] = handle
        self._wake.set()
        return handle

    def queue_inputs(self, sid: Hashable, u) -> int:
        """Buffer open-loop input rows for a streaming session (driven
        decode under the SLO — see ``engine.queue_inputs``)."""
        depth = self.engine.queue_inputs(sid, u)
        self._wake.set()
        return depth

    # ---------------------------------------------------------- serving loop
    def _want_decode(self) -> List[Hashable]:
        ready = set(self.engine.ready_sessions)
        return [sid for sid, h in self._sessions.items()
                if sid in ready and h.n_decode > h.delivered
                and not h._closed]

    def _settled(self, sid: Hashable) -> bool:
        # A session may only finish once its prompt fully landed —
        # releasing a queued/chunk-in-flight sid would cancel it.
        st = self.engine.sessions.get(sid)
        if st is not None:
            return not st.prefill_pending
        return not self.engine.scheduler.has(sid)   # parked counts

    def _route_tokens(self) -> int:
        """Drain the engine's decode buffers into the per-session streams
        (one host copy a session); close + release sessions that reached
        their quota."""
        drained = self.engine.collect_decoded()
        now = time.perf_counter()
        routed = 0
        for sid, arr in drained.tokens.items():
            h = self._sessions.get(sid)
            if h is None:
                continue
            for row in arr.detach().cpu().numpy():
                h._push(StreamToken(index=h.delivered, t_wall=now, y=row))
                routed += 1
        finished = [sid for sid, h in self._sessions.items()
                    if not h._closed and h.delivered >= h.n_decode
                    and self._settled(sid)]
        for sid in finished:
            h = self._sessions.pop(sid)
            h._close()
            self.engine.release(sid, drop=True)
            self.engine.tracker.log_wave({
                "kind": "frontend", "sid": sid, "tokens": h.n_decode,
                "ttft_s": (None if h.t_first is None
                           else h.t_first - h.t_submit),
                "e2e_s": h.t_done - h.t_submit})
        return routed

    def _cycle(self) -> bool:
        """One serving iteration; returns whether any work ran."""
        eng = self.engine
        worked = False
        if len(eng.scheduler) > 0:
            eng.flush(decode_interleave=self.decode_interleave,
                      max_waves=self.max_waves_per_cycle)
            worked = True
        want = self._want_decode()
        if want:
            # With interleave on and prefill still queued, the interleaved
            # flush above already decoded them.
            if not (self.decode_interleave and len(eng.scheduler) > 0):
                k = min(int(getattr(eng, "decode_wave_tokens", 1) or 1),
                        min(h.n_decode - h.delivered
                            for h in (self._sessions[s] for s in want)))
                driven = [s for s in want if eng._ingest.input_depth(s) > 0]
                free = [s for s in want if s not in driven]
                # Driven sessions advance through their queued open-loop
                # inputs; free ones free-run closed-loop.
                for s in driven:
                    rows = eng._ingest.pop_inputs(s, 1)
                    if rows:
                        eng.decode_step({s: rows[0]})
                if free:
                    eng.decode_closed_loop(max(1, k), sids=free)
            worked = True
        if self._route_tokens() > 0:
            worked = True
        return worked

    async def _serve(self) -> None:
        while True:
            worked = self._cycle()
            if self._draining and not self._sessions and \
                    len(self.engine.scheduler) == 0:
                return
            if worked:
                await asyncio.sleep(0)      # yield to submitters/consumers
            else:
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(),
                                           timeout=self.idle_sleep_s)
                except asyncio.TimeoutError:
                    pass
