"""Exec (data) plane — wave dispatch against the slot arena, the bounded
in-flight window, and closed-loop / single-step decode.

Everything that touches the device lives here: the prefill / decode /
place / release calls into ``serve.arena``, the decode output buffers, and
the flush drain loop that turns the scheduler's planned waves into
launches.  PyTorch runs these eagerly; a wave's launches are queued on the
device's current stream and the host goes on planning.  The in-flight
window bounds how far it runs ahead: each wave records a CUDA event, and the
host waits on the oldest event once more than ``pipeline_depth`` waves are
outstanding (``pipeline_depth=0`` waits after every wave — the synchronous
reference).  On the CPU every launch has finished when it returns, so the
waits are no-ops.

Control-plane state (session table, admission queue) reaches this plane
through the facade-wired ``table`` and ``scheduler``; learn-plane effects
are callbacks with no-op defaults.  Paging, learning, cost-model autotune
and decode-SLO interleave are not ported yet.
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
from .ingest import SessionStats
from .scheduler import WaveItem, bucket_length

__all__ = ["ExecPlane", "DecodeResult", "EvictResult"]


@dataclasses.dataclass(frozen=True)
class DecodeResult:
    """What :meth:`ReservoirEngine.collect_decoded` returns.

    ``tokens``: sid -> (n_tokens, D_out) tensor; ``waves``: per-launch
    metadata dicts (``kind`` "step" / "closed_loop", ``rows``, ``tokens``
    per row, ``us``, ``fused`` whether the K-token fused kernel path ran)
    for the launches whose tokens this result drained.  Mapping-shaped on
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


class ExecPlane:
    """Owns the arena and every device launch.  ``table`` (the ingest
    plane's session table) and ``scheduler`` are facade-wired references;
    the ``tracker`` receives every wave / decode / pipeline event."""

    def __init__(self, params, readout, cfg, dtype, *, max_slots: int,
                 pipeline_depth: int, tracker, table, scheduler):
        self.params = params
        self.readout = readout
        self.cfg = cfg
        self._dtype = dtype
        self._np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self.device = params.device
        self.max_slots = int(max_slots)
        self.pipeline_depth = int(pipeline_depth)
        self.tracker = tracker
        self.table = table
        self.scheduler = scheduler
        self.arena = self._fresh_arena()
        self._chunk_outs: Dict[Hashable, List] = {}
        self._decode_buf: Dict[Hashable, List] = {}
        self._decode_meta: List[dict] = []
        # Events of the launched-but-unwaited waves, oldest first.
        self._inflight: collections.deque = collections.deque()
        # ---- facade-wired cross-plane callbacks (learn plane) ------------
        self.note_admission = lambda sid, tenant: None
        self.on_prompt_done = lambda sid, y_last: None
        self.note_freerun = lambda sids, n: None
        self.note_steps = lambda sids: None
        self.pop_learn = lambda sid: None

    def _fresh_arena(self) -> arena_mod.SlotArena:
        return arena_mod.make_arena(self.cfg.n, self.cfg.d_out,
                                    self.max_slots, self._dtype, self.device)

    def _tensor(self, v, dtype=None):
        return torch.as_tensor(v, dtype=dtype, device=self.device)

    @property
    def w_out(self):
        return None if self.readout is None else self.readout.w_out

    # ---------------------------------------------------- pipelined executor
    def _inflight_admit(self) -> None:
        """Admit the wave just launched into the in-flight window, then
        retire from the front until at most ``pipeline_depth`` remain."""
        self._inflight.append(_record_event(self.device))
        while len(self._inflight) > self.pipeline_depth:
            self._inflight_retire()
        self.tracker.log_wave({"kind": "pipeline",
                               "inflight": len(self._inflight)})

    def _inflight_retire(self) -> None:
        """Wait for the oldest in-flight wave; the wait is the host's
        pipeline-idle time."""
        marker = self._inflight.popleft()
        t0 = time.perf_counter()
        _wait(marker)
        self.tracker.log_wave({"kind": "host_block",
                               "us": (time.perf_counter() - t0) * 1e6})

    def _drain_inflight(self) -> None:
        while self._inflight:
            self._inflight_retire()

    # ------------------------------------------------------------------ flush
    def flush(self, *, method: str = "auto", chunk: int = 128,
              want_outputs: bool = False,
              max_waves: Optional[int] = None) -> Dict[Hashable, object]:
        """The drain loop behind ``ReservoirEngine.flush``: pop same-bucket
        waves from the scheduler and run each as one batched prefill."""
        results: Dict[Hashable, object] = {}
        waves_run = 0
        while max_waves is None or waves_run < max_waves:
            capacity = self.table.free_slots
            if not self.scheduler.has_runnable(capacity):
                break
            wave = self.scheduler.next_wave(capacity)
            if not wave:
                break
            waves_run += 1
            self._run_wave(wave, capacity, results, method=method,
                           chunk=chunk, want_outputs=want_outputs)
        return results

    def _run_wave(self, wave: List[WaveItem], capacity: int,
                  results: Dict[Hashable, object], *, method: str,
                  chunk: int, want_outputs: bool) -> None:
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
            self.arena = arena_mod.place_many(
                self.arena, self._tensor(slots), self._tensor(h0s),
                self._tensor(y0s))
        prompts = [it for it in wave if it.req.u is not None]
        if not prompts:
            self._record_wave(0, len(wave), len(fresh), capacity, 0)
            if fresh and self.pipeline_depth > 0:
                self._inflight_admit()
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
        wave_method = method
        if wave_method == "auto" and self.params.mode == "diag":
            wave_method = dispatch.resolve_method(t_bucket, device=self.device,
                                                  chunk=chunk)
        self.arena, out = arena_mod.prefill_wave(
            self.params, self.w_out, self.arena, self._tensor(slot_list),
            self._tensor(u_pad), self._tensor(lengths),
            None if yt_pad is None else self._tensor(yt_pad),
            method=wave_method, chunk=chunk, want_outputs=want_outputs)
        if self.pipeline_depth == 0:
            # Strict synchronous reference: every wave lands before the host
            # plans the next.
            tb0 = time.perf_counter()
            _wait(_record_event(self.device))
            self.tracker.log_wave({"kind": "host_block",
                                   "us": (time.perf_counter() - tb0) * 1e6})
        else:
            self._inflight_admit()
        self._record_wave(t_bucket, len(wave), len(fresh), capacity,
                          int(lengths.sum()))
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
                     capacity: int, tokens: int) -> None:
        self.tracker.log_wave({"kind": "prefill", "t_bucket": t_bucket,
                               "rows": rows, "fresh": fresh,
                               "capacity": capacity, "tokens": tokens,
                               "occupancy": rows / self.max_slots,
                               "us": None})

    # ------------------------------------------------------------- lifecycle
    def place(self, sid, slot: int, h0, y0) -> int:
        h0 = np.zeros(self.cfg.n, self._np_dtype) if h0 is None else h0
        y0 = np.zeros(self.cfg.d_out, self._np_dtype) if y0 is None else y0
        self.arena = arena_mod.place(self.arena, slot, h0, y0)
        self.table.slots[slot] = sid
        self.table.sessions[sid] = SessionStats(slot=slot)
        return slot

    def release(self, sid: Hashable, *, drop: bool = False):
        """The one session-release body (see the facade docstring)."""
        self.scheduler.untrack_decode(sid)
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
        for req in self.scheduler:
            if req.u is None:
                self.scheduler.cancel(req.sid)
                self.place(req.sid, st.slot, req.h0, req.y0)
                break
        return EvictResult(state, y, decoded)

    def reset(self) -> None:
        self._drain_inflight()
        self.arena = self._fresh_arena()
        self.table.clear()
        self._chunk_outs.clear()
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
        return self.arena.states[self._active(sid).slot].cpu().numpy()

    # ---------------------------------------------------------------- decode
    def _mask(self, slots) -> torch.Tensor:
        mask = np.zeros((self.max_slots,), bool)
        mask[list(slots)] = True
        return self._tensor(mask)

    def _note_decode(self, sids, *, tokens: int, kind: str) -> None:
        """Decode accounting shared by every decode path: ONE telemetry
        event and the per-launch metadata ``collect_decoded`` reports."""
        wall = time.perf_counter()
        fused = (kind != "step" and self.params.mode == "diag"
                 and self.readout is not None)
        self._decode_meta.append({"kind": kind, "rows": len(sids),
                                  "tokens": int(tokens), "us": None,
                                  "fused": fused, "_pending": set(sids)})
        self.tracker.log_wave({"kind": "decode", "wall": wall,
                               "sids": list(sids), "rows": len(sids),
                               "tokens": int(tokens), "us": None,
                               "mode": kind})
        self.scheduler.note_decoded(sids, wall=wall)

    def _after_decode(self, sids, *, tokens: int, kind: str) -> None:
        if self.pipeline_depth > 0:
            self._inflight_admit()
        if sids and tokens:
            self._note_decode(sids, tokens=tokens, kind=kind)

    def decode_step(self, inputs: Dict[Hashable, "np.ndarray"]):
        """One batched open-loop token for the sessions in ``inputs``
        (sid -> (d_in,) input).  Returns sid -> (d_out,) host output."""
        stats = {sid: self._active(sid) for sid in inputs}
        vecs = {sid: np.asarray(vec, self._np_dtype).reshape(self.cfg.d_in)
                for sid, vec in inputs.items()}
        u = np.zeros((self.max_slots, self.cfg.d_in), self._np_dtype)
        for sid, vec in vecs.items():
            st = stats[sid]
            u[st.slot] = vec
            st.tokens_decoded += 1
            st.last_use = self.table.tick()
        self.note_steps(list(vecs))
        slots = [stats[sid].slot for sid in vecs]
        self.arena, y = arena_mod.decode_step(
            self.params, self.w_out, self.arena, self._tensor(u),
            self._mask(slots))
        self._after_decode(list(vecs), tokens=1, kind="step")
        if self.readout is None:
            return {}
        y = y.cpu().numpy()
        out = {sid: y[stats[sid].slot] for sid in inputs}
        for sid, row in out.items():
            self._decode_buf.setdefault(sid, []).append(
                self._tensor(row)[None])
        return out

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
        stats = {sid: self._active(sid) for sid in targets}  # validate first
        for sid in targets:
            stats[sid].tokens_decoded += n_steps
            stats[sid].last_use = self.table.tick()
        slots = [stats[s].slot for s in targets]
        self.arena, ys = arena_mod.closed_loop_fused(
            self.params, self.w_out, self.arena, self._mask(slots),
            int(n_steps))
        self._after_decode(targets, tokens=n_steps, kind="closed_loop")
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
