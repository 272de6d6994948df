"""Observability plane — the bottom of the serving-plane stack.

Every wave / decode event the other planes produce flows through ONE seam: a
:class:`Tracker` with three methods — ``log_wave(event)`` (a flat dict
tagged by ``kind``), ``log_stats(stats)`` (an :class:`EngineStats` or plain
dict snapshot), and ``capture(name)`` (a context manager wrapping a profiled
region).  The engine's serving counters are derived by
:class:`StatsAggregator`, itself just another Tracker fed from the same
event stream — so a JSONL trace and the ``stats()`` counters can never
disagree about what happened.

This module imports nothing from the rest of ``serve``, and torch only
inside a profiler window.

Trackers:

* :class:`NullTracker`   — the default; every hook is a no-op.
* :class:`JsonlTracker`  — appends one JSON object per event/stats call.
* :class:`ProfilerTracker` — ``capture(name)`` opens a ``torch.profiler``
  window (with CUDA activity for an engine on the card) and writes its
  Chrome trace under ``profile_dir``.
* :class:`MultiTracker`  — fan-out to several trackers.
* :func:`make_tracker`   — CLI spec parser (``"null"``, ``"jsonl:PATH"``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import time
from typing import Dict, Hashable, List, Optional

import numpy as np

__all__ = ["Tracker", "NullTracker", "JsonlTracker", "ProfilerTracker",
           "MultiTracker", "StatsAggregator", "EngineStats", "make_tracker"]


class Tracker:
    """The pluggable observability protocol.  Subclass and override any of
    the three hooks; the base class is a valid no-op tracker."""

    def log_wave(self, event: dict) -> None:
        """One serving event — a flat dict carrying ``kind`` (``prefill`` /
        ``decode`` / ``page`` / ``refit`` / ``growth`` / ``pipeline`` /
        ``host_block`` / ``overlap_demote`` / ``admit`` / ``release`` /
        ``frontend``...) plus kind-specific fields."""

    def log_stats(self, stats) -> None:
        """A periodic engine ``stats()`` snapshot (EngineStats or dict)."""

    def capture(self, name: str):
        """Context manager around a region worth profiling.  The base
        implementation is a no-op window."""
        return contextlib.nullcontext()

    def close(self) -> None:
        """Flush and release any underlying sink."""


class NullTracker(Tracker):
    """Explicitly-named no-op tracker (the engine default)."""


def _jsonable(obj):
    if isinstance(obj, EngineStats):
        return obj.to_dict()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    return obj


def _default(obj):
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (set, frozenset)):
        return sorted(map(str, obj))
    return str(obj)


class JsonlTracker(Tracker):
    """Append-only JSON-lines sink: one object per ``log_wave`` /
    ``log_stats`` call, each stamped with a wall-clock ``t`` — the trace
    artifact CI benches attach to perf regressions."""

    def __init__(self, path: str):
        self.path = str(path)
        self._fh = open(self.path, "a", encoding="utf-8")

    def _emit(self, obj: dict) -> None:
        self._fh.write(json.dumps(obj, default=_default) + "\n")

    def log_wave(self, event: dict) -> None:
        self._emit({"t": time.time(), "type": "wave", **event})

    def log_stats(self, stats) -> None:
        self._emit({"t": time.time(), "type": "stats",
                    "stats": _jsonable(stats)})

    def capture(self, name: str):
        self._emit({"t": time.time(), "type": "capture", "name": name})
        return contextlib.nullcontext()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()


class ProfilerTracker(Tracker):
    """``capture(name)`` wraps the region in a ``torch.profiler`` window and
    writes its Chrome trace to ``profile_dir/<name>.<i>.pt.trace.json`` (the
    ``i``-th window of that name) — so a regression report can carry a
    device trace, not just a number.  ``cuda``: record the card's kernels
    too (the engine passes whether it runs on one).  Event/stats hooks are
    no-ops (pair with a :class:`JsonlTracker` through
    :class:`MultiTracker`)."""

    def __init__(self, profile_dir: str, *, cuda: bool = False):
        self.profile_dir = str(profile_dir)
        self.cuda = bool(cuda)
        self.traces: List[str] = []

    @contextlib.contextmanager
    def _window(self, name: str):
        import os

        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.profile_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            with record_function(name):
                yield
            if self.cuda:
                torch.cuda.synchronize()
        path = os.path.join(self.profile_dir,
                            f"{name}.{len(self.traces)}.pt.trace.json")
        prof.export_chrome_trace(path)
        self.traces.append(path)

    def capture(self, name: str):
        return self._window(name)


class MultiTracker(Tracker):
    """Fan one event stream out to several trackers (e.g. the engine's
    :class:`StatsAggregator` plus a user JSONL sink)."""

    def __init__(self, trackers):
        self.trackers: List[Tracker] = list(trackers)

    def log_wave(self, event: dict) -> None:
        for t in self.trackers:
            t.log_wave(event)

    def log_stats(self, stats) -> None:
        for t in self.trackers:
            t.log_stats(stats)

    def capture(self, name: str):
        with contextlib.ExitStack() as stack:
            for t in self.trackers:
                stack.enter_context(t.capture(name))
            detached = stack.pop_all()
        return detached

    def close(self) -> None:
        for t in self.trackers:
            t.close()


def make_tracker(spec: Optional[str] = None,
                 profile_dir: Optional[str] = None, *,
                 cuda: bool = False) -> Tracker:
    """Build a tracker from a CLI spec: ``None``/``"null"`` -> no-op,
    ``"jsonl:PATH"`` -> :class:`JsonlTracker`.  ``profile_dir`` adds a
    :class:`ProfilerTracker` capture window on top (MultiTracker); ``cuda``
    is passed to it."""
    trackers: List[Tracker] = []
    if spec and spec != "null":
        if spec.startswith("jsonl:"):
            trackers.append(JsonlTracker(spec[len("jsonl:"):]))
        else:
            raise ValueError(f"unknown tracker spec {spec!r} — expected "
                             f"'null' or 'jsonl:PATH'")
    if profile_dir:
        trackers.append(ProfilerTracker(profile_dir, cuda=cuda))
    if not trackers:
        return NullTracker()
    return trackers[0] if len(trackers) == 1 else MultiTracker(trackers)


class StatsAggregator(Tracker):
    """Derives the engine's cumulative serving counters from the event
    stream — the ONE place raw events become ``stats()`` numbers.  Owns the
    bounded histories too: the last-256-waves log, the inter-token decode
    gap window, and the promote-latency window (p95 sources)."""

    def __init__(self):
        self.c: Dict[str, float] = {
            "waves": 0, "rows": 0, "fresh_rows": 0,
            "prefill_tokens": 0, "decode_tokens": 0,
            "occupancy_sum": 0.0,
            "wave_us_sum": 0.0, "timed_waves": 0,
            "decode_waves": 0, "decode_rows": 0,
            "decode_interleave_waves": 0,
            "decode_waves_by_route": {"fused": 0, "step": 0},
            "decode_us_sum": 0.0, "decode_timed_steps": 0,
            "page_waves": 0, "page_rows": 0, "page_us_sum": 0.0,
            "promote_waves": 0, "demote_waves": 0,
            "inflight_peak": 0, "host_block_us": 0.0,
            "overlap_demotes": 0,
            "refit_waves": 0, "refit_rows": 0,
            "refit_us_sum": 0.0, "growth_events": 0,
            "by_bucket": {}}
        self.wave_log: collections.deque = collections.deque(maxlen=256)
        self.decode_gaps_us: collections.deque = collections.deque(
            maxlen=4096)
        self.promote_us: collections.deque = collections.deque(maxlen=4096)
        self._last_decode_wall: Dict[Hashable, float] = {}

    # ------------------------------------------------------------- ingest
    def log_wave(self, event: dict) -> None:
        kind = event.get("kind")
        handler = getattr(self, f"_on_{kind}", None)
        if handler is not None:
            handler(event)

    def _on_prefill(self, e: dict) -> None:
        s = self.c
        rows, us = e["rows"], e.get("us")
        s["waves"] += 1
        s["rows"] += rows
        s["fresh_rows"] += e["fresh"]
        s["prefill_tokens"] += e["tokens"]
        s["occupancy_sum"] += e["occupancy"]
        by = s["by_bucket"].setdefault(
            e["t_bucket"], {"waves": 0, "rows": 0, "tokens": 0,
                            "us_sum": 0.0, "timed_waves": 0})
        by["waves"] += 1
        by["rows"] += rows
        by["tokens"] += e["tokens"]
        if us is not None:
            s["wave_us_sum"] += us
            s["timed_waves"] += 1
            by["us_sum"] += us
            by["timed_waves"] += 1
        self.wave_log.append({"t_bucket": e["t_bucket"], "rows": rows,
                              "fresh": e["fresh"],
                              "capacity": e["capacity"],
                              "tokens": e["tokens"], "us": us})

    def _on_decode(self, e: dict) -> None:
        s = self.c
        wall = e.get("wall", time.perf_counter())
        for sid in e.get("sids", ()):
            prev = self._last_decode_wall.get(sid)
            if prev is not None:
                self.decode_gaps_us.append((wall - prev) * 1e6)
            self._last_decode_wall[sid] = wall
        s["decode_waves"] += 1
        s["decode_rows"] += e["rows"]
        s["decode_tokens"] += e["rows"] * e["tokens"]
        if e.get("mode") == "interleave":
            s["decode_interleave_waves"] += 1
        s["decode_waves_by_route"][e["route"]] += 1
        us = e.get("us")
        if us is not None:
            s["decode_us_sum"] += us
            s["decode_timed_steps"] += e["tokens"]

    def _on_page(self, e: dict) -> None:
        s = self.c
        s["page_waves"] += 1
        s["page_rows"] += e["rows"]
        s["page_us_sum"] += e["us"]
        if e["promote"]:
            s["promote_waves"] += 1
            self.promote_us.append(e["us"])
        else:
            s["demote_waves"] += 1

    def _on_refit(self, e: dict) -> None:
        s = self.c
        s["refit_waves"] += 1
        s["refit_rows"] += e["rows"]
        s["refit_us_sum"] += e["us"]

    def _on_growth(self, e: dict) -> None:
        self.c["growth_events"] += 1

    def _on_pipeline(self, e: dict) -> None:
        self.c["inflight_peak"] = max(self.c["inflight_peak"],
                                      e["inflight"])

    def _on_host_block(self, e: dict) -> None:
        self.c["host_block_us"] += e["us"]

    def _on_overlap_demote(self, e: dict) -> None:
        self.c["overlap_demotes"] += 1

    def _on_release(self, e: dict) -> None:
        self._last_decode_wall.pop(e.get("sid"), None)

    def _on_reset(self, e: dict) -> None:
        # reset() keeps cumulative counters; only per-session wall stamps
        # become meaningless (the sessions are gone).
        self._last_decode_wall.clear()

    # ------------------------------------------------------------ queries
    def clear_gaps(self) -> None:
        self.decode_gaps_us.clear()

    def snapshot(self) -> dict:
        """The counter-derived slice of :class:`EngineStats` (the facade
        merges in the per-plane occupancy/queue/store/learn snapshots)."""
        s = self.c
        waves = s["waves"]
        gaps = (np.asarray(self.decode_gaps_us, float)
                if self.decode_gaps_us else None)
        promote = (np.asarray(self.promote_us, float)
                   if self.promote_us else None)
        return {
            "page_waves_total": s["page_waves"],
            "page_rows_total": s["page_rows"],
            "promote_waves": s["promote_waves"],
            "demote_waves": s["demote_waves"],
            "page_us_sum": s["page_us_sum"],
            "promote_us_p95": (None if promote is None
                               else float(np.percentile(promote, 95))),
            "waves_total": waves,
            "rows_total": s["rows"],
            "fresh_rows_total": s["fresh_rows"],
            "prefill_tokens": s["prefill_tokens"],
            "decode_tokens": s["decode_tokens"],
            "occupancy_mean": (s["occupancy_sum"] / waves) if waves
                              else None,
            "wave_us_mean": (s["wave_us_sum"] / s["timed_waves"]
                             if s["timed_waves"] else None),
            "decode_waves_total": s["decode_waves"],
            "decode_rows_total": s["decode_rows"],
            "decode_interleave_waves": s["decode_interleave_waves"],
            "decode_waves_by_route": dict(s["decode_waves_by_route"]),
            "decode_us_per_step": (s["decode_us_sum"]
                                   / s["decode_timed_steps"]
                                   if s["decode_timed_steps"] else None),
            "decode_gaps": 0 if gaps is None else int(gaps.size),
            "decode_gap_p50_us": (None if gaps is None
                                  else float(np.percentile(gaps, 50))),
            "decode_gap_p95_us": (None if gaps is None
                                  else float(np.percentile(gaps, 95))),
            "pipeline_inflight_peak": s["inflight_peak"],
            "host_block_us": s["host_block_us"],
            "overlap_demotes": s["overlap_demotes"],
            "refit_waves_total": s["refit_waves"],
            "refit_rows_total": s["refit_rows"],
            "refit_us_sum": s["refit_us_sum"],
            "growth_events": s["growth_events"],
            "by_bucket": {t: dict(v) for t, v in s["by_bucket"].items()},
            "wave_log": list(self.wave_log),
        }


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Typed ``ReservoirEngine.stats()`` result — every serving counter as
    a named field (waves / rows / occupancy / latency / by-bucket / decode
    / page / pipeline / refit), frozen so a report can never mutate the
    engine's accounting.  ``to_dict()`` is the sanctioned dict conversion.

    Dict-key access (``stats()["waves_total"]``), deprecated for one
    release, is now REMOVED — read fields directly or call ``to_dict()``
    once (see the README migration table)."""
    sessions_active: int
    sessions_ready: int
    sessions_queued: int
    sessions_parked: int
    store: Optional[dict]
    page_waves_total: int
    page_rows_total: int
    promote_waves: int
    demote_waves: int
    page_us_sum: float
    promote_us_p95: Optional[float]
    chunks_in_flight: int
    waves_total: int
    rows_total: int
    fresh_rows_total: int
    prefill_tokens: int
    decode_tokens: int
    occupancy_mean: Optional[float]
    wave_us_mean: Optional[float]
    decode_waves_total: int
    decode_rows_total: int
    decode_interleave_waves: int
    decode_waves_by_route: dict
    decode_us_per_step: Optional[float]
    decode_gaps: int
    decode_gap_p50_us: Optional[float]
    decode_gap_p95_us: Optional[float]
    pipeline_depth: int
    pipeline_inflight: int
    pipeline_inflight_peak: int
    host_block_us: float
    overlap_demotes: int
    refit_waves_total: int
    refit_rows_total: int
    refit_us_sum: float
    sessions_dirty: int
    growth_events: int
    by_bucket: dict
    wave_log: list
    wave_costs: list

    def to_dict(self) -> dict:
        """Shallow dict of every field (the old ``stats()`` return shape)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}
