"""The reservoir serving stack of the port — the JAX package's ``serve``
namespace, name for name.

``arena`` (the slot arena and its prefill / decode functions),
``scheduler`` (bucketed admission waves), ``cost`` (the wave cost model),
``engine`` (``ReservoirEngine``, the facade over the ``telemetry``,
``ingest``, ``exec_plane`` and ``learn`` planes), ``store`` (the tiered
session store and snapshots) and ``frontend`` (``OpenLoopServer``, the
asyncio open-loop front end: per-token streaming, ``AdmissionFull``
backpressure, graceful drain).  ``resolve_method`` / ``run_scan_q`` are
re-exported from ``core.dispatch``.
"""
from . import (arena, cost, engine, exec_plane, frontend, ingest, learn,
               scheduler, store, telemetry)
from ..core.dispatch import resolve_method, run_scan_q
from .arena import SlotArena
from .cost import WaveCostModel, cost_key
from .engine import (DecodeResult, EngineStats, EvictResult, ReservoirEngine,
                     SessionStats)
from .frontend import OpenLoopServer, SessionHandle, StreamToken
from .ingest import AdmissionFull
from .scheduler import PrefillRequest, WaveItem, WaveScheduler, bucket_length
from .store import HostPool, SessionStore
from .telemetry import (JsonlTracker, MultiTracker, NullTracker,
                        ProfilerTracker, StatsAggregator, Tracker,
                        make_tracker)

__all__ = ["arena", "cost", "engine", "exec_plane", "frontend", "ingest",
           "learn", "scheduler", "store", "telemetry",
           "OpenLoopServer", "SessionHandle", "StreamToken",
           "SlotArena", "WaveCostModel", "cost_key",
           "resolve_method", "run_scan_q",
           "DecodeResult", "EngineStats", "EvictResult", "ReservoirEngine",
           "SessionStats", "AdmissionFull",
           "Tracker", "NullTracker", "JsonlTracker", "ProfilerTracker",
           "MultiTracker", "StatsAggregator", "make_tracker",
           "PrefillRequest", "WaveItem", "WaveScheduler", "bucket_length",
           "HostPool", "SessionStore"]
