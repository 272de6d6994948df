"""SessionStore — tiered session state: the arena is a cache, not the truth.

The paper's O(N) diagonal update makes per-session serving state tiny — one
``(N,)`` state vector plus the ``(D_out,)`` feedback output — so the binding
capacity limit of the serving stack is the ``max_slots`` device arena, not
compute.  This module splits **session** from **slot**: the ``SlotArena``
holds only the *hot* sessions, and everything else lives in two colder
tiers owned by :class:`SessionStore`:

* **host tier** — a preallocated pool of ``(state, y_prev)`` rows
  (:class:`HostPool`, plain numpy).  The exec plane moves whole waves: a
  demote gathers the victim slots' rows in one device-to-host copy per
  tensor, a promote scatters them back in one ``place_many``; on the card
  both copies go through the exec plane's one pinned staging buffer, so the
  pool itself stays pageable.
* **cold tier** — one ``.npz`` record per session (``state``, ``y_prev``)
  under ``cold_dir/epoch_NNNN/sNNNNNN.npz`` (fsspec URLs work when fsspec is
  importable, plain paths always).  When the host pool fills, its
  least-recently-used rows spill here; a restored engine bumps the epoch so
  new records never collide with the ones an old snapshot references.

The store owns the *parked*-session table (sid -> tier + location + the
engine's per-session accounting struct, carried untouched); the engine
owns the *hot* table.  The store is host-only: numpy arrays and file I/O.
The engine does every device transfer and hands it host arrays.

**Async I/O lane** (``io_workers``): host-to-cold spills and cold-to-host
prefetches run on a small thread pool with per-session futures.  Table
metadata (tier, path) changes synchronously; only the file bytes move in
the background, and a worker thread runs nothing but ``np.savez`` /
``np.load`` on host copies.  A caller blocks on a session's future only
when its data is needed (``fetch_many`` / ``peek`` / ``drain_io``).  Every
prefetch is tagged with the store epoch at submit time: a completion that
lands after the epoch moved on (an engine restore) is discarded and the
record re-read from the current table's path.  ``io_workers=0`` keeps every
file touch synchronous.

:func:`snapshot_engine` / :func:`restore_engine` serialize a whole engine
to one directory (``manifest.json`` + ``arrays.npz`` + ``cost.json`` + a
``_COMPLETE`` marker, written to ``<path>.tmp`` and renamed) in the layout
of the JAX package's snapshots, so a snapshot written by either package
restores in the other.  Cold records are referenced, not copied.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["HostPool", "ParkedSession", "SessionStore", "SNAPSHOT_VERSION",
           "snapshot_engine", "restore_engine"]

try:                                     # optional: URL-addressed cold tiers
    import fsspec as _fsspec
except ImportError:                      # pragma: no cover - env dependent
    _fsspec = None

#: Snapshot manifest schema version (the JAX package's; bump on incompatible
#: layout changes in both).
SNAPSHOT_VERSION = 1


def _is_url(path: str) -> bool:
    return "://" in str(path)


def _open(path: str, mode: str):
    if _fsspec is not None and _is_url(path):
        return _fsspec.open(path, mode).open()
    return open(path, mode)


def _makedirs(path: str) -> None:
    if _is_url(path):
        if _fsspec is not None:
            fs, p = _fsspec.core.url_to_fs(path)
            fs.makedirs(p, exist_ok=True)
        return
    os.makedirs(path, exist_ok=True)


def _sid_from_json(x):
    """Invert JSON's tuple -> list coercion: a list can never be a real sid
    (unhashable), so every list in a manifest is a tuple."""
    if isinstance(x, list):
        return tuple(_sid_from_json(v) for v in x)
    return x


class HostPool:
    """Preallocated host rows of parked ``(state, y_prev)`` pairs.

    Free-list allocation: rows are reused in place, never grown, so the
    footprint is fixed at construction (``rows * (N + D_out)`` elements)."""

    def __init__(self, rows: int, n: int, d_out: int, dtype):
        if rows < 1:
            raise ValueError(f"HostPool needs >= 1 row, got {rows}")
        self.states = np.zeros((rows, n), dtype)
        self.y_prev = np.zeros((rows, d_out), dtype)
        self._free: List[int] = list(range(rows - 1, -1, -1))

    @property
    def rows(self) -> int:
        return self.states.shape[0]

    @property
    def free(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("host pool exhausted")
        return self._free.pop()

    def release(self, row: int) -> None:
        self._free.append(row)


@dataclasses.dataclass
class ParkedSession:
    """One parked session: where its state lives and the engine's accounting
    struct (``serve.ingest.SessionStats``, carried opaquely — ``slot`` is -1
    while parked; ``last_use`` is the LRU key of the host-to-cold spill)."""
    stats: object
    tier: str                            # "host" | "cold"
    row: Optional[int] = None            # host pool row (tier == "host")
    path: Optional[str] = None           # npz record  (tier == "cold")


class SessionStore:
    """The parked-session table over the host and cold tiers.  All movement
    is wave-granular: :meth:`park_many` / :meth:`fetch_many` take K sessions
    at once and touch the pool with one fancy-index copy."""

    def __init__(self, n: int, d_out: int, dtype, *, host_rows: int,
                 cold_dir: Optional[str] = None, epoch: int = 0,
                 io_workers: int = 2, _executor=None):
        self.n = int(n)
        self.d_out = int(d_out)
        self.dtype = np.dtype(dtype)
        self.pool = HostPool(host_rows, n, d_out, self.dtype)
        self.cold_dir = cold_dir
        self.epoch = int(epoch)
        self._seq = 0                    # per-epoch cold record counter
        self.table: Dict[Hashable, ParkedSession] = {}
        # The executor is created lazily (most stores never spill).
        # ``_executor`` is a test seam: a manually stepped executor lets the
        # epoch-guard property drive completions in adversarial orders.
        self.io_workers = int(io_workers)
        self._io = _executor
        #: sid -> Future of an in-flight host-to-cold record write.
        self._spills: Dict[Hashable, Future] = {}
        #: sid -> (submit-time epoch, Future of a cold-to-host record read).
        self._prefetch: Dict[Hashable, Tuple[int, Future]] = {}

    # ------------------------------------------------------------ async I/O
    def _executor_or_none(self):
        if self._io is None and self.io_workers > 0:
            self._io = ThreadPoolExecutor(
                max_workers=self.io_workers,
                thread_name_prefix="session-store-io")
        return self._io

    def _write_record(self, path: str, state, y_prev) -> None:
        with _open(path, "wb") as f:
            np.savez(f, state=state, y_prev=y_prev)

    def _read_record(self, path: str) -> Tuple[np.ndarray, np.ndarray]:
        with _open(path, "rb") as f:
            with np.load(f) as rec:
                return rec["state"].copy(), rec["y_prev"].copy()

    def _wait_spill(self, sid: Hashable) -> None:
        """Resolve ``sid``'s in-flight spill write, if any: a write error
        surfaces here, at the first use of the data."""
        fut = self._spills.pop(sid, None)
        if fut is not None:
            fut.result()

    def prefetch_many(self, sids) -> int:
        """Start cold-to-host reads for the cold-tier sessions in ``sids``;
        returns how many were submitted.  Advisory: the data lands in
        per-session futures that :meth:`fetch_many` consumes, the table is
        never mutated, and a prefetch whose epoch goes stale is discarded
        unread.  No-op with ``io_workers=0``."""
        ex = self._executor_or_none()
        if ex is None:
            return 0
        n = 0
        for sid in sids:
            entry = self.table.get(sid)
            if (entry is None or entry.tier != "cold"
                    or sid in self._prefetch):
                continue
            spill = self._spills.get(sid)
            path = entry.path

            def task(path=path, spill=spill):
                if spill is not None:   # the record may still be written
                    spill.result()
                return self._read_record(path)

            self._prefetch[sid] = (self.epoch, ex.submit(task))
            n += 1
        return n

    def drain_io(self) -> None:
        """Block until every in-flight spill and prefetch has completed.
        Spill errors propagate; prefetch results stay buffered (fresh) or
        are dropped (stale epoch).  A snapshot calls this so every cold
        record its manifest references is on disk."""
        for sid in list(self._spills):
            self._wait_spill(sid)
        for sid, (epoch, fut) in list(self._prefetch.items()):
            fut.result()
            if epoch != self.epoch:
                self._prefetch.pop(sid, None)

    # ------------------------------------------------------------- queries
    def __contains__(self, sid: Hashable) -> bool:
        return sid in self.table

    def __len__(self) -> int:
        return len(self.table)

    @property
    def sids(self) -> List[Hashable]:
        return list(self.table)

    def tier_of(self, sid: Hashable) -> str:
        return self.table[sid].tier

    def stats(self) -> dict:
        host = sum(1 for e in self.table.values() if e.tier == "host")
        return {"parked": len(self.table), "host": host,
                "cold": len(self.table) - host,
                "host_rows": self.pool.rows,
                "host_rows_free": self.pool.free,
                "epoch": self.epoch,
                "io_spills_inflight": len(self._spills),
                "io_prefetch_inflight": len(self._prefetch)}

    # ------------------------------------------------------------- parking
    def park_many(self, sids, states, y_prevs, stats_list) -> None:
        """Park K demoted sessions into the host tier: ``states`` (K, N) and
        ``y_prevs`` (K, D_out) host arrays, ``stats_list`` the engine's
        per-session structs (kept verbatim).  When the pool is short, its
        LRU rows spill to the cold tier first — the incoming sessions were
        on the device a moment ago, so they are the hotter ones."""
        sids = list(sids)
        if not sids:
            return
        for sid in sids:
            if sid in self.table:
                raise KeyError(f"session {sid!r} already parked")
        short = len(sids) - self.pool.free
        if short > 0:
            self._spill(short)
        states = np.asarray(states, self.dtype)
        y_prevs = np.asarray(y_prevs, self.dtype)
        for i, (sid, st) in enumerate(zip(sids, stats_list)):
            row = self.pool.alloc()
            self.pool.states[row] = states[i]
            self.pool.y_prev[row] = y_prevs[i]
            self.table[sid] = ParkedSession(stats=st, tier="host", row=row)

    def _spill(self, k: int) -> None:
        """Move the K least-recently-used host-tier sessions to cold
        records.  Raises when there is no cold tier: a full pool with no
        backing store is a hard capacity limit, and state is never
        dropped."""
        host = [(getattr(e.stats, "last_use", 0), sid)
                for sid, e in self.table.items() if e.tier == "host"]
        if len(host) < k:
            raise RuntimeError(
                f"host pool needs {k} more row(s) but only {len(host)} "
                f"host-tier session(s) exist to spill — host_rows="
                f"{self.pool.rows} is too small for this demote wave")
        if self.cold_dir is None:
            raise RuntimeError(
                f"host pool full ({self.pool.rows} rows) and no cold_dir "
                f"configured — pass cold_dir= to spill LRU sessions to disk")
        host.sort()
        ex = self._executor_or_none()
        for _, sid in host[:k]:
            entry = self.table[sid]
            path = self._cold_path()
            if ex is not None:
                # Copy the row out (the pool row is reused the moment it is
                # released): the table flips to cold now, only the bytes are
                # in flight.
                state = self.pool.states[entry.row].copy()
                y_prev = self.pool.y_prev[entry.row].copy()
                self._spills[sid] = ex.submit(self._write_record, path,
                                              state, y_prev)
            else:
                self._write_record(path, self.pool.states[entry.row],
                                   self.pool.y_prev[entry.row])
            self.pool.release(entry.row)
            entry.tier, entry.row, entry.path = "cold", None, path

    def _cold_path(self) -> str:
        base = f"epoch_{self.epoch:04d}"
        sep = "/" if _is_url(self.cold_dir) else os.sep
        _makedirs(f"{self.cold_dir}{sep}{base}")
        path = f"{self.cold_dir}{sep}{base}{sep}s{self._seq:06d}.npz"
        self._seq += 1
        return path

    # ----------------------------------------------------------- restoring
    def fetch_many(self, sids) -> Tuple[np.ndarray, np.ndarray, list]:
        """Remove K parked sessions and return ``(states (K, N), y_prevs
        (K, D_out), stats_list)``.  Host rows are copied out and freed; cold
        records are read and left in place (records are append-only within
        an epoch and reclaimed with its directory)."""
        sids = list(sids)
        states = np.zeros((len(sids), self.n), self.dtype)
        y_prevs = np.zeros((len(sids), self.d_out), self.dtype)
        stats_list = []
        for i, sid in enumerate(sids):
            entry = self.table.pop(sid)
            if entry.tier == "host":
                states[i] = self.pool.states[entry.row]
                y_prevs[i] = self.pool.y_prev[entry.row]
                self.pool.release(entry.row)
            else:
                states[i], y_prevs[i] = self._read_cold(sid, entry)
            stats_list.append(entry.stats)
        return states, y_prevs, stats_list

    def _read_cold(self, sid: Hashable,
                   entry: ParkedSession) -> Tuple[np.ndarray, np.ndarray]:
        """One cold record, preferring a completed prefetch.  The epoch
        guard: a prefetch submitted under an older epoch is discarded
        unread, whatever its completion order, and the record re-read from
        the entry's current path."""
        pre = self._prefetch.pop(sid, None)
        if pre is not None:
            epoch, fut = pre
            if epoch == self.epoch:
                return fut.result()    # blocks only if still in flight
        self._wait_spill(sid)
        return self._read_record(entry.path)

    def peek(self, sid: Hashable) -> Tuple[np.ndarray, np.ndarray]:
        """A parked session's ``(state, y_prev)`` without promoting it."""
        entry = self.table[sid]
        if entry.tier == "host":
            return (self.pool.states[entry.row].copy(),
                    self.pool.y_prev[entry.row].copy())
        self._wait_spill(sid)
        return self._read_record(entry.path)

    def clear(self) -> None:
        """Drop every parked session (engine ``reset``).  Cold files stay on
        disk (epochs are reclaimed by deleting their directories); in-flight
        spill writes finish in the background; buffered prefetches are
        dropped."""
        for entry in self.table.values():
            if entry.tier == "host":
                self.pool.release(entry.row)
        self.table.clear()
        self._spills.clear()
        self._prefetch.clear()


# ====================================================================== #
#  Engine snapshot / restore                                             #
# ====================================================================== #

_PARAM_NAMES = {"DiagParams": ("lam_q", "win_q", "wfb_q", "qtq"),
                "StandardParams": ("w", "w_in", "w_fb")}
_PARAM_KIND = {"DiagParams": "diag", "StandardParams": "standard"}

#: The learn-plane knobs of the manifest: its key -> the engine attribute
#: (and the constructor argument of the same key) -> the JAX engine's
#: default, read when a snapshot predates the field.
_LEARN_KNOBS = {
    "learn": ("_learn", False), "refit_alpha": ("_refit_alpha", None),
    "refit_decay": ("_refit_decay", 1.0),
    "refit_washout": ("_refit_washout", 0),
    "drift_threshold": ("_drift_threshold", None),
    "drift_beta": ("_drift_beta", 0.9),
    "growth_max_members": ("_growth_max", 3),
    "growth_sigma": ("_growth_sigma", 0.1),
    "growth_washout": ("_growth_washout", 64)}


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _stats_rec(sid, st) -> dict:
    return {"sid": sid, "slot": st.slot, "tp": st.tokens_prefilled,
            "td": st.tokens_decoded, "pending": st.prefill_pending,
            "last_use": st.last_use}


def _stats_from_rec(rec):
    from .ingest import SessionStats
    return SessionStats(slot=rec["slot"], tokens_prefilled=rec["tp"],
                        tokens_decoded=rec["td"],
                        prefill_pending=rec["pending"],
                        last_use=rec["last_use"])


def snapshot_engine(engine, path: str) -> str:
    """Serialize a whole serving engine to the directory ``path``.

    Captures what a bit-exact resume needs: params and readout, the arena,
    the hot and parked session tables, the admission queue with its chunk
    cursors and parked ``(h0, y0)``, uncollected decode buffers and their
    wave metadata, the scheduler's committed deferral, and the cost model
    (``cost.json``).  Host-tier rows are embedded, cold records referenced
    by path.  The in-flight window is drained and the store's I/O lane
    settled first, so every tensor leaves through ``.cpu().numpy()`` and
    every referenced record is on disk.  The write is atomic: ``<path>.tmp``
    is renamed over ``path`` after the ``_COMPLETE`` marker lands.

    Learn state: the per-tenant readout pools and every session's folded
    ``(G, C)`` with its pairing counters, drift and last teacher row — the
    buffered rows are folded first, as in the JAX package, so the engine
    written from goes on from the same folded state.  Grown DPG members are
    not written (as in the JAX package): they are a drift response, and a
    restored engine grows them again on drift.  Returns ``path``."""
    ex = engine._exec
    ex._drain_inflight()
    manifest: dict = {"version": SNAPSHOT_VERSION}
    arrays: Dict[str, np.ndarray] = {}

    params = engine.params
    pcls = type(params).__name__
    present = []
    for name in _PARAM_NAMES[pcls]:
        v = getattr(params, name)
        if v is not None:
            present.append(name)
            arrays[f"params/{name}"] = _host(v)
    manifest["params"] = {"class": pcls, "arrays": present,
                          "cfg": dataclasses.asdict(engine.cfg),
                          "n_real": int(getattr(params, "n_real", 0))}
    manifest["dtype"] = str(np.dtype(ex._np_dtype))
    manifest["readout"] = engine.readout is not None
    if engine.readout is not None:
        arrays["readout/w_out"] = _host(engine.readout.w_out)

    sched = engine.scheduler
    manifest["engine"] = {
        "max_slots": engine.max_slots,
        "bucket_min": sched.bucket_min,
        "max_wave": sched.max_wave,
        "chunk_max": sched.chunk_max,
        "ensemble": engine.ensemble,
        "autotune": engine._autotune,
        "decode_slo_us": engine.decode_slo_us,
        # "auto" survives the round trip: the restored engine re-resolves K
        # per flush rather than freezing the last resolved value.
        "decode_wave_tokens": ("auto" if ex._decode_k_auto
                               else engine.decode_wave_tokens),
        "pipeline_depth": engine.pipeline_depth,
        "param_batch": engine._batched,
        "park_host_rows": engine._park_host_rows,
        "cold_dir": engine._cold_dir,
        **{k: getattr(engine, attr) for k, (attr, _) in _LEARN_KNOBS.items()},
    }
    manifest["use_clock"] = engine._table.use_clock
    ln = engine._learn_plane
    manifest["readout_pools"] = []
    for i, (key, w) in enumerate(ln.readouts.items()):
        manifest["readout_pools"].append({"key": key})
        arrays[f"pool{i}/w"] = _host(w)
    manifest["learn_state"] = []
    for i, (sid, ls) in enumerate(ln.state.items()):
        ln._fold_acc(ls.acc, ln._session_params(sid)
                     if sid in engine.sessions else engine.params)
        manifest["learn_state"].append({
            "sid": sid, "tenant": ls.tenant, "pairs": ls.acc.pairs,
            "skip_left": ls.acc.skip_left, "drift": ls.acc.drift,
            "steps_since_fb": ls.steps_since_fb, "dirty": ls.dirty,
            "gram": ls.acc.gram is not None,
            "last_fb": ls.last_fb is not None})
        if ls.acc.gram is not None:
            arrays[f"learn{i}/gram"] = _host(ls.acc.gram)
            arrays[f"learn{i}/cg"] = _host(ls.acc.cg)
        if ls.last_fb is not None:
            arrays[f"learn{i}/last_fb"] = _host(ls.last_fb)

    arrays["arena/states"] = _host(engine.arena.states)
    arrays["arena/y_prev"] = _host(engine.arena.y_prev)
    arrays["arena/active"] = _host(engine.arena.active)
    manifest["sessions"] = [_stats_rec(sid, st)
                            for sid, st in engine.sessions.items()]

    store = engine.store
    if store is not None:
        store.drain_io()
        parked, host_states, host_ys = [], [], []
        for sid, entry in store.table.items():
            rec = {"sid": sid, "tier": entry.tier,
                   "stats": _stats_rec(sid, entry.stats)}
            if entry.tier == "cold":
                rec["path"] = entry.path
            else:
                rec["hrow"] = len(host_states)
                host_states.append(store.pool.states[entry.row])
                host_ys.append(store.pool.y_prev[entry.row])
            parked.append(rec)
        arrays["park/states"] = (np.stack(host_states) if host_states else
                                 np.zeros((0, store.n), store.dtype))
        arrays["park/y_prev"] = (np.stack(host_ys) if host_ys else
                                 np.zeros((0, store.d_out), store.dtype))
        manifest["store"] = {"epoch": store.epoch, "seq": store._seq,
                             "parked": parked}

    queue = []
    for i, req in enumerate(sched._queue):
        rec = {"sid": req.sid, "done": req.done}
        for name in ("u", "y_teacher", "h0", "y0"):
            v = getattr(req, name)
            rec[name] = v is not None
            if v is not None:
                arrays[f"q{i}/{name}"] = _host(v)
        queue.append(rec)
    manifest["queue"] = queue
    manifest["deferred"] = sched._deferred

    for key, buf in (("decode_buf", ex._decode_buf),
                     ("chunk_outs", ex._chunk_outs)):
        prefix = "dec" if key == "decode_buf" else "chunk"
        manifest[key] = []
        for i, (sid, chunks) in enumerate(buf.items()):
            arrays[f"{prefix}{i}"] = _host(torch.cat(chunks))
            manifest[key].append({"sid": sid})
    manifest["decode_meta"] = [
        {"kind": m["kind"], "rows": m["rows"], "tokens": m["tokens"],
         "us": m["us"], "fused": m["fused"],
         "pending": sorted(m["_pending"], key=repr)}
        for m in ex._decode_meta]
    manifest["cost"] = None
    cm = engine.cost_model
    if cm is not None:
        manifest["cost"] = {
            "key": None if cm.key is None else list(cm.key),
            "base_us": cm.base_us, "per_token_us": cm.per_token_us,
            "decode_base_us": cm.decode_base_us,
            "decode_per_row_us": cm.decode_per_row_us,
            "page_base_us": cm.page_base_us,
            "page_per_row_us": cm.page_per_row_us,
        }

    tmp = str(path) + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    if cm is not None:
        cm.to_artifact(os.path.join(tmp, "cost.json"))
    with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
        f.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return str(path)


def restore_engine(cls, path: str, *, device=None, mesh=None):
    """Rebuild a serving engine on ``device`` from :func:`snapshot_engine`
    output (or the JAX package's, which has the same layout) and resume it
    bit-exactly: same params and readout, arena, hot / parked / queued
    sessions (chunk cursors and the committed deferral included), decode
    buffers, and a cost model re-seeded from ``cost.json``.  The store's
    epoch is bumped so new cold records never collide with the ones the
    snapshot references.  Learn state is restored first, then the readout
    pools (a hot session's pool key resolves through its restored tenant),
    which are re-scattered into the hot slots.  ``mesh`` re-places the
    arena on a (possibly different) device mesh: a snapshot holds whole
    arrays, never a shard layout, so any mesh restores any snapshot."""
    from ..core.params import params_from_numpy, readout_from_numpy
    from . import arena as arena_mod
    from .cost import WaveCostModel
    from .scheduler import PrefillRequest

    if not os.path.exists(os.path.join(path, "_COMPLETE")):
        raise FileNotFoundError(
            f"no complete engine snapshot at {path!r} (missing _COMPLETE — "
            f"interrupted write?)")
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    if m.get("version") != SNAPSHOT_VERSION:
        raise ValueError(f"snapshot version {m.get('version')!r} != "
                         f"{SNAPSHOT_VERSION} (incompatible layout)")
    ek = m["engine"]
    if mesh is not None and device is None:
        from ..launch.mesh import check_mesh
        device = check_mesh(mesh).home

    with np.load(os.path.join(path, "arrays.npz")) as npz:
        data = {k: npz[k] for k in npz.files}
    pm = m["params"]
    params = params_from_numpy(
        _PARAM_KIND[pm["class"]],
        {name: data.get(f"params/{name}") for name in pm["arrays"]},
        pm["cfg"], n_real=pm["n_real"], device=device)
    readout = (readout_from_numpy(data["readout/w_out"], device=device)
               if m["readout"] else None)

    cost_model = None
    if m["cost"] is not None:
        c = dict(m["cost"])
        key = c.pop("key")
        cost_model = WaveCostModel.from_artifact(
            os.path.join(path, "cost.json"),
            key=None if key is None else tuple(key), **c)

    eng = cls(params, max_slots=ek["max_slots"], readout=readout,
              bucket_min=ek["bucket_min"], ensemble=ek["ensemble"],
              chunk_max=ek["chunk_max"], autotune=ek["autotune"],
              cost_model=cost_model, decode_slo_us=ek["decode_slo_us"],
              decode_wave_tokens=ek["decode_wave_tokens"],
              park_host_rows=ek["park_host_rows"], cold_dir=ek["cold_dir"],
              pipeline_depth=ek.get("pipeline_depth", 2), device=device,
              mesh=mesh, _param_batch=ek["param_batch"],
              **{k: ek.get(k, default)
                 for k, (_, default) in _LEARN_KNOBS.items()})
    eng.scheduler.max_wave = ek["max_wave"]
    eng._table.use_clock = int(m["use_clock"])
    dev = eng.device

    def tensor(v):
        return torch.tensor(v, device=dev)

    eng._exec.arena = eng._exec.place_arena(arena_mod.SlotArena(
        states=tensor(data["arena/states"]),
        y_prev=tensor(data["arena/y_prev"]),
        active=tensor(data["arena/active"])))
    for rec in m["sessions"]:
        sid = _sid_from_json(rec["sid"])
        eng.sessions[sid] = _stats_from_rec(rec)
        eng._table.slots[rec["slot"]] = sid

    from .learn import _GramAcc, _LearnState
    ln = eng._learn_plane
    for i, rec in enumerate(m.get("learn_state", [])):
        acc = _GramAcc(pairs=rec["pairs"], skip_left=rec["skip_left"],
                       drift=rec["drift"])
        if rec["gram"]:
            acc.gram = tensor(data[f"learn{i}/gram"])
            acc.cg = tensor(data[f"learn{i}/cg"])
        ls = _LearnState(tenant=_sid_from_json(rec["tenant"]),
                         steps_since_fb=rec["steps_since_fb"],
                         dirty=rec["dirty"], acc=acc)
        if rec["last_fb"]:
            ls.last_fb = data[f"learn{i}/last_fb"]
        ln.state[_sid_from_json(rec["sid"])] = ls
    if m.get("readout_pools"):
        for i, rec in enumerate(m["readout_pools"]):
            ln.readouts[_sid_from_json(rec["key"])] = tensor(
                data[f"pool{i}/w"])
        eng._exec.activate_pool()
        eng._exec.sync_slot_readouts([(sid, st.slot)
                                      for sid, st in eng.sessions.items()])

    if eng.store is not None and "store" in m:
        st = m["store"]
        eng.store.epoch = st["epoch"] + 1        # new records: new epoch dir
        eng.store._seq = 0
        hs, hy = data["park/states"], data["park/y_prev"]
        for rec in st["parked"]:
            sid = _sid_from_json(rec["sid"])
            stats = _stats_from_rec(rec["stats"])
            if rec["tier"] == "host":
                eng.store.park_many([sid], hs[rec["hrow"]][None],
                                    hy[rec["hrow"]][None], [stats])
            else:
                eng.store.table[sid] = ParkedSession(
                    stats=stats, tier="cold", path=rec["path"])

    for i, rec in enumerate(m["queue"]):
        arrs = {name: (data[f"q{i}/{name}"] if rec[name] else None)
                for name in ("u", "y_teacher", "h0", "y0")}
        eng.scheduler.submit(PrefillRequest(
            sid=_sid_from_json(rec["sid"]), done=rec["done"], **arrs))
    if m["deferred"] is not None:
        eng.scheduler._deferred = _sid_from_json(m["deferred"])

    ex = eng._exec
    for key, prefix, buf in (("decode_buf", "dec", ex._decode_buf),
                             ("chunk_outs", "chunk", ex._chunk_outs)):
        for i, rec in enumerate(m[key]):
            buf[_sid_from_json(rec["sid"])] = [tensor(data[f"{prefix}{i}"])]
    for rec in m["decode_meta"]:
        ex._decode_meta.append(
            {"kind": rec["kind"], "rows": rec["rows"],
             "tokens": rec["tokens"], "us": rec["us"], "fused": rec["fused"],
             "_pending": {_sid_from_json(s) for s in rec["pending"]}})
    return eng
