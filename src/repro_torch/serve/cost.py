"""Wave cost model: measured prefill timings -> predicted wave cost.

The diagonal reformulation makes the per-step update O(N) element-wise, so
serve throughput is dominated by *scheduling* quality — how full each
``(B_wave, T_bucket)`` prefill wave is and which bucket gets the free-slot
budget.  This module is the quantitative half of that decision:
:class:`WaveCostModel` fits the wall cost of one wave,

    c(B, T_bucket)  ~=  alpha_T + beta_T * B        (per-bucket affine)

from measured wave timings, and the scheduler's two-wave lookahead
(``serve.scheduler.WaveScheduler.next_wave``) uses it to pick the wave that
maximizes predicted true-tokens-per-second.

Decode has its own surface: a decode wave advances every active slot by K
fused closed-loop tokens in one dispatch, so its cost is affine in the
per-dispatch work,

    c_dec(B, K)  ~=  alpha + beta_k * K + beta_bk * B * K    (one fit)

fitted from timed decode dispatches (``ReservoirEngine`` autotune times both
open-loop ``decode_step`` (K=1) and fused K-token closed-loop waves).  The
alpha term is exactly what the fused kernel amortizes: K tokens pay ONE
dispatch constant, which is why a multi-token decode wave beats K single
steps and why the planner must price K explicitly.  The planner uses
both surfaces for decode-aware interleaving: the decode wave's own predicted
cost is *reserved* out of the latency budget (the inter-token gap ends when
its tokens exist), and a candidate prefill wave whose predicted cost would
overrun what remains of ``decode_slo_us`` is shrunk or deferred so the
decode wave runs first.

Why affine-per-bucket: every wave of a bucket runs the same ``(B,
T_bucket)`` launches, so within a bucket the cost is a fixed dispatch/
launch overhead (``alpha_T``) plus a per-row term (``beta_T``) — the scan
itself is batched, so rows are nearly free until the backend saturates.
Buckets with too few observations fall back to a *global* surface
``c ~= a0 + a1 * B * T`` fitted over all observations, and a cold model uses
documented constants — a wrong cost guess costs throughput, never
correctness (the planner only reorders waves; numerics are unchanged).

Seeding is two-stage, mirroring how the model is used:

* **offline** — a cost artifact (a JSON object whose ``"wave_costs"`` list
  holds measured wave timings, what :meth:`WaveCostModel.to_artifact` and
  the JAX package's serving benchmark write) warm-starts a model through
  :meth:`WaveCostModel.from_artifact`;
* **online**  — ``ReservoirEngine(autotune=True)`` times every flushed wave
  (``engine.stats()`` keeps the same numbers) and calls :meth:`observe`, so
  the model tracks the machine it is actually serving on.

Paging adds a third surface: the session store (``serve.store``) demotes /
promotes session rows between the device arena and a pinned host pool in ONE
gather/scatter wave, so its cost is affine in the rows moved,

    c_page(B)  ~=  alpha + beta * B          (one fit, group medians)

and the scheduler charges it against the same latency budget as prefill and
decode — a promote wave that would blow the decode SLO defers a prefill wave
exactly like an expensive prefill would (``kind: "page"`` records).

Learn-while-serving adds a fourth surface: a refit wave re-solves the
ridge readout of B sessions from their streamed Gram statistics in ONE
batched Cholesky solve, so its cost is affine in the sessions
refit,

    c_refit(B)  ~=  alpha + beta * B         (one fit, group medians)

and ``flush(refit=True)`` charges it against the same latency budget as
prefill / decode / page waves (``kind: "refit"`` records).

**Keying** — timings are machine- and shape-specific: a CPU-learned model
must never price the GPU, and a model fitted at ``n=512`` must never price
``n=4096``.  A model constructed with ``key=cost_key(backend, n, d_out)``
only *fits* records carrying the same key; records with a different key (or
legacy un-keyed records, loaded with a warning) are shelved verbatim so
:meth:`to_artifact` re-exports them — one artifact file can hold surfaces
for several machines without cross-contamination.  A key-less model keeps
the pre-keying behavior (fits everything) for backward compatibility.

Host-only module: numpy least squares only, no torch — it stays importable
for pure scheduling tests and never touches a device.  The port's engine
keys its models by the torch device type (``"cuda"`` / ``"cpu"``), so an
artifact the JAX engine keyed ``tpu``, ``gpu`` or ``cpu`` never seeds a
model of the card: a different key shelves (the JAX engine's ``cpu`` is
the host's own clock too, and fits a ``cpu``-keyed port model of the same
shape).
"""
from __future__ import annotations

import collections
import json
import warnings
from typing import Deque, Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = ["WaveCostModel", "cost_key"]


def cost_key(backend: str, n: int, d_out: int) -> Tuple[str, int, int]:
    """The canonical observation key: ``(backend, n, d_out)``.  Wave cost
    depends on the machine (backend) and the per-row work (state width ``n``,
    readout width ``d_out``); everything else (B, T) is what the surfaces
    model.  Kept as a helper so every producer spells the key the same way."""
    return (str(backend), int(n), int(d_out))

#: Keep this many most-recent observations per bucket: enough to fit a stable
#: affine model, small enough that a drifting machine (thermal throttling,
#: noisy neighbours) is forgotten within ~a minute of serving.
_OBS_CAP = 64


class WaveCostModel:
    """Predicts the wall cost (microseconds) of one ``(B, T_bucket)`` wave.

    ``base_us`` / ``per_token_us``: the cold-start constants used before any
    observation lands — a fixed dispatch overhead plus a linear token term.
    They only have to get the *ordering* of candidate waves roughly right;
    real timings replace them after the first flush.
    """

    def __init__(self, *, base_us: float = 300.0,
                 per_token_us: float = 0.05,
                 decode_base_us: float = 150.0,
                 decode_per_row_us: float = 1.0,
                 page_base_us: float = 200.0,
                 page_per_row_us: float = 2.0,
                 refit_base_us: float = 400.0,
                 refit_per_row_us: float = 50.0,
                 key: Optional[Tuple[str, int, int]] = None):
        self.base_us = float(base_us)
        self.per_token_us = float(per_token_us)
        self.decode_base_us = float(decode_base_us)
        self.decode_per_row_us = float(decode_per_row_us)
        self.page_base_us = float(page_base_us)
        self.page_per_row_us = float(page_per_row_us)
        self.refit_base_us = float(refit_base_us)
        self.refit_per_row_us = float(refit_per_row_us)
        #: Observation key (``cost_key(backend, n, d_out)``) or None for the
        #: legacy fit-everything behavior.
        self.key: Optional[Tuple[str, int, int]] = (
            None if key is None else tuple(key))
        self._obs: Dict[int, Deque[Tuple[int, float]]] = {}
        self._fits: Dict[int, Optional[Tuple[float, float]]] = {}
        self._global: Optional[Tuple[float, float]] = None
        self._dirty: set = set()
        self._global_dirty = False
        self._dec_obs: Deque[Tuple[int, int, float]] = collections.deque(
            maxlen=_OBS_CAP)
        self._dec_fit: Optional[Tuple[float, float, float]] = None
        self._dec_dirty = False
        self._page_obs: Deque[Tuple[int, float]] = collections.deque(
            maxlen=_OBS_CAP)
        self._page_fit: Optional[Tuple[float, float]] = None
        self._page_dirty = False
        self._refit_obs: Deque[Tuple[int, float]] = collections.deque(
            maxlen=_OBS_CAP)
        self._refit_fit: Optional[Tuple[float, float]] = None
        self._refit_dirty = False
        #: Records seen by :meth:`seed` but not fitted (other key / legacy
        #: un-keyed): kept verbatim so :meth:`to_artifact` round-trips them.
        self._shelved: List[dict] = []

    # ------------------------------------------------------------ observing
    def observe(self, b: int, t_bucket: int, us: float) -> None:
        """Record one measured wave: ``b`` rows, bucket ``t_bucket``, ``us``
        wall microseconds."""
        if b <= 0 or us <= 0:
            return
        t = int(t_bucket)
        self._obs.setdefault(t, collections.deque(maxlen=_OBS_CAP)).append(
            (int(b), float(us)))
        self._dirty.add(t)
        self._global_dirty = True

    def observe_decode(self, b: int, us: float, k: int = 1) -> None:
        """Record one timed decode dispatch: ``b`` active rows advanced ``k``
        fused tokens in ``us`` wall microseconds.  The whole wave is ONE
        point on the c_dec(B, K) surface — per-token averaging would erase
        the dispatch constant the fused kernel amortizes."""
        if b <= 0 or us <= 0 or k <= 0:
            return
        self._dec_obs.append((int(b), int(k), float(us)))
        self._dec_dirty = True

    def observe_page(self, b: int, us: float) -> None:
        """Record one timed page wave: ``b`` session rows moved between the
        arena and the host pool (either direction — a demote's device->host
        gather and a promote's host->device scatter move the same bytes) in
        ``us`` wall microseconds."""
        if b <= 0 or us <= 0:
            return
        self._page_obs.append((int(b), float(us)))
        self._page_dirty = True

    def observe_refit(self, b: int, us: float) -> None:
        """Record one timed refit wave: ``b`` session readouts re-solved from
        their streamed Gram statistics in one batched device dispatch, ``us``
        wall microseconds."""
        if b <= 0 or us <= 0:
            return
        self._refit_obs.append((int(b), float(us)))
        self._refit_dirty = True

    def seed(self, records: Iterable[dict]) -> int:
        """Bulk-observe ``{"b":, "t_bucket":, "us":}`` prefill records,
        ``{"kind": "decode", "b":, "us":}`` decode records and
        ``{"kind": "page", "b":, "us":}`` page records (the shapes
        :meth:`records` emits and :meth:`to_artifact` writes).
        Returns how many landed in the fits.

        A keyed model (``key=`` passed to the constructor) only fits records
        whose ``"key"`` matches; records with a *different* key are shelved
        silently (normal multi-machine artifact) and un-keyed records are
        shelved under ``legacy`` with a warning — both are re-exported
        verbatim by :meth:`records` / :meth:`to_artifact`, so loading an
        artifact never loses another machine's surface."""
        n = 0
        legacy = 0
        for r in records:
            try:
                if self.key is not None:
                    rk = r.get("key")
                    if rk is None:
                        legacy += 1
                        self._shelved.append(r)
                        continue
                    if tuple(rk) != self.key:
                        self._shelved.append(r)
                        continue
                kind = r.get("kind")
                if kind == "decode":
                    self.observe_decode(int(r["b"]), float(r["us"]),
                                        k=int(r.get("k", 1)))
                elif kind == "page":
                    self.observe_page(int(r["b"]), float(r["us"]))
                elif kind == "refit":
                    self.observe_refit(int(r["b"]), float(r["us"]))
                else:
                    self.observe(int(r["b"]), int(r["t_bucket"]),
                                 float(r["us"]))
                n += 1
            except (KeyError, TypeError, ValueError, AttributeError):
                continue
        if legacy:
            warnings.warn(
                f"WaveCostModel(key={self.key}): shelved {legacy} legacy "
                "un-keyed cost record(s) (kept for re-export, not fitted) — "
                "re-measure on this machine or export with a keyed model",
                stacklevel=2)
        return n

    @classmethod
    def from_artifact(cls, path: str, **kw) -> "WaveCostModel":
        """Warm-start from a benchmark artifact (``serve_engine.json``).
        A missing/old-schema file yields a cold model — offline seeding is an
        optimization, never a requirement."""
        model = cls(**kw)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            return model
        records = data.get("wave_costs") if isinstance(data, dict) else None
        if isinstance(records, list):
            model.seed(records)
        return model

    @property
    def n_observations(self) -> int:
        return (sum(len(d) for d in self._obs.values())
                + len(self._dec_obs) + len(self._page_obs)
                + len(self._refit_obs))

    def clear(self) -> None:
        """Drop every observation and fit (cold-start constants remain).
        Callers that warm up before measuring use this between the warm-up
        pass and the measurement pass — first-call timings include kernel
        builds and would skew the fits by orders of magnitude."""
        self._obs.clear()
        self._fits.clear()
        self._global = None
        self._dirty.clear()
        self._global_dirty = False
        self._dec_obs.clear()
        self._dec_fit = None
        self._dec_dirty = False
        self._page_obs.clear()
        self._page_fit = None
        self._page_dirty = False
        self._refit_obs.clear()
        self._refit_fit = None
        self._refit_dirty = False
        self._shelved.clear()

    def records(self) -> list:
        """The retained observations as ``{"b", "t_bucket", "us"}`` prefill
        dicts followed by ``{"kind": "decode", "b", "us"}`` decode dicts
        (multi-token waves add ``"k"``; K=1 records omit it, so the schema
        older artifacts wrote is exactly what K=1 still reads) and
        ``{"kind": "page", "b", "us"}`` page dicts — the shape :meth:`seed` /
        :meth:`from_artifact` consume (what :meth:`to_artifact` writes
        under ``"wave_costs"``).  A keyed model tags each of its own
        records with ``"key"`` and appends any shelved foreign/legacy records
        verbatim, so the artifact round-trips every machine's surface."""
        own = ([{"b": b, "t_bucket": t, "us": us}
                for t, d in sorted(self._obs.items()) for b, us in d]
               + [{"kind": "decode", "b": b, "us": us} if k == 1 else
                  {"kind": "decode", "b": b, "k": k, "us": us}
                  for b, k, us in self._dec_obs]
               + [{"kind": "page", "b": b, "us": us}
                  for b, us in self._page_obs]
               + [{"kind": "refit", "b": b, "us": us}
                  for b, us in self._refit_obs])
        if self.key is not None:
            own = [{**r, "key": list(self.key)} for r in own]
        return own + list(self._shelved)

    def to_artifact(self, path: str) -> None:
        """Persist the retained observations under ``"wave_costs"`` in
        ``path`` — the same schema :meth:`from_artifact` loads, closing the
        persistence loop (a served engine's refined model survives the
        process).  An existing JSON object at ``path`` (e.g. the benchmark
        artifact) keeps its other keys; anything unreadable is replaced."""
        try:
            with open(path) as f:
                data = json.load(f)
            if not isinstance(data, dict):
                data = {}
        except (OSError, json.JSONDecodeError):
            data = {}
        data["wave_costs"] = self.records()
        with open(path, "w") as f:
            json.dump(data, f, indent=1)

    # ------------------------------------------------------------ predicting
    def _fit_bucket(self, t: int) -> Optional[Tuple[float, float]]:
        obs = self._obs.get(t)
        if not obs or len({b for b, _ in obs}) < 2:
            return None                      # need >= 2 distinct B for affine
        bs = np.asarray([b for b, _ in obs], float)
        us = np.asarray([u for _, u in obs], float)
        a = np.stack([np.ones_like(bs), bs], axis=1)
        (alpha, beta), *_ = np.linalg.lstsq(a, us, rcond=None)
        # Clamp to the physical regime: cost never negative at B=0 and never
        # shrinks with more rows (a noisy fit must not invert the ordering).
        return max(float(alpha), 0.0), max(float(beta), 0.0)

    def _fit_global(self) -> Optional[Tuple[float, float]]:
        pts = [(b * t, us) for t, d in self._obs.items() for b, us in d]
        if len(pts) < 2 or len({w for w, _ in pts}) < 2:
            return None
        work = np.asarray([w for w, _ in pts], float)
        us = np.asarray([u for _, u in pts], float)
        a = np.stack([np.ones_like(work), work], axis=1)
        (a0, a1), *_ = np.linalg.lstsq(a, us, rcond=None)
        return max(float(a0), 0.0), max(float(a1), 0.0)

    def predict_us(self, b: int, t_bucket: int) -> float:
        """Predicted wall microseconds for a ``b``-row wave of ``t_bucket``.
        Per-bucket fit when trained, global surface as fallback, cold-start
        constants before any data; always >= 1 (the planner divides by it)."""
        t = int(t_bucket)
        if t in self._dirty:
            self._fits[t] = self._fit_bucket(t)
            self._dirty.discard(t)
        fit = self._fits.get(t)
        if fit is not None:
            alpha, beta = fit
            return max(alpha + beta * b, 1.0)
        if self._global_dirty:
            self._global = self._fit_global()
            self._global_dirty = False
        if self._global is not None:
            a0, a1 = self._global
            return max(a0 + a1 * b * t, 1.0)
        return max(self.base_us + self.per_token_us * b * t, 1.0)

    def predict_decode_us(self, b: int, k: int = 1) -> float:
        """Predicted wall microseconds for one fused decode wave advancing
        ``b`` active slots by ``k`` tokens: c_dec(B, K) ~= alpha + beta_k*K
        + beta_bk*B*K.  Fitted over timed decode dispatches when trained
        (>= 2 distinct (B, K) groups), cold-start constants before; always
        >= 1.

        The fit goes through the per-(B, K)-group **medians**, not the raw
        points: decode dispatches are a few hundred microseconds, so any
        host hiccup (GC, scheduler preemption, a stray pending async op)
        lands an order-of-magnitude outlier that would drag a least-squares
        fit — and through it the reserved decode budget — far off the
        truth.  (All-K=1 data makes the intercept and K columns collinear;
        the min-norm solution still reproduces the K=1 surface exactly.)"""
        if self._dec_dirty:
            groups: Dict[Tuple[int, int], list] = {}
            for bb, kk, u in self._dec_obs:
                groups.setdefault((bb, kk), []).append(u)
            if len(groups) >= 2:
                keys = sorted(groups)
                bs = np.asarray([bb for bb, _ in keys], float)
                ks = np.asarray([kk for _, kk in keys], float)
                us = np.asarray([float(np.median(groups[key]))
                                 for key in keys])
                a = np.stack([np.ones_like(bs), ks, bs * ks], axis=1)
                coef, *_ = np.linalg.lstsq(a, us, rcond=None)
                # Same physical clamp as the prefill fits: never negative at
                # B=0, never cheaper with more rows or more tokens.
                self._dec_fit = tuple(max(float(c), 0.0) for c in coef)
            else:
                self._dec_fit = None
            self._dec_dirty = False
        if self._dec_fit is not None:
            alpha, beta_k, beta_bk = self._dec_fit
            return max(alpha + beta_k * k + beta_bk * b * k, 1.0)
        return max(self.decode_base_us + self.decode_per_row_us * b * k, 1.0)

    def predict_page_us(self, b: int) -> float:
        """Predicted wall microseconds for one page wave moving ``b`` session
        rows between arena and host pool: c_page(B) ~= alpha + beta * B.
        Fitted through per-B group medians when trained (>= 2 distinct B —
        page waves are host-transfer bound, so the same hiccup-outlier
        argument as :meth:`predict_decode_us` applies), cold-start constants
        before; always >= 1.  ``b <= 0`` is free: a wave that demotes nothing
        costs nothing, so the planner can price "no paging needed" as 0."""
        if b <= 0:
            return 0.0
        if self._page_dirty:
            groups: Dict[int, list] = {}
            for bb, u in self._page_obs:
                groups.setdefault(bb, []).append(u)
            if len(groups) >= 2:
                bs = np.asarray(sorted(groups), float)
                us = np.asarray([float(np.median(groups[int(bb)]))
                                 for bb in bs])
                a = np.stack([np.ones_like(bs), bs], axis=1)
                (alpha, beta), *_ = np.linalg.lstsq(a, us, rcond=None)
                self._page_fit = (max(float(alpha), 0.0),
                                  max(float(beta), 0.0))
            else:
                self._page_fit = None
            self._page_dirty = False
        if self._page_fit is not None:
            alpha, beta = self._page_fit
            return max(alpha + beta * b, 1.0)
        return max(self.page_base_us + self.page_per_row_us * b, 1.0)

    def predict_refit_us(self, b: int) -> float:
        """Predicted wall microseconds for one refit wave re-solving ``b``
        session readouts (batched Cholesky over stacked Gram stats):
        c_refit(B) ~= alpha + beta * B.  Fitted through per-B group medians
        when trained (>= 2 distinct B — refit waves are a few hundred
        microseconds, so the same hiccup-outlier argument as
        :meth:`predict_decode_us` applies), cold-start constants before;
        always >= 1.  ``b <= 0`` is free: no dirty sessions, no wave."""
        if b <= 0:
            return 0.0
        if self._refit_dirty:
            groups: Dict[int, list] = {}
            for bb, u in self._refit_obs:
                groups.setdefault(bb, []).append(u)
            if len(groups) >= 2:
                bs = np.asarray(sorted(groups), float)
                us = np.asarray([float(np.median(groups[int(bb)]))
                                 for bb in bs])
                a = np.stack([np.ones_like(bs), bs], axis=1)
                (alpha, beta), *_ = np.linalg.lstsq(a, us, rcond=None)
                self._refit_fit = (max(float(alpha), 0.0),
                                   max(float(beta), 0.0))
            else:
                self._refit_fit = None
            self._refit_dirty = False
        if self._refit_fit is not None:
            alpha, beta = self._refit_fit
            return max(alpha + beta * b, 1.0)
        return max(self.refit_base_us + self.refit_per_row_us * b, 1.0)

    def best_decode_k(self, b: int, *, slo_us: Optional[float] = None,
                      k_max: int = 64) -> int:
        """K-adaptive decode wave sizing: the largest K (power of two, up to
        ``k_max``) whose **marginal cost per token still improves** on the
        fitted ``c_dec(B, K)`` surface, capped so the whole wave's predicted
        cost stays within ``slo_us`` when given.  On the affine surface
        cost/token = alpha/K + const is strictly improving in K, so the SLO
        (or ``k_max``) is what binds — but the scan still walks the fitted
        surface, because a refit from real measurements need not be affine-
        monotone after the physical clamps.  Always >= 1: an unsatisfiable
        SLO degrades to single-token waves, never to no decode at all."""
        best_k = 1
        best_cpt = self.predict_decode_us(b, 1)
        if slo_us is not None and best_cpt > slo_us:
            return 1
        k = 2
        while k <= max(1, int(k_max)):
            c = self.predict_decode_us(b, k)
            if slo_us is not None and c > slo_us:
                break
            cpt = c / k
            if cpt >= best_cpt:
                break                    # marginal improvement stopped
            best_k, best_cpt = k, cpt
            k *= 2
        return best_k

    def throughput(self, b: int, t_bucket: int, true_tokens: int) -> float:
        """Predicted true-tokens-per-second of a candidate wave (``b`` rows of
        bucket ``t_bucket`` carrying ``true_tokens`` unpadded tokens)."""
        return float(true_tokens) / (self.predict_us(b, t_bucket) * 1e-6)
