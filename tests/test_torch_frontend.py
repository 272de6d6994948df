"""Port parity: the open-loop front end (``serve/frontend.py``).

The four cases of the JAX package's ``tests/test_serving_planes.py``
(per-token streaming, ``AdmissionFull`` backpressure with nothing
half-registered, graceful drain refusing late submits, one ``frontend``
tracker event) run on the port; then one seeded workload: the tokens the
port's ``OpenLoopServer`` streams equal, bit for bit, the port's
synchronous ``submit`` / ``flush`` / ``decode_closed_loop`` calls that the
serving loop makes, and the JAX ``OpenLoopServer``'s streamed tokens to
1e-9 of max(|ref|, 1) (float64; ROADMAP C5).  Last, the reference's stall
with ``decode_interleave`` behind a full arena (ROADMAP C9), which the
port reproduces: both packages run the same bounded cycles to the same
standstill, and stream a session past its quota when one flush runs
several interleaved decode waves for it.
"""
import asyncio

import numpy as np
import pytest

from repro.core.esn import ESNConfig as JConfig
from repro.core.esn import LinearESN as JLinearESN
from repro.serve import OpenLoopServer as JServer
from repro.serve import ReservoirEngine as JEngine
from repro_torch.core.esn import ESNConfig, LinearESN
from repro_torch.data.signals import mso_series
from repro_torch.serve import (AdmissionFull, OpenLoopServer, ReservoirEngine,
                               StreamToken, Tracker)

CFG = dict(n=32, d_in=1, d_out=1, spectral_radius=0.9, leak=0.85,
           ridge_alpha=1e-6, seed=9)


def _signal(t=1001):
    sig = mso_series(3, t)
    return sig[:-1, None], sig[1:, None]


def _fitted():
    u, y = _signal()
    model = LinearESN.diagonalized(ESNConfig(**CFG), device="cpu").fit(
        u[:400], y[:400], washout=50)
    return model, u, y


class _RecTracker(Tracker):
    def __init__(self):
        self.events = []

    def log_wave(self, event: dict) -> None:
        self.events.append(dict(event))


def test_frontend_streams_per_token():
    model, u, _ = _fitted()

    async def run():
        eng = ReservoirEngine(model, max_slots=2, device="cpu")
        server = OpenLoopServer(eng)
        await server.start()
        h1 = await server.submit("a", u[:32], n_decode=3)
        h2 = await server.submit("b", u[16:48], n_decode=3)
        toks1 = await h1.tokens()
        toks2 = await h2.tokens()
        await server.drain()
        return eng, h1, h2, toks1, toks2

    eng, h1, h2, toks1, toks2 = asyncio.run(run())
    for h, toks in ((h1, toks1), (h2, toks2)):
        assert [t.index for t in toks] == [0, 1, 2]
        assert all(isinstance(t, StreamToken) and isinstance(t.y, np.ndarray)
                   and t.y.shape == (1,) for t in toks)
        walls = [t.t_wall for t in toks]
        assert walls == sorted(walls)
        assert h.t_admitted is not None and h.t_first is not None
        assert h.t_done >= h.t_first >= h.t_admitted
    assert not eng.sessions and len(eng.scheduler) == 0


def test_frontend_surfaces_admission_backpressure():
    model, u, _ = _fitted()

    async def run():
        eng = ReservoirEngine(model, max_slots=1, max_queued=1, device="cpu")
        server = OpenLoopServer(eng)          # loop not started: no drain
        await server.submit("a", u[:32], n_decode=1)
        with pytest.raises(AdmissionFull):
            await server.submit("b", u[:32], n_decode=1)
        assert "b" not in server._sessions    # nothing half-registered
        await server.abort()

    asyncio.run(run())


def test_frontend_graceful_drain():
    model, u, _ = _fitted()

    async def run():
        eng = ReservoirEngine(model, max_slots=2, device="cpu")
        server = OpenLoopServer(eng)
        await server.start()
        h = await server.submit("a", u[:32], n_decode=2)
        await server.drain()                  # serves in-flight to quota
        toks = await h.tokens()
        assert len(toks) == 2                 # stream completed, not cut
        with pytest.raises(RuntimeError, match="draining"):
            await server.submit("late", u[:32])
        assert not eng.sessions and len(eng.scheduler) == 0
        return True

    assert asyncio.run(run())


def test_frontend_emits_tracker_events():
    model, u, _ = _fitted()
    rec = _RecTracker()

    async def run():
        eng = ReservoirEngine(model, max_slots=2, tracker=rec, device="cpu")
        server = OpenLoopServer(eng)
        await server.start()
        await server.submit("a", u[:32], n_decode=2)
        await server.drain()

    asyncio.run(run())
    fe = [e for e in rec.events if e["kind"] == "frontend"]
    assert len(fe) == 1 and fe[0]["sid"] == "a" and fe[0]["tokens"] == 2
    assert fe[0]["ttft_s"] > 0 and fe[0]["e2e_s"] >= fe[0]["ttft_s"]


# ---------------------------------------------- one workload, three routes
SLOTS, N_DECODE = 4, 12
#: Four sessions (prompt start, length): two buckets, so the first flush
#: runs two prefill waves.
SESSIONS = [(0, 40), (100, 64), (37, 40), (250, 64)]


def _stream(server_cls, eng, u):
    """Every session submitted before the loop starts, then streamed to
    its quota: sid -> (N_DECODE, 1) host array."""
    async def run():
        server = server_cls(eng)
        hs = [await server.submit(i, u[lo:lo + n], n_decode=N_DECODE)
              for i, (lo, n) in enumerate(SESSIONS)]
        await server.start()
        toks = [await h.tokens() for h in hs]
        await server.drain()
        return toks

    return {i: np.stack([np.asarray(t.y) for t in ts])
            for i, ts in enumerate(asyncio.run(run()))}


def test_streamed_tokens_equal_the_synchronous_engine_and_jax():
    u, y = _signal()
    model, _, _ = _fitted()
    streamed = _stream(OpenLoopServer,
                       ReservoirEngine(model, SLOTS, device="cpu"), u)
    # The calls the serving loop makes: one flush, then one closed-loop
    # token a cycle for every session still short of its quota.
    eng = ReservoirEngine(model, SLOTS, device="cpu")
    for i, (lo, n) in enumerate(SESSIONS):
        eng.submit(i, u[lo:lo + n])
    eng.flush()
    for _ in range(N_DECODE):
        eng.decode_closed_loop(1, sids=list(range(len(SESSIONS))))
    sync = {sid: v.numpy() for sid, v in eng.collect_decoded().items()}
    jmodel = JLinearESN.diagonalized(JConfig(**CFG)).fit(
        u[:400], y[:400], washout=50)
    # The JAX readout carried over (ROADMAP C3: the two ridge solves part
    # past 1e-7 relative).
    jmodel.readout = type(jmodel.readout)(model.readout.w_out.numpy())
    ref = _stream(JServer, JEngine(jmodel, SLOTS), u)
    for sid in range(len(SESSIONS)):
        assert streamed[sid].shape == (N_DECODE, 1)
        np.testing.assert_array_equal(streamed[sid], sync[sid])
        err = np.abs(streamed[sid] - ref[sid]) / np.maximum(
            np.abs(ref[sid]), 1.0)
        assert float(err.max()) <= 1e-9, (sid, float(err.max()))


def _stalled(server_cls, engine_cls, model, u, **kw):
    """One slot, a decode SLO, ``decode_interleave``: session "a" prefills
    and decodes, then "b" queues behind it; 50 more serving cycles.
    Returns (a's delivered tokens after the first cycle, after the 50,
    b's queued count)."""
    eng = engine_cls(model, 1, decode_slo_us=2000.0, decode_wave_tokens=2,
                     chunk_max=16, **kw)
    server = server_cls(eng, decode_interleave=True)

    async def run():
        h = await server.submit("a", u[:32], n_decode=8)
        server._cycle()
        first = h.delivered
        await server.submit("b", u[40:72], n_decode=8)
        for _ in range(50):
            server._cycle()
        return first, h.delivered, len(eng.scheduler)

    return asyncio.run(run())


def test_interleaved_frontend_stalls_behind_a_full_arena_as_jax_does():
    """ROADMAP C9, a property of the reference the port reproduces: with
    ``decode_interleave`` on, a request queued while every slot holds a
    session that still owes tokens stops the loop — the interleaved flush
    has no prefill wave to run, so it decodes nothing, and the cycle
    leaves decode to that flush while the queue is not empty."""
    u, y = _signal()
    model, _, _ = _fitted()
    jmodel = JLinearESN.diagonalized(JConfig(**CFG)).fit(
        u[:400], y[:400], washout=50)
    got = _stalled(OpenLoopServer, ReservoirEngine, model, u, device="cpu")
    want = _stalled(JServer, JEngine, jmodel, u)
    assert got == want
    first, later, queued = got
    assert 0 < first == later < 8 and queued == 1


def _overshoot(server_cls, engine_cls, model, u, **kw):
    """Two slots, every session due at once (a 1 ns SLO), 2-token decode
    waves: "a" (quota 3) has 2 tokens after the first cycle; "b"'s
    64-token prompt then prefills in four 16-token chunk waves, with a
    decode wave for "a" between them.  Returns what each streamed."""
    eng = engine_cls(model, 2, decode_slo_us=1e-3, decode_wave_tokens=2,
                     chunk_max=16, **kw)
    server = server_cls(eng, decode_interleave=True)

    async def run():
        ha = await server.submit("a", u[:16], n_decode=3)
        server._cycle()
        hb = await server.submit("b", u[40:104], n_decode=2)
        for _ in range(6):
            server._cycle()
        return ha.delivered, hb.delivered

    return asyncio.run(run())


def test_interleaved_frontend_streams_past_the_quota_as_jax_does():
    """ROADMAP C9, second part: the interleaved flush's decode waves do not
    know the stream's quota, and the loop routes every drained token."""
    u, y = _signal()
    model, _, _ = _fitted()
    jmodel = JLinearESN.diagonalized(JConfig(**CFG)).fit(
        u[:400], y[:400], washout=50)
    got = _overshoot(OpenLoopServer, ReservoirEngine, model, u, device="cpu")
    assert got == _overshoot(JServer, JEngine, jmodel, u)
    assert got[0] > 3 and got[1] == 2
