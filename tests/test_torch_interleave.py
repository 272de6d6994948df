"""The decode-SLO interleave, the cost-model scheduler and autotune in the
port (``tests/test_decode_aware.py``, ``tests/test_scheduler_fairness.py``).

An interleaved flush's budget reads the wall clock, so its wave order
depends on the host: schedules are compared only inside the port, and
against JAX only what no schedule changes — the prefill outputs (against
the JAX engine's decode-blind flush) and the interleaved decode tokens
(against 1-token closed-loop calls of that engine), at 1e-9.  Inside the
port both are bit-exact.  The scheduler's cost-model paths (the look-ahead
deferral, the budget fit, the due set) are pure host logic fed by the same
numpy cost model, so their plans equal JAX's exactly.
"""
import time

import numpy as np
import pytest

from repro.core import esn as jesn
from repro.core import params as jparams
from repro.serve import PrefillRequest as JaxRequest
from repro.serve import WaveCostModel as JaxCost
from repro.serve import WaveScheduler as JaxScheduler
from repro.serve.engine import ReservoirEngine as JaxEngine
from repro_torch.core import esn as tesn
from repro_torch.core import params as tparams
from repro_torch.data.signals import mso_series
from repro_torch.serve.cost import WaveCostModel
from repro_torch.serve.engine import ReservoirEngine
from repro_torch.serve.scheduler import (PrefillRequest, WaveScheduler,
                                         bucket_length)

TOL = dict(rtol=1e-9, atol=1e-9)
CFG = dict(n=48, spectral_radius=0.9, leak=0.8, input_scaling=0.5,
           ridge_alpha=1e-8, seed=7)
SIG = mso_series(3, 2001)
U, Y = SIG[:-1, None], SIG[1:, None]


def _np(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") \
        else np.asarray(v)


def _seeded(cls=WaveCostModel, alpha=5000.0, beta=100.0,
            buckets=(16, 32, 64, 128, 256)):
    m = cls()
    for t in buckets:
        for b in (1, 2, 3, 4):
            m.observe(b, t, alpha + beta * b)
    return m


_MODELS = {}


def _model():
    """(jax params, jax readout, port params, port readout)."""
    if not _MODELS:
        jp = jesn.diag_params(jparams.ESNConfig(**CFG))
        jr = jesn.fit(jp, U[:600], Y[:600], washout=50)
        tp = tesn.diag_params(tparams.ESNConfig(**CFG), device="cpu")
        tr = tparams.readout_from_numpy(np.asarray(jr.w_out), device="cpu")
        _MODELS.update(v=(jp, jr, tp, tr))
    return _MODELS["v"]


def _build(cls, slo, *, pipeline_depth=2, **extra):
    jp, jr, tp, tr = _model()
    kw = dict(chunk_max=100, pipeline_depth=pipeline_depth, **extra)
    if cls is ReservoirEngine:
        params, readout, cost = tp, tr, WaveCostModel
        kw["device"] = "cpu"
    else:
        params, readout, cost = jp, jr, JaxCost
    if slo is not None:
        cm = cost()
        cm.seed(_seeded(cost, buckets=(64, 128)).records())
        kw.update(cost_model=cm, decode_slo_us=slo)
    e = cls(params, max_slots=4, readout=readout, **kw)
    e.submit("d0", U[:30])
    e.submit("d1", U[:30])
    e.flush()
    e.decode_closed_loop(1)
    e.collect_decoded()
    for i in range(4):
        e.submit(("f", i), U[:400])            # 4 chunk waves each
    return e


@pytest.mark.parametrize("k", (1, 3))
def test_interleave_is_bit_exact_and_actually_interleaves(k):
    """Prefill outputs equal the decode-blind engine's bit for bit, and the
    interleaved tokens equal 1-token closed-loop calls of it — in the port;
    and both equal the JAX decode-blind engine to 1e-9."""
    aware = _build(ReservoirEngine, 6000.0, decode_wave_tokens=k)
    blind = _build(ReservoirEngine, None)
    jblind = _build(JaxEngine, None)
    ra = aware.flush(decode_interleave=True, want_outputs=True)
    rb = blind.flush(want_outputs=True)
    rj = jblind.flush(want_outputs=True)
    assert sorted(ra, key=str) == sorted(rb, key=str) == sorted(rj, key=str)
    for s in ra:
        np.testing.assert_array_equal(_np(ra[s]), _np(rb[s]))
        np.testing.assert_allclose(_np(ra[s]), _np(rj[s]), **TOL)
    st = aware.stats()
    assert st.decode_interleave_waves > 0
    res = aware.collect_decoded()
    assert set(res) == {"d0", "d1"}
    assert all(w["kind"] == "interleave" and w["fused"] and w["tokens"] == k
               and w["us"] is not None for w in res.waves)
    buf = {s: _np(res[s]) for s in res}
    n_tok = buf["d0"].shape[0]
    assert n_tok == st.decode_interleave_waves * k
    for i in range(n_tok):
        ys = blind.decode_closed_loop(1, sids=["d0", "d1"])
        yj = jblind.decode_closed_loop(1, sids=["d0", "d1"])
        for s in ("d0", "d1"):
            np.testing.assert_array_equal(buf[s][i:i + 1], _np(ys[s]))
            np.testing.assert_allclose(buf[s][i:i + 1], _np(yj[s]), **TOL)
    assert aware.collect_decoded("d0")["d0"].shape == (0, 1)


def test_interleave_pipelined_equals_synchronous():
    """The in-flight window (bounded by depth and the SLO's predicted cost)
    changes no bit: depth 2 == depth 0."""
    outs = []
    for depth in (0, 2):
        e = _build(ReservoirEngine, 6000.0, pipeline_depth=depth,
                   decode_wave_tokens=2)
        r = e.flush(decode_interleave=True, want_outputs=True)
        outs.append(([_np(r[s]) for s in sorted(r, key=str)],
                     _np(e.states), _np(e.y_prev)))
        assert e.stats().pipeline_inflight_peak <= max(depth, 1)
    for g, w in zip(outs[0][0] + list(outs[0][1:]),
                    outs[1][0] + list(outs[1][1:])):
        np.testing.assert_array_equal(g, w)


def test_interleave_decode_latency_counters():
    aware = _build(ReservoirEngine, 6000.0)
    aware.flush(decode_interleave=True)
    st = aware.stats()
    assert st.decode_waves_total >= st.decode_interleave_waves > 0
    assert st.decode_rows_total >= 2 * st.decode_interleave_waves
    assert st.decode_gaps > 0
    assert st.decode_gap_p95_us >= st.decode_gap_p50_us > 0.0
    aware.release("d0")
    assert aware.collect_decoded("d0")["d0"].shape == (0, 1)


def test_flush_interleave_validation():
    _, _, tp, tr = _model()
    with pytest.raises(ValueError, match="decode_slo_us must be positive"):
        ReservoirEngine(tp, 2, readout=tr, device="cpu", decode_slo_us=0.0)
    eng = ReservoirEngine(tp, 2, readout=tr, device="cpu")
    with pytest.raises(ValueError, match="needs decode_slo_us"):
        eng.flush(decode_interleave=True)
    bare = ReservoirEngine(tp, 2, device="cpu", decode_slo_us=100.0)
    with pytest.raises(ValueError, match="trained readout"):
        bare.flush(decode_interleave=True)
    for bad in (0, "sometimes"):
        with pytest.raises(ValueError, match="decode_wave_tokens"):
            ReservoirEngine(tp, 2, readout=tr, device="cpu",
                            decode_wave_tokens=bad)
    eng2 = ReservoirEngine(tp, 2, readout=tr, device="cpu",
                           decode_slo_us=1.0)
    eng2.submit("a", U[:40])
    eng2.flush(decode_interleave=True)
    assert eng2.stats().decode_interleave_waves == 0
    assert eng2.ready_sessions == ["a"]


def test_interleave_explicit_decode_sids():
    eng = _build(ReservoirEngine, 6000.0)
    with pytest.raises(KeyError, match="not ready"):
        eng.flush(decode_interleave=True, decode_sids=["d0", ("f", 0)])
    assert len(eng.scheduler) > 0
    eng.flush(decode_interleave=True, decode_sids=["d0"])
    assert set(eng.collect_decoded()) == {"d0"}
    assert eng.stats().decode_interleave_waves > 0


def test_per_session_slo_licenses_an_explicit_flush():
    """Without an engine-wide SLO, ``submit(decode_slo_us=)`` deadlines
    license an interleaved flush over exactly those sessions."""
    _, _, tp, tr = _model()
    cm = WaveCostModel()
    cm.seed(_seeded(buckets=(64, 128)).records())
    eng = ReservoirEngine(tp, 4, readout=tr, device="cpu", chunk_max=100,
                          cost_model=cm)
    eng.submit("p", U[:30], decode_slo_us=6000.0)
    eng.submit("q", U[:30])
    eng.flush()
    for i in range(2):
        eng.submit(("f", i), U[:400])
    with pytest.raises(ValueError, match="needs decode_slo_us"):
        eng.flush(decode_interleave=True, decode_sids=["p", "q"])
    eng.flush(decode_interleave=True, decode_sids=["p"])
    assert set(eng.collect_decoded()) == {"p"}


def test_unsatisfiable_slo_flush_max_waves_still_progresses():
    _, _, tp, tr = _model()
    cm = WaveCostModel()
    cm.seed(_seeded(buckets=(64, 128)).records())
    eng = ReservoirEngine(tp, 4, readout=tr, device="cpu", chunk_max=100,
                          cost_model=cm, decode_slo_us=50.0)
    eng.submit("d0", U[:30])
    eng.flush()
    eng.decode_closed_loop(1)
    for i in range(3):
        eng.submit(("f", i), U[:200])
    for _ in range(20):
        eng.flush(max_waves=1, decode_interleave=True)
        if not (len(eng.pending) or eng.stats().chunks_in_flight):
            break
    else:
        pytest.fail("flush(max_waves=1) never drained the queue")
    assert sorted(eng.ready_sessions, key=str) == sorted(
        ["d0", ("f", 0), ("f", 1), ("f", 2)], key=str)
    assert eng.stats().decode_interleave_waves > 0


def test_decode_wave_tokens_auto_follows_the_cost_model():
    """``decode_wave_tokens="auto"`` resolves K per interleaved flush from
    the fitted c_dec(B, K) surface, capped by the SLO."""
    cm = WaveCostModel()
    cm.seed(_seeded(buckets=(64, 128)).records())
    for k in (1, 2, 4, 8):
        for b in (1, 2):
            cm.observe_decode(b, 400.0 + 20.0 * k + 5.0 * b * k, k=k)
    _, _, tp, tr = _model()
    eng = ReservoirEngine(tp, 4, readout=tr, device="cpu", chunk_max=100,
                          cost_model=cm, decode_slo_us=6000.0,
                          decode_wave_tokens="auto")
    eng.submit("d0", U[:30])
    eng.submit("d1", U[:30])
    eng.flush()
    for i in range(3):
        eng.submit(("f", i), U[:400])
    want = cm.best_decode_k(2, slo_us=6000.0)
    assert want > 1
    eng.flush(decode_interleave=True)
    assert eng.decode_wave_tokens == want
    res = eng.collect_decoded()
    assert res.waves and all(w["tokens"] == want for w in res.waves)


def test_autotune_times_waves_and_whole_decode_waves():
    """Autotune observes every prefill wave (one c(B, T) point each) and a
    K-token decode launch as ONE point on c_dec(B, K)."""
    _, _, tp, tr = _model()
    eng = ReservoirEngine(tp, 4, readout=tr, device="cpu", autotune=True)
    assert eng.cost_model is not None and eng.cost_model.key[0] == "cpu"
    for i in range(3):
        eng.submit(i, U[:100 + 50 * i])
    eng.flush()
    n_waves = eng.stats().waves_total
    recs = eng.cost_model.records()
    assert sum("t_bucket" in r for r in recs) == n_waves > 0
    assert all(r["us"] > 0 for r in recs)
    eng.decode_closed_loop(8)
    dec = [r for r in eng.cost_model.records() if r.get("kind") == "decode"]
    assert dec[-1]["b"] == 3 and dec[-1]["k"] == 8
    eng.decode_step({0: U[0]})
    dec = [r for r in eng.cost_model.records() if r.get("kind") == "decode"]
    assert len(dec) == 2 and "k" not in dec[-1]
    assert eng.stats().wave_us_mean > 0


# --------------------------------------------------- scheduler vs JAX plans
def _plan(sch, capacity, budgets, floors):
    out = []
    for budget, floor in zip(budgets, floors):
        if not len(sch):
            break
        kw = {} if floor is None else {"shrink_floor": floor}
        wave = sch.next_wave(capacity, budget_us=budget, **kw)
        out.append([(it.sid, it.start, it.stop, it.first, it.last)
                    for it in wave])
    return out


@pytest.mark.parametrize("seed", range(12))
def test_scheduler_cost_paths_plan_as_jax(seed):
    """Look-ahead deferral, budget fit (shrink / defer / waived floor) and
    chunked admission: the port's scheduler with the port's cost model pops
    exactly the waves JAX's pops, for random loads, costs and budgets."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 300, size=int(rng.integers(1, 30)))
    capacity = int(rng.integers(1, 8))
    chunk_max = [None, 64, 100][seed % 3]
    costs = rng.uniform(10.0, 1e4, size=6)
    scheds = []
    for sched_cls, cost_cls, req in ((WaveScheduler, WaveCostModel,
                                      PrefillRequest),
                                     (JaxScheduler, JaxCost, JaxRequest)):
        m = cost_cls()
        for i, c in enumerate(costs):
            m.observe(1 + i % 3, 16 << (i % 3), c)
        sch = sched_cls(bucket_min=16, cost_model=m, chunk_max=chunk_max)
        for i, t in enumerate(lengths):
            sch.submit(req(sid=i, u=np.zeros((t, 1))))
        scheds.append(sch)
    n = 4 * len(lengths) + 8
    budgets = [None if r < 0.3 else float(b) for r, b in
               zip(rng.random(n), rng.uniform(0, 2e4, size=n))]
    floors = [None if r < 0.7 else 0.0 for r in rng.random(n)]
    plans = [_plan(s, capacity, budgets, floors) for s in scheds]
    assert plans[0] == plans[1]
    assert len(scheds[0]) == len(scheds[1])


def test_due_decode_sids_match_jax():
    """Per-session deadlines: the due set and the budget are the JAX
    scheduler's (the wall clock pinned out: stamps in the future)."""
    out = []
    for cls in (WaveScheduler, JaxScheduler):
        sch = cls(bucket_min=16)
        for sid, slo in (("a", 1000.0), ("b", 3000.0), ("c", 3000.0)):
            sch.track_decode(sid, slo)
        sch.note_decoded(["a", "b", "c"], wall=time.perf_counter() + 1e6)
        rec = []
        for charge in (500.0, 400.0, 2000.0):
            sch.charge_decode_cost(charge)
            rec.append((sch.due_decode_sids(100.0),
                        sch.due_decode_sids(100.0, among=["b", "c"]),
                        sch.decode_budget(100.0)))
        out.append(rec)
    assert out[0] == out[1]


def test_decode_budget_bounds_prefill_streaks_property():
    """``tests/test_decode_aware.py`` on the port's scheduler: under a
    decode SLO the flush policy plans at most floor(slo / c_min) + 1
    prefill waves between decode opportunities, serving each request
    exactly once."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st
    buckets = (16, 32, 64, 128, 256, 512)

    @given(lengths=st.lists(st.integers(1, 300), min_size=1, max_size=30),
           capacity=st.integers(1, 8), slo_mult=st.floats(0.4, 6.0))
    @settings(max_examples=40, deadline=None)
    def run(lengths, capacity, slo_mult):
        m = WaveCostModel()
        for t in buckets:
            for b in (1, 4):
                m.observe(b, t, 200.0 + 3.0 * b)
        sch = WaveScheduler(bucket_min=16, cost_model=m)
        for i, t in enumerate(lengths):
            sch.submit(PrefillRequest(sid=i, u=np.zeros((t, 1))))
        c_min = min(m.predict_us(1, b) for b in buckets)
        slo = slo_mult * c_min
        k_max = int(slo // c_min) + 1
        served, runs, clock = set(), [], 0.0
        while len(sch):
            wave = sch.next_wave(capacity, budget_us=slo - clock)
            if not wave:
                if clock > 0:
                    runs.append("D")
                    clock = 0.0
                    continue
                wave = sch.next_wave(capacity)
                assert wave
            b = bucket_length(wave[0].length, bucket_min=16)
            for it in wave:
                assert it.sid not in served
                served.add(it.sid)
            clock += m.predict_us(len(wave), b)
            runs.append("P")
        assert served == set(range(len(lengths)))
        streak = 0
        for r in runs:
            streak = streak + 1 if r == "P" else 0
            assert streak <= k_max, (runs, k_max)

    run()


# ------------------------------------------------- profiler and the driver
def test_profile_dir_capture_writes_a_trace(tmp_path):
    """``profile_dir``: ``tracker.capture(name)`` writes a Chrome trace of
    the window (``torch.profiler``; CPU activity here, CUDA too on the
    card) naming the region."""
    import json
    from repro_torch.serve.telemetry import (MultiTracker, ProfilerTracker,
                                             make_tracker)
    _, _, tp, tr = _model()
    eng = ReservoirEngine(tp, 2, readout=tr, device="cpu",
                          profile_dir=str(tmp_path / "prof"))
    eng.submit("s", U[:64])
    eng.flush()
    with eng.tracker.capture("decode"):
        eng.decode_closed_loop(4)
    traces = sorted((tmp_path / "prof").glob("decode.*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "decode" for e in events)
    assert eng.stats().decode_waves_total == 1
    both = make_tracker(f"jsonl:{tmp_path / 'log.jsonl'}",
                        profile_dir=str(tmp_path))
    assert isinstance(both, MultiTracker)
    assert isinstance(both.trackers[1], ProfilerTracker)
    assert not both.trackers[1].cuda
    both.close()


def test_serve_driver_decode_slo_on_cpu(tmp_path):
    """``launch.serve --reservoir --decode-slo`` on the CPU: interleaved
    decode waves ran, teacher-forced open-loop tokens flowed, every token
    finite; ``--cost-save`` writes the refined model, ``--cost-seed`` reads
    it back."""
    from repro_torch.launch import serve as tserve
    path = str(tmp_path / "costs.json")
    argv = ["--reservoir", "--n", "48", "--slots", "3", "--sessions", "5",
            "--prompt-len", "300", "--gen", "8", "--chunk-max", "64",
            "--decode-slo", "2000", "--decode-wave-tokens", "2",
            "--autotune", "--device", "cpu", "--cost-save", path]
    res = tserve.main(argv)
    assert res["finite"] and res["sessions"] == 5
    assert res["decode_interleave_waves"] > 0
    assert res["interleaved_tokens"] > 0
    saved = WaveCostModel.from_artifact(path, key=("cpu", 48, 1))
    assert saved.n_observations > 0
    res = tserve.main(argv[:-2] + ["--cost-seed", path,
                                   "--decode-wave-tokens", "auto",
                                   "--profile-dir", str(tmp_path / "p")])
    assert res["finite"] and res["sessions"] == 5
    assert list((tmp_path / "p").glob("serve.*.pt.trace.json"))


# ------------------------------------- scheduler fairness, on the port
def _drain(sch, capacity):
    """Pop waves until empty: {sid: index of the wave that served it}."""
    served, waves = {}, 0
    while len(sch):
        wave = sch.next_wave(capacity)
        assert wave, "queue non-empty but nothing runnable"
        assert len({bucket_length(it.length, bucket_min=sch.bucket_min)
                    for it in wave}) == 1
        assert sum(it.first for it in wave) <= capacity
        for it in wave:
            assert it.sid not in served
            served[it.sid] = waves
        waves += 1
    return served


def _wait_bounds(lengths, capacity, bucket_min=16):
    """Strict oldest-first bound per request: the sum over buckets of
    ceil(older requests in that bucket / capacity)."""
    buckets = [bucket_length(t, bucket_min=bucket_min) for t in lengths]
    out = []
    for i in range(len(lengths)):
        per = {}
        for j in range(i):
            per[buckets[j]] = per.get(buckets[j], 0) + 1
        out.append(sum(-(-c // capacity) for c in per.values()))
    return out


@pytest.mark.parametrize("lookahead", (False, True),
                         ids=("oldest-first", "lookahead"))
def test_scheduler_wait_bounds_mixed_load(lookahead):
    """``tests/test_scheduler_fairness.py`` on the port's scheduler: every
    request is served within the oldest-first bound (doubled plus one with
    a cost model's one-wave look-ahead deferral), exactly once."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @given(lengths=st.lists(st.integers(1, 300), min_size=1, max_size=40),
           capacity=st.integers(1, 8),
           costs=st.lists(st.floats(10.0, 1e4), min_size=6, max_size=6))
    @settings(max_examples=60, deadline=None)
    def run(lengths, capacity, costs):
        m = None
        if lookahead:
            m = WaveCostModel()
            for i, c in enumerate(costs):
                m.observe(1 + i % 3, 16 << (i % 3), c)
        sch = WaveScheduler(bucket_min=16, cost_model=m)
        for i, t in enumerate(lengths):
            sch.submit(PrefillRequest(sid=i, u=np.zeros((t, 1))))
        served = _drain(sch, capacity)
        for i, bound in enumerate(_wait_bounds(lengths, capacity)):
            limit = 2 * bound + 1 if lookahead else bound
            assert served[i] <= limit, (i, served[i], bound)

    run()
