"""Port parity: the tiered session store and the exec plane's paging.

The port's ``SessionStore`` against the JAX package's on the same op
sequences (tiers, host rows, LRU spill order, ``stats()``, errors, cold
records each reads from the other, the async lane's epoch guard under a
manually stepped executor), and the port's paged ``ReservoirEngine``
against the JAX paged engine on ``tests/test_session_store.py``'s
scenarios at n = 24: the same parked sets, tiers and page counters, states
and tokens at ``test_torch_engine.py``'s tolerance (1e-9).  Inside the
port a paged engine is bit-equal to a never-parked engine of the same
width, and the pipelined engine (``pipeline_depth=2`` and the I/O lane) to
the synchronous one, taking the overlap-demote fast path as often as the
JAX engine does on the same churn.
"""
import tempfile
from concurrent.futures import Future

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import esn as jesn
from repro.core import params as jparams
from repro.serve import store as jstore
from repro.serve.engine import ReservoirEngine as JaxEngine
from repro_torch.core import params as tparams
from repro_torch.core.params import Readout, stack_params
from repro_torch.data.signals import mso_series
from repro_torch.serve import store as tstore
from repro_torch.serve.engine import ReservoirEngine

TOL = dict(rtol=1e-9, atol=1e-9)
SIG = mso_series(3, 1401)
CFG = dict(n=24, d_in=1, d_out=1, spectral_radius=0.9, leak=0.8,
           input_scaling=0.5, ridge_alpha=1e-8, seed=7)
FB_CFG = dict(CFG, use_feedback=True, feedback_scaling=0.3, seed=11)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _models(cfg=CFG):
    """(jax params, jax readout, port params, port readout): the port's
    carried over from the JAX structs."""
    jc = jparams.ESNConfig(**cfg)
    jp = jesn.diag_params(jc)
    jr = jesn.fit(jp, SIG[:1200, None], SIG[1:1201, None], washout=50)
    arrays = {k: None if getattr(jp, k) is None else np.asarray(getattr(jp, k))
              for k in ("lam_q", "win_q", "wfb_q", "qtq")}
    tp = tparams.params_from_numpy("diag", arrays, cfg, n_real=jp.n_real,
                                   device="cpu")
    tr = tparams.readout_from_numpy(np.asarray(jr.w_out), device="cpu")
    return jp, jr, tp, tr


def _prompts(count, t=16, stride=9):
    return {f"s{i}": SIG[50 + i * stride:50 + i * stride + t, None]
            for i in range(count)}


def _cold():
    return tempfile.mkdtemp(prefix="torch_store_")


class _Stats:
    def __init__(self, last_use=0):
        self.last_use = last_use


# ------------------------------------------------------------------ store
def _table(store, root):
    """The parked table with cold paths relative to the store's cold dir."""
    return {sid: (e.tier, e.row, None if e.path is None
                  else e.path[len(root):], e.stats.last_use)
            for sid, e in store.table.items()}


def _store_ops(mod, root, record):
    """One op sequence: parks beyond the pool (LRU spills), a fetch across
    both tiers, a peek, re-parks, and a clear."""
    s = mod.SessionStore(4, 2, np.float64, host_rows=3, cold_dir=root,
                         io_workers=0)
    rng = np.random.default_rng(0)
    seq = [(["a", "b"], [5, 2]), (["c"], [9]), ([("t", 1), "d"], [1, 7]),
           (["e", "f"], [3, 4])]
    for sids, uses in seq:
        s.park_many(sids, rng.normal(size=(len(sids), 4)),
                    rng.normal(size=(len(sids), 2)),
                    [_Stats(u) for u in uses])
        record.append((_table(s, root), s.stats()))
    got = s.fetch_many(["a", "e", ("t", 1)])
    record.append((_table(s, root), s.stats(), got[0], got[1],
                   [x.last_use for x in got[2]]))
    record.append(s.peek("b"))
    s.park_many(["a"], got[0][:1], got[1][:1], [_Stats(11)])
    record.append((_table(s, root), s.stats()))
    s.clear()
    record.append((_table(s, root), s.stats()))


def test_store_op_sequence_matches_jax():
    """The same ops on both stores give the same tables (tiers, host rows,
    record names, LRU spill order), the same stats() and the same rows."""
    rec_j, rec_t = [], []
    _store_ops(jstore, _cold(), rec_j)
    _store_ops(tstore, _cold(), rec_t)
    assert len(rec_j) == len(rec_t)
    for a, b in zip(rec_j, rec_t):
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


@pytest.mark.parametrize("case", ["no_cold_dir", "pool_too_small"])
def test_store_errors_match_jax(case):
    msgs = []
    for mod in (jstore, tstore):
        cold = None if case == "no_cold_dir" else _cold()
        s = mod.SessionStore(4, 1, np.float64, host_rows=2, cold_dir=cold,
                             io_workers=0)
        s.park_many(["a"], np.ones((1, 4)), np.ones((1, 1)), [_Stats(1)])
        n = 2 if case == "no_cold_dir" else 3
        with pytest.raises(RuntimeError) as e:
            s.park_many([f"x{i}" for i in range(n)], np.ones((n, 4)),
                        np.ones((n, 1)), [_Stats(2)] * n)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert ("cold_dir" if case == "no_cold_dir" else "too small") in msgs[1]


@pytest.mark.parametrize("writer,reader", [(jstore, tstore), (tstore, jstore)])
def test_cold_record_read_by_the_other_store(writer, reader):
    """A cold record written by either store is read bit-equal by the
    other: the format is one .npz with ``state`` and ``y_prev``."""
    root = _cold()
    w = writer.SessionStore(6, 2, np.float64, host_rows=1, cold_dir=root,
                            io_workers=0)
    states = np.random.default_rng(1).normal(size=(2, 6)) * 1e20
    ys = np.random.default_rng(2).normal(size=(2, 2))
    w.park_many(["a"], states[:1], ys[:1], [_Stats(1)])
    w.park_many(["b"], states[1:], ys[1:], [_Stats(2)])
    path = w.table["a"].path
    assert w.tier_of("a") == "cold" and path.endswith(
        "epoch_0000/s000000.npz")
    r = reader.SessionStore(6, 2, np.float64, host_rows=1, cold_dir=root,
                            io_workers=0)
    got_s, got_y = r._read_record(path)
    np.testing.assert_array_equal(got_s, states[0])
    np.testing.assert_array_equal(got_y, ys[0])


class ManualExecutor:
    """Deterministic executor: tasks run at ``run_all`` or lazily at
    ``Future.result()`` — completions in any order, without threads."""

    def __init__(self):
        self.pending = []

    def submit(self, fn, *args, **kw):
        fut = Future()
        task = (fut, fn, args, kw)
        self.pending.append(task)
        orig_result = fut.result

        def result(timeout=None):
            self._run(task)
            return orig_result(timeout)

        fut.result = result
        return fut

    def _run(self, task):
        fut, fn, args, kw = task
        if task in self.pending:
            self.pending.remove(task)
            try:
                fut.set_result(fn(*args, **kw))
            except BaseException as e:     # pragma: no cover - error path
                fut.set_exception(e)

    def run_all(self):
        while self.pending:
            self._run(self.pending[0])


def _epoch_guard_scenario(eager, drain_before_bump):
    """Prefetches submitted under epoch e, completed in any order relative
    to an epoch bump, never surface epoch-e bytes once the table moved on:
    ``fetch_many`` re-reads the entry's current path."""
    ex = ManualExecutor()
    store = tstore.SessionStore(4, 1, np.float64, host_rows=1,
                                cold_dir=_cold(), _executor=ex)
    sids = [f"m{i}" for i in range(4)]
    for j, sid in enumerate(sids):
        store.park_many([sid], np.full((1, 4), float(j)),
                        np.full((1, 1), float(j)), [_Stats(j)])
    cold_sids = [s for s in sids if store.tier_of(s) == "cold"]
    assert len(cold_sids) == 3
    store.prefetch_many(cold_sids)
    for run_now in eager:
        if run_now and ex.pending:
            ex._run(ex.pending[0])
    if drain_before_bump:
        ex.run_all()
    store.epoch += 1
    store._seq = 0
    for j, s in enumerate(cold_sids):
        new_path = store._cold_path()
        store._write_record(new_path, np.full((4,), 100.0 + j),
                            np.full((1,), 100.0 + j))
        store.table[s].path = new_path
    states, _, _ = store.fetch_many(cold_sids)
    ex.run_all()                           # late completions change nothing
    for j in range(len(cold_sids)):
        np.testing.assert_array_equal(states[j], np.full((4,), 100.0 + j))
    assert not store._prefetch


@pytest.mark.parametrize("eager,drain_before_bump", [
    ([False, False, False], False), ([True, True, True], False),
    ([True, False, True], False), ([False, True, False], True)])
def test_epoch_guard_stale_prefetch_never_resurrects(eager,
                                                     drain_before_bump):
    _epoch_guard_scenario(eager, drain_before_bump)


@settings(max_examples=12, deadline=None)
@given(eager=st.lists(st.booleans(), min_size=3, max_size=3),
       drain_before_bump=st.booleans())
def test_epoch_guard_property(eager, drain_before_bump):
    _epoch_guard_scenario(eager, drain_before_bump)


def test_async_spill_round_trip_and_drain():
    """The table flips to cold at once, the bytes land in the background,
    and peek / fetch block only on the future they need."""
    ex = ManualExecutor()
    store = tstore.SessionStore(4, 1, np.float64, host_rows=1,
                                cold_dir=_cold(), _executor=ex)
    for j, sid in enumerate("abc"):
        store.park_many([sid], np.full((1, 4), 5.0 + j),
                        np.full((1, 1), 5.0 + j), [_Stats(j)])
    assert store.tier_of("a") == store.tier_of("b") == "cold"
    assert store.stats()["io_spills_inflight"] == 2
    np.testing.assert_array_equal(store.peek("a")[0], np.full((4,), 5.0))
    store.drain_io()
    assert store.stats()["io_spills_inflight"] == 0
    store.prefetch_many(["b"])
    states, _, _ = store.fetch_many(["b", "c"])
    np.testing.assert_array_equal(states, [np.full(4, 6.0), np.full(4, 7.0)])


# ----------------------------------------------------------------- engine
def test_paged_engine_matches_jax_paged_engine():
    """12 sessions into a 3-slot arena over a 4-row pool and a cold dir
    (``test_session_store.py``'s scenario): both engines park the same
    sessions in the same tiers with the same page counters, and every
    state agrees; decoding parked sessions promotes them in both."""
    jp, jr, tp, tr = _models()
    je = JaxEngine(jp, max_slots=3, readout=jr, park_host_rows=4,
                   cold_dir=_cold())
    te = ReservoirEngine(tp, 3, readout=tr, park_host_rows=4,
                         cold_dir=_cold(), device="cpu")
    prompts = _prompts(12)
    for eng in (je, te):
        for sid, u in prompts.items():
            eng.submit(sid, u)
        eng.flush()

    def same_tables():
        assert set(te.parked_sessions) == set(je.parked_sessions)
        assert set(te.active_sessions) == set(je.active_sessions)
        for sid in je.parked_sessions:
            assert te.store.tier_of(sid) == je.store.tier_of(sid)
        a, b = je.stats(), te.stats()
        for k in ("page_rows_total", "promote_waves", "demote_waves",
                  "overlap_demotes", "sessions_parked"):
            assert getattr(a, k) == getattr(b, k), k
        assert a.store == b.store

    same_tables()
    assert {te.store.tier_of(s) for s in te.store.sids} == {"host", "cold"}
    for sid in prompts:
        np.testing.assert_allclose(te.state_of(sid),
                                   np.asarray(je.state_of(sid)), **TOL)
    for grp in (["s0", "s1"], ["s5", "s9", "s2"]):
        a = je.decode_closed_loop(3, sids=grp)
        b = te.decode_closed_loop(3, sids=grp)
        for sid in grp:
            np.testing.assert_allclose(_np(b[sid]), np.asarray(a[sid]), **TOL)
        same_tables()


def test_paged_engine_bit_equal_to_never_parked_twin():
    """Paging moves rows with no dtype change: the 12-session paged engine's
    states equal a never-parked 12-slot engine's, and its tokens a
    never-parked engine's of its own width, bit for bit.  Arena width
    (4 against 16 slots) changes nothing on the CPU: measured equal."""
    _, _, tp, tr = _models()
    eng = ReservoirEngine(tp, 3, readout=tr, park_host_rows=4,
                          cold_dir=_cold(), device="cpu")
    ref = ReservoirEngine(tp, 12, readout=tr, device="cpu")
    for sid, u in _prompts(12).items():
        eng.submit(sid, u)
        ref.submit(sid, u)
    eng.flush()
    ref.flush()
    for sid in _prompts(12):
        np.testing.assert_array_equal(eng.state_of(sid), ref.state_of(sid))
    parked = set(eng.parked_sessions)
    eng.state_of("s0")
    assert set(eng.parked_sessions) == parked     # a peek never promotes

    u = SIG[50:66, None]

    def tokens(e):
        e.submit("x", u)
        e.flush()
        e.observe("x", u[-1] * 0.5)
        return _np(e.decode_closed_loop(6, sids=["x"])["x"])

    narrow = tokens(ReservoirEngine(tp, 4, readout=tr, device="cpu"))
    wide = tokens(ReservoirEngine(tp, 16, readout=tr, device="cpu"))
    paged = tokens(ReservoirEngine(tp, 4, readout=tr, park_host_rows=4,
                                   device="cpu"))
    np.testing.assert_array_equal(paged, narrow)
    np.testing.assert_array_equal(wide, narrow)


def test_feedback_y_prev_survives_the_cold_tier():
    """On a feedback model the parked y_prev is the next step's drive: an
    observed session churned down to the cold tier decodes bit-equal to an
    identically observed never-parked twin of the same width."""
    _, _, tp, tr = _models(FB_CFG)
    eng = ReservoirEngine(tp, 2, readout=tr, park_host_rows=1,
                          cold_dir=_cold(), device="cpu")
    ref = ReservoirEngine(tp, 2, readout=tr, device="cpu")
    u, yt = SIG[50:66, None], SIG[51:67, None]
    for e in (eng, ref):
        e.submit("fb", u, y_teacher=yt)
        e.flush()
        e.observe("fb", np.asarray([1.25]))
    for i in range(3):
        eng.submit(("churn", i), u, y_teacher=yt)
        eng.flush()
        eng.decode_step({("churn", i): u[0]})
    assert eng.store.tier_of("fb") == "cold"
    np.testing.assert_array_equal(
        _np(eng.decode_closed_loop(4, sids=["fb"])["fb"]),
        _np(ref.decode_closed_loop(4, sids=["fb"])["fb"]))


def test_8_slot_paged_engine_serves_64_sessions_like_manual_parking():
    """An 8-slot paged engine serves a 64-session rotation with no state
    handling by the caller, bit-equal to the workflow where the caller
    releases, holds and resubmits states through an engine of the same
    width."""
    _, _, tp, tr = _models()
    slots, gen = 8, 4
    prompts = _prompts(64, stride=7)
    sids = list(prompts)
    groups = [sids[i:i + slots] for i in range(0, 64, slots)]
    eng = ReservoirEngine(tp, slots, readout=tr, park_host_rows=2 * slots,
                          cold_dir=_cold(), device="cpu")
    for sid in sids:
        eng.submit(sid, prompts[sid])
    eng.flush()
    for sid in sids:
        eng.observe(sid, prompts[sid][-1] * 0.5)
    ref = ReservoirEngine(tp, slots, readout=tr, device="cpu")
    parked = {}
    for grp in groups:
        for sid in grp:
            ref.submit(sid, prompts[sid])
        ref.flush()
        for sid in grp:
            ref.observe(sid, prompts[sid][-1] * 0.5)
            parked[sid] = tuple(_np(a) for a in ref.release(sid))
    for _ in range(2):
        for grp in groups:
            a = eng.decode_closed_loop(gen, sids=grp)
            for sid in grp:
                ref.submit(sid, h0=parked[sid][0], y0=parked[sid][1])
            ref.flush()
            b = ref.decode_closed_loop(gen, sids=grp)
            for sid in grp:
                np.testing.assert_array_equal(_np(a[sid]), _np(b[sid]))
                parked[sid] = tuple(_np(v) for v in ref.release(sid))
    st_ = eng.stats()
    assert st_.promote_waves > 0 and st_.demote_waves > 0


def _churn(eng, prompts, rounds=16, grp=8):
    """The JAX benchmark's pipeline.overlap churn
    (``benchmarks/serve_engine.py:498-556``): each round admits a fresh
    group; every 4th round decodes it for 4 tokens.  Returns the tokens."""
    toks = {}
    for r in range(rounds):
        for i in range(grp):
            eng.submit((r, i), prompts[(r * grp + i) % len(prompts)])
        eng.flush()
        if r % 4 == 3:
            eng.decode_closed_loop(4, sids=[(r, i) for i in range(grp)])
            toks.update({k: _np(v) for k, v in eng.collect_decoded().items()})
    eng.store.drain_io()
    return toks


def test_pipelined_churn_bit_equal_and_overlap_count_matches_jax():
    """The overlap churn (32 slots, 64 host rows, a cold dir, 16 rounds of
    8 fresh prompts): the pipelined engine with the I/O lane gives the
    synchronous engine's tokens and states bit for bit, and takes the
    overlap-demote fast path exactly as often as the JAX engine."""
    jp, jr, tp, tr = _models()
    prompts = [SIG[20 * i:20 * i + 32, None] for i in range(24)]
    kw = dict(readout=tr, park_host_rows=64, device="cpu")
    pipe = ReservoirEngine(tp, 32, pipeline_depth=2, cold_dir=_cold(), **kw)
    sync = ReservoirEngine(tp, 32, pipeline_depth=0, cold_dir=_cold(), **kw)
    assert pipe.store.io_workers == 2 and sync.store.io_workers == 0
    a, b = _churn(pipe, prompts), _churn(sync, prompts)
    assert a.keys() == b.keys()
    for sid in a:
        np.testing.assert_array_equal(a[sid], b[sid])
    for r in range(16):
        for i in range(8):
            np.testing.assert_array_equal(pipe.state_of((r, i)),
                                          sync.state_of((r, i)))
    je = JaxEngine(jp, max_slots=32, readout=jr, park_host_rows=64,
                   pipeline_depth=2, cold_dir=_cold())
    _churn(je, prompts)
    got = pipe.stats().overlap_demotes
    assert got > 0 and got == je.stats().overlap_demotes
    assert sync.stats().overlap_demotes == 0
    assert pipe.stats().demote_waves == je.stats().demote_waves


def test_pipelined_mixed_workload_bit_equal():
    """Oversubscribed admission, chunked prompts, interleaved decode waves,
    open-loop steps and teacher forcing on a paged engine: pipelined and
    synchronous agree on every output and every state, bit for bit; a
    decode of a parked session promotes while waves are in flight, and a
    release of a session whose wave is in flight returns its state."""
    _, _, tp, tr = _models()
    kw = dict(readout=tr, park_host_rows=6, chunk_max=64,
              decode_slo_us=50_000.0, device="cpu")
    pipe = ReservoirEngine(tp, 4, pipeline_depth=2, cold_dir=_cold(), **kw)
    sync = ReservoirEngine(tp, 4, pipeline_depth=0, cold_dir=_cold(), **kw)
    prompts = {f"s{i}": SIG[30 + 17 * i:30 + 17 * i + 40 + 8 * (i % 3), None]
               for i in range(10)}
    rec = []
    for eng in (pipe, sync):
        out = []
        for sid, u in prompts.items():
            eng.submit(sid, u)
        o1 = eng.flush(want_outputs=True)
        out += [_np(o1[s]) for s in sorted(o1)]
        assert "s0" in eng.parked_sessions
        d = eng.decode_closed_loop(5, sids=["s0", "s7"])
        out += [_np(d["s0"]), _np(d["s7"])]
        out.append(eng.decode_step({"s3": SIG[200:201]})["s3"])
        eng.observe("s3", SIG[201:202])
        for i in range(10, 16):
            eng.submit(f"s{i}", SIG[10 * i:10 * i + 33, None])
        o2 = eng.flush(want_outputs=True)
        out += [_np(o2[s]) for s in sorted(o2)]
        out += [_np(v) for v in eng.release("s12")]
        out += [eng.state_of(f"s{i}") for i in range(16) if i != 12]
        rec.append(out)
    assert len(rec[0]) == len(rec[1])
    for x, y in zip(*rec):
        np.testing.assert_array_equal(x, y)
    assert pipe.stats().pipeline_inflight_peak >= 1


_OPS = st.lists(st.one_of(
    st.tuples(st.just("touch"), st.integers(0, 7)),
    st.tuples(st.just("submit"), st.integers(8, 19)),
    st.tuples(st.just("evict"), st.integers(0, 19))), min_size=1,
    max_size=20)


@settings(max_examples=6, deadline=None)
@given(ops=_OPS)
def test_lru_demotion_matches_pure_python_model(ops):
    """Random submit / touch / evict traffic: the hot / parked split follows
    a pure-python LRU model at every step."""
    _, _, tp, tr = _models()
    slots = 3
    eng = ReservoirEngine(tp, slots, readout=tr, park_host_rows=8,
                          cold_dir=_cold(), device="cpu")
    hot, parked = [], set()

    def demote_for_room():
        while len(hot) >= slots:
            parked.add(hot.pop(0))

    for i in range(slots):
        eng.submit(("w", i), SIG[50:66, None])
        eng.flush()
        hot.append(("w", i))
    alive = set(hot)
    for op, k in ops:
        sid = ("n", k) if op == "submit" or k >= 3 else ("w", k)
        if op == "submit":
            if sid in alive:
                continue
            eng.submit(sid, SIG[50:66, None])
            eng.flush()
            demote_for_room()
            hot.append(sid)
            alive.add(sid)
        elif sid not in alive:
            continue
        elif op == "touch":
            eng.decode_step({sid: SIG[66, None][0]})
            if sid in parked:
                parked.discard(sid)
                demote_for_room()
            else:
                hot.remove(sid)
            hot.append(sid)
        else:
            eng.evict(sid)
            alive.discard(sid)
            parked.discard(sid)
            if sid in hot:
                hot.remove(sid)
        assert set(eng.active_sessions) == set(hot)
        assert set(eng.parked_sessions) == parked


# ------------------------------------------------------------ guard rails
def test_evict_returns_uncollected_tokens_hot_and_parked():
    _, _, tp, tr = _models()
    eng = ReservoirEngine(tp, 2, readout=tr, device="cpu")
    eng.submit("a", SIG[50:66, None])
    eng.flush()
    eng.decode_closed_loop(5, sids=["a"])
    res = eng.evict("a")
    state, y_prev = res
    assert state.shape == (24,) and y_prev.shape == (1,)
    assert res.decoded.tokens["a"].shape == (5, 1)
    assert "a" not in eng.collect_decoded().tokens

    eng = ReservoirEngine(tp, 2, readout=tr, park_host_rows=4, device="cpu")
    for i in range(4):
        eng.submit(f"s{i}", SIG[50 + i:66 + i, None])
    eng.flush()
    eng.observe("s0", SIG[66, None])
    eng.decode_closed_loop(3, sids=["s0"])
    for i in (1, 2, 3):
        eng.observe(f"s{i}", SIG[66, None])
        eng.decode_closed_loop(1, sids=[f"s{i}"])
    assert "s0" in eng.store
    want = eng.state_of("s0")
    res = eng.evict("s0")
    assert res.decoded.tokens["s0"].shape == (3, 1)
    np.testing.assert_array_equal(res.state, want)
    assert "s0" not in eng.store and "s0" not in eng.sessions
    with pytest.raises(KeyError, match="already admitted"):
        eng.submit("s1", SIG[:16, None])          # parked sids stay taken


def test_paging_guard_rails_as_jax():
    _, _, tp, tr = _models()
    with pytest.raises(ValueError, match="park_host_rows"):
        ReservoirEngine(tp, 2, readout=tr, cold_dir=_cold(), device="cpu")
    batch = stack_params([tp, tp])
    with pytest.raises(ValueError, match="param"):
        ReservoirEngine.from_param_batch(
            batch, Readout(torch.stack([tr.w_out, tr.w_out])),
            park_host_rows=4, device="cpu")
    eng = ReservoirEngine(tp, 1, readout=tr, park_host_rows=1, device="cpu")
    for i in range(2):
        eng.submit(f"s{i}", SIG[50:66, None])
        eng.flush()
    eng.submit("s2", SIG[50:66, None])
    with pytest.raises(RuntimeError, match="cold"):
        eng.flush()
    eng.reset()
    assert not eng.parked_sessions and eng.stats().sessions_parked == 0
