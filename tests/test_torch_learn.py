"""Port parity: learn-while-serving (``serve/learn.py``) against the JAX
package, on ``tests/test_learn_serve.py``'s and
``tests/test_learn_properties.py``'s cases at n = 24-32.

The JAX model (standard fit, then EWT into the diagonalized model) is
carried into the port with ``params_from_numpy`` / ``readout_from_numpy``,
so both engines serve the same reservoir and readout and see the same
seeded numpy streams.  Tolerances:

* a streamed refit equals the offline ``fit`` of the concatenated teacher
  stream to 1e-5 (the JAX package's bar, in both packages), and the JAX
  engine's refit to 1e-5 of the largest |w|; the accumulated ``(G, C)``
  agree with the JAX engine's to 1e-9 relative;
* the λ-decayed fold equals the offline decayed Gram to 1e-8 at any split;
* decoded outputs and snapshot continuations across the packages 1e-9;
* tenant isolation is bit for bit inside the port (the port contracts a
  shared readout and a per-slot pool the same way, row by row): refitting
  tenant A moves no bit of tenant B, over the JAX package's hypothesis
  strategy and the example its own engine fails (ROADMAP C2).  Before the
  refit the port agrees with the JAX engine to 1e-12; after it, with the
  JAX twin that never refit (whose contraction never switched).
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings, strategies as st

from repro.core import esn as jesn
from repro.core import ridge as jridge
from repro.core.esn import ESNConfig as JaxConfig
from repro.core.esn import LinearESN as JaxESN
from repro.data.signals import mso_series
from repro.serve import ReservoirEngine as JaxEngine
from repro_torch.core import esn as tesn
from repro_torch.core import params as tparams
from repro_torch.core import ridge as tridge
from repro_torch.serve.engine import EngineStats, ReservoirEngine
from repro_torch.serve.learn import LearnPlane

SIG = mso_series(3, 401)
U, Y = SIG[:-1, None], SIG[1:, None]
TOL = dict(rtol=1e-9, atol=1e-9)
SET = settings(max_examples=6, deadline=None, derandomize=True)
_MODELS: dict = {}


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _close_rel(got, want, rel):
    np.testing.assert_allclose(
        _np(got), _np(want), rtol=0,
        atol=rel * max(1.0, float(np.abs(_np(want)).max())))


def _pair(use_fb=True, mode="diag", n=32, seed=7, t=401, fit_t=200):
    """(JAX LinearESN, port params, port readout): the JAX model as the
    JAX learn tests build it, carried into the port."""
    key = (use_fb, mode, n, seed, t, fit_t)
    if key not in _MODELS:
        cfg = JaxConfig(n=n, d_in=1, d_out=1, spectral_radius=0.9, leak=0.8,
                        input_scaling=0.5, ridge_alpha=1e-4, seed=seed,
                        use_feedback=use_fb)
        sig = mso_series(3, t)
        std = JaxESN.standard(cfg).fit(sig[:fit_t, None],
                                       sig[1:fit_t + 1, None],
                                       washout=50 if fit_t == 200 else 40)
        jm = std if mode == "standard" else \
            JaxESN.diagonalized(cfg).ewt_from(std)
        jp = jm.params
        names = (("w", "w_in", "w_fb") if jp.mode == "standard"
                 else ("lam_q", "win_q", "wfb_q", "qtq"))
        arrays = {k: None if getattr(jp, k) is None
                  else np.asarray(getattr(jp, k)) for k in names}
        tp = tparams.params_from_numpy(
            jp.mode, arrays, dataclasses.asdict(jp.cfg),
            n_real=getattr(jp, "n_real", None), device="cpu")
        tr = tparams.readout_from_numpy(np.asarray(jm.readout.w_out),
                                        device="cpu")
        _MODELS[key] = (jm, tp, tr)
    return _MODELS[key]


def _port(tp, tr, max_slots=2, **kw):
    return ReservoirEngine(tp, max_slots, readout=tr, device="cpu", **kw)


def _stream(eng, sid, start, stop, u=U, y=Y, noise=None):
    for t in range(start, stop):
        eng.decode_step({sid: u[t]})
        truth = y[t] if noise is None else y[t] + noise[t]
        eng.observe(sid, truth)


def _admit(eng, sid, p, use_fb, tenant=None, off=0):
    eng.submit(sid, U[off:off + p], Y[off:off + p] if use_fb else None,
               tenant=tenant)
    eng.flush()


def test_learn_plane_imports_one_way():
    """The port's learn plane keeps the JAX plane's layering: it imports
    ``core`` and ``serve.arena`` only — never the exec or ingest planes or
    the facade (``tests/test_serving_planes.py``'s rule for the JAX
    package)."""
    import re
    from pathlib import Path
    src = (Path(tesn.__file__).parents[1] / "serve" / "learn.py").read_text()
    for mod in ("ingest", "exec_plane", "engine", "store", "scheduler"):
        assert not re.search(rf"^(from|import)\s+[.\w]*\b{mod}\b", src,
                             re.MULTILINE), mod
    assert "from . import arena" in src


# ------------------------------------------------------ streaming refit
@pytest.mark.parametrize("use_fb,mode", [(True, "diag"), (False, "diag"),
                                         (True, "standard"),
                                         (False, "standard")])
def test_streaming_refit_matches_offline_fit_and_the_jax_engine(use_fb,
                                                                mode):
    jm, tp, tr = _pair(use_fb, mode)
    p = 60
    engines = {"port": _port(tp, tr, learn=True, refit_washout=0),
               "jax": JaxEngine(jm, max_slots=2, learn=True,
                                refit_washout=0)}
    for eng in engines.values():
        _admit(eng, "s", p, use_fb)
        _stream(eng, "s", p, len(U))
    acc = {k: e._learn_state["s"].acc for k, e in engines.items()}
    assert len(acc["port"].buf_h) == len(acc["jax"].buf_h) == len(U) - p
    engines["port"]._learn_plane._fold_acc(acc["port"], tp)
    engines["jax"]._fold_acc(acc["jax"], jm.params)
    _close_rel(acc["port"].gram, acc["jax"].gram, 1e-9)
    _close_rel(acc["port"].cg, acc["jax"].cg, 1e-9)
    w = _np(engines["port"].refit()["s"])
    np.testing.assert_allclose(w, _np(tesn.fit(tp, U, Y, washout=p).w_out),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        w, np.asarray(jesn.fit(jm.params, U, Y, washout=p).w_out),
        rtol=0, atol=1e-5)
    _close_rel(w, engines["jax"].refit()["s"], 1e-5)
    # the refit readout is live: the engine serves it on the next step
    np.testing.assert_array_equal(_np(engines["port"].readout_for("s")), w)


def test_refit_needs_learn_mode():
    _, tp, tr = _pair()
    eng = _port(tp, tr, max_slots=1)
    _admit(eng, "s", 60, True)
    with pytest.raises(ValueError, match="learn=True"):
        eng.refit("s")
    with pytest.raises(ValueError, match="learn=True"):
        eng.flush(refit=True)
    with pytest.raises(KeyError):
        _port(tp, tr, max_slots=1, learn=True).refit("ghost")
    with pytest.raises(ValueError, match="base readout"):
        ReservoirEngine(tp, 1, learn=True, device="cpu")
    for kw, msg in ((dict(refit_decay=0.0), "refit_decay"),
                    (dict(refit_washout=-1), "refit_washout"),
                    (dict(drift_threshold=0.0), "drift_threshold"),
                    (dict(drift_beta=1.0), "drift_beta")):
        with pytest.raises(ValueError, match=msg):
            _port(tp, tr, learn=True, **kw)


def test_flush_refit_true_refits_dirty_sessions_as_the_jax_engine():
    jm, tp, tr = _pair()
    port = _port(tp, tr, learn=True)
    jax_eng = JaxEngine(jm, max_slots=2, learn=True)
    for eng in (port, jax_eng):
        _admit(eng, "s", 60, True)
        _stream(eng, "s", 60, 200)
        assert eng.stats().sessions_dirty == 1
        eng.flush(refit=True)
        st = eng.stats()
        assert st.sessions_dirty == 0
        assert st.refit_waves_total == 1 and st.refit_rows_total == 1
    _close_rel(port.readout_for("s"), jax_eng.readout_for("s"), 1e-5)
    assert port.cost_model is not None          # a learn engine prices refits


# ------------------------------------------------------- the decayed fold
def _decayed_ref(params, run, features, gram_streaming, t_end, p, lam, xp):
    states = run(params, U[:t_end])
    x = features(params, states)[p:]
    m = x.shape[0]
    w = lam ** (xp.arange(m - 1, -1, -1, dtype=x.dtype) / 2.0)
    yt = xp.asarray(Y[p:t_end])
    return gram_streaming(x * w[:, None], yt * w[:, None])


@SET
@given(seed=st.integers(0, 50), lam=st.floats(0.9, 0.999),
       split=st.integers(80, 260))
@example(seed=7, lam=0.97, split=200)
def test_decayed_fold_matches_offline_decayed_weights_at_any_split(
        seed, lam, split):
    """Folding two windows split anywhere carries exactly the weights one
    decayed offline fit over the whole stream uses — against the port's
    offline Gram and the JAX package's — and never shrinks the decayed
    Gram's diagonal below the decayed first window."""
    jm, tp, tr = _pair(False, seed=seed, n=24, t=301, fit_t=150)
    p, t_end = 60, 280
    split = min(max(split, p + 1), t_end - 1)
    eng = _port(tp, tr, max_slots=1, learn=True, refit_washout=0,
                refit_decay=lam)
    _admit(eng, "s", p, False)
    _stream(eng, "s", p, split)
    eng.refit("s")
    g1 = _np(eng._learn_state["s"].acc.gram).copy()
    _stream(eng, "s", split, t_end)
    acc = eng._learn_state["s"].acc
    eng._learn_plane._fold_acc(acc, tp)
    for ref in (
            _decayed_ref(tp, tesn.run, tesn.features, tridge.gram_streaming,
                         t_end, p, lam, torch),
            _decayed_ref(jm.params, jesn.run, jesn.features,
                         jridge.gram_streaming, t_end, p, lam, np)):
        np.testing.assert_allclose(_np(acc.gram), _np(ref[0]), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(_np(acc.cg), _np(ref[1]), rtol=0,
                                   atol=1e-8)
    m2 = t_end - split
    floor = (lam ** m2) * np.diag(g1)
    assert (np.diag(_np(acc.gram)) >= floor - 1e-10).all()


def test_batched_fold_equals_one_fold_per_session():
    """A refit wave folds same-length windows in ONE batched Gram (the JAX
    package's vmap): equal to folding each session alone."""
    _, tp, tr = _pair(False)
    eng = _port(tp, tr, max_slots=3, learn=True, refit_decay=0.99)
    for i, sid in enumerate("abc"):
        _admit(eng, sid, 60 + i, False, off=i)
    for t in range(70, 150):
        eng.decode_step({s: U[t + i] for i, s in enumerate("abc")})
        for i, s in enumerate("abc"):
            eng.observe(s, Y[t + i])
    ln = eng._learn_plane
    alone = {}
    for sid in "abc":
        acc = dataclasses.replace(ln.state[sid].acc,
                                  buf_h=list(ln.state[sid].acc.buf_h),
                                  buf_fb=list(ln.state[sid].acc.buf_fb),
                                  buf_y=list(ln.state[sid].acc.buf_y),
                                  buf_pred=[])
        ln._fold_acc(acc, tp)
        alone[sid] = acc.gram
    ln._fold_grouped(list("abc"))
    for sid in "abc":
        assert not ln.state[sid].acc.buf_h
        np.testing.assert_allclose(_np(ln.state[sid].acc.gram),
                                   _np(alone[sid]), rtol=1e-12, atol=1e-12)


def test_refit_washout_skips_leading_rows():
    jm, tp, tr = _pair(False)
    p, k = 60, 25
    eng = _port(tp, tr, max_slots=1, learn=True, refit_washout=k)
    _admit(eng, "s", p, False)
    _stream(eng, "s", p, len(U))
    w = _np(eng.refit()["s"])
    np.testing.assert_allclose(
        w, np.asarray(jesn.fit(jm.params, U, Y, washout=p + k).w_out),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        w, _np(tesn.fit(tp, U, Y, washout=p + k).w_out), rtol=0, atol=1e-5)


def test_interrupted_teacher_stream_pairs_as_the_jax_engine():
    """Rows pair only when exactly ONE decode step separates consecutive
    teacher events; the port buffers the same rows as the JAX engine."""
    jm, tp, tr = _pair(False)
    port = _port(tp, tr, max_slots=1, learn=True, refit_washout=0)
    jax_eng = JaxEngine(jm, max_slots=1, learn=True, refit_washout=0)
    counts = {}
    for name, eng in (("port", port), ("jax", jax_eng)):
        _admit(eng, "s", 60, False)
        _stream(eng, "s", 60, 150)
        before = len(eng._learn_state["s"].acc.buf_h)
        for t in range(150, 155):          # free-run: no observe
            eng.decode_step({"s": U[t]})
        eng.observe("s", Y[155])           # 6 steps since the last teacher
        mid = len(eng._learn_state["s"].acc.buf_h)
        eng.decode_closed_loop(3)          # free-running tokens too
        eng.observe("s", Y[156])
        _stream(eng, "s", 157, 200)
        counts[name] = (before, mid, len(eng._learn_state["s"].acc.buf_h))
    assert counts["port"] == counts["jax"]
    before, mid, after = counts["port"]
    assert mid == before and after > before
    for p_row, j_row in zip(port._learn_state["s"].acc.buf_h,
                            jax_eng._learn_state["s"].acc.buf_h):
        np.testing.assert_allclose(p_row, np.asarray(j_row), **TOL)


# ------------------------------------------------- per-tenant readout pools
def _twin(make, tenants=("A", "B")):
    eng = make()
    eng.submit("a", U[:60], Y[:60], tenant=tenants[0])
    eng.submit("b", U[:60], Y[:60], tenant=tenants[1])
    eng.flush()
    for t in range(60, 200):
        eng.decode_step({"a": U[t], "b": U[t]})
        eng.observe("a", Y[t])
        eng.observe("b", Y[t])
    eng.decode_step({"b": U[200]})
    eng.observe("b", Y[200])
    return eng


def test_tenant_refit_leaves_other_tenant_bit_exact():
    """``tests/test_learn_serve.py``'s pinned case, in the port: B's next
    step and a 6-token closed loop after A's refit are bit-equal to a twin
    that never refit A, and agree with the JAX twin to 1e-12."""
    jm, tp, tr = _pair()
    eng = _twin(lambda: _port(tp, tr, max_slots=4, learn=True))
    assert set(eng.refit("a")) == {"a"}
    ref = _twin(lambda: _port(tp, tr, max_slots=4, learn=True))
    jref = _twin(lambda: JaxEngine(jm, max_slots=4, learn=True))
    out = [_np(e.decode_step({"b": U[201]})["b"]) for e in (eng, ref, jref)]
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_allclose(out[0], out[2], rtol=0, atol=1e-12)
    loops = [_np(e.decode_closed_loop(6, sids=["b"])["b"])
             for e in (eng, ref)]
    np.testing.assert_array_equal(loops[0], loops[1])
    assert eng._exec._slot_w is not None and ref._exec._slot_w is None
    # ...and A's refit was not a no-op
    assert not np.array_equal(_np(eng.readout_for("a")),
                              _np(ref.readout_for("a")))


def _iso_admit(eng, off_a, off_b, use_fb, p=60):
    eng.submit("a", U[off_a:off_a + p], Y[off_a:off_a + p] if use_fb
               else None, tenant="A")
    eng.submit("b", U[off_b:off_b + p], Y[off_b:off_b + p] if use_fb
               else None, tenant="B")
    eng.flush()
    return eng


def _iso_run(tp, tr, off_a, off_b, use_fb, refit_a, p=60):
    eng = _iso_admit(_port(tp, tr, max_slots=4, learn=True), off_a, off_b,
                     use_fb, p)
    for t in range(p, 180):
        eng.decode_step({"a": U[off_a + t], "b": U[off_b + t]})
        eng.observe("a", Y[off_a + t])
        eng.observe("b", Y[off_b + t])
    if refit_a:
        assert set(eng.refit("a")) == {"a"}
    return eng


@SET
@given(seed=st.integers(0, 50), off_a=st.integers(0, 40),
       off_b=st.integers(0, 40), use_fb=st.booleans())
@example(seed=0, off_a=0, off_b=0, use_fb=False)
def test_tenant_isolation_is_bit_exact_over_the_jax_strategy(seed, off_a,
                                                             off_b, use_fb):
    """``tests/test_learn_properties.py``'s property, in the port, with the
    example the JAX engine fails (ROADMAP C2) pinned."""
    _, tp, tr = _pair(use_fb, seed=seed, n=24, t=301, fit_t=150)
    outs = []
    for refit_a in (True, False):
        eng = _iso_run(tp, tr, off_a, off_b, use_fb, refit_a)
        outs.append((_np(eng.decode_step({"b": U[off_b + 180]})["b"]),
                     _np(eng.decode_closed_loop(4, sids=["b"])["b"])))
    for got, want in zip(*outs):
        np.testing.assert_array_equal(got, want)


def test_isolation_example_against_the_jax_engine():
    """The recorded failing example (seed=0, off_a=0, off_b=0,
    use_fb=False): the port agrees with the JAX engine to 1e-12 while the
    JAX engine serves one readout, and after A's refit with the JAX twin
    that never refit (the JAX engine's own refit switches B's
    contraction)."""
    jm, tp, tr = _pair(False, seed=0, n=24, t=301, fit_t=150)
    port = _iso_admit(_port(tp, tr, max_slots=4, learn=True), 0, 0, False)
    jeng = _iso_admit(JaxEngine(jm, max_slots=4, learn=True), 0, 0, False)
    for t in range(60, 180):
        outs = [e.decode_step({"a": U[t], "b": U[t]}) for e in (port, jeng)]
        for s in "ab":
            np.testing.assert_allclose(_np(outs[0][s]),
                                       np.asarray(outs[1][s]),
                                       rtol=0, atol=1e-12)
        for e in (port, jeng):
            e.observe("a", Y[t])
            e.observe("b", Y[t])
    port.refit("a")
    got = _np(port.decode_step({"b": U[180]})["b"])
    want = np.asarray(jeng.decode_step({"b": U[180]})["b"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_sessions_sharing_a_tenant_share_one_readout():
    jm, tp, tr = _pair()
    port = _port(tp, tr, max_slots=4, learn=True)
    jax_eng = JaxEngine(jm, max_slots=4, learn=True)
    for eng in (port, jax_eng):
        eng.submit("a1", U[:60], Y[:60], tenant="A")
        eng.submit("a2", U[:60], Y[:60], tenant="A")
        eng.flush()
        for t in range(60, 200):
            eng.decode_step({"a1": U[t], "a2": U[t]})
            eng.observe("a1", Y[t])
            eng.observe("a2", Y[t])
        eng.refit()
    np.testing.assert_array_equal(_np(port.readout_for("a1")),
                                  _np(port.readout_for("a2")))
    _close_rel(port.readout_for("a1"), jax_eng.readout_for("a1"), 1e-5)
    out = port.decode_step({"a1": U[200], "a2": U[200]})
    np.testing.assert_array_equal(out["a1"], out["a2"])


def test_set_readout_switches_hot_and_later_sessions():
    """``set_readout`` installs a tenant readout: a hot session of that
    tenant serves it on its next step, a session admitted later gathers it
    at placement, another tenant is untouched; the JAX engine serves the
    same outputs (1e-9)."""
    jm, tp, tr = _pair()
    w_new = np.asarray(jm.readout.w_out) * 0.5
    port = _port(tp, tr, max_slots=3)
    jax_eng = JaxEngine(jm, max_slots=3)
    outs = []
    for eng in (port, jax_eng):
        eng.submit("a", U[:40], Y[:40], tenant="T")
        eng.submit("b", U[:40], Y[:40], tenant="other")
        eng.flush()
        eng.set_readout("T", w_new)
        eng.submit("c", U[:40], Y[:40], tenant="T")
        eng.flush()
        outs.append({k: _np(v) for k, v in eng.decode_step(
            {s: U[40] for s in "abc"}).items()})
    for s in "abc":
        np.testing.assert_allclose(outs[0][s], outs[1][s], **TOL)
    np.testing.assert_array_equal(outs[0]["a"], outs[0]["c"])
    np.testing.assert_array_equal(_np(port.readout_for("c")), w_new)
    np.testing.assert_array_equal(_np(port.readout_for("b")), _np(tr.w_out))
    with pytest.raises(ValueError, match="must be"):
        port.set_readout("T", np.zeros((3, 1)))


# ------------------------------------------------------- stats / release
def test_stats_typed_and_release_drop_frees_learn_state():
    _, tp, tr = _pair()
    eng = _port(tp, tr, learn=True)
    _admit(eng, "s", 60, True)
    st = eng.stats()
    assert isinstance(st, EngineStats) and st.sessions_active == 1
    assert st.refit_waves_total == 0 and st.growth_events == 0
    eng.decode_step({"s": U[60]})
    r = eng.release("s", drop=True)
    assert r.state is None and r.y_prev is None
    assert _np(r.decoded["s"]).shape[0] == 1
    assert "s" not in eng.sessions and "s" not in eng._learn_state
    eng.reset()
    assert not eng._learn_state and not eng._readouts


def test_cost_model_learns_the_refit_surface():
    _, tp, tr = _pair()
    eng = _port(tp, tr, learn=True, autotune=True)
    _admit(eng, "s", 60, True)
    _stream(eng, "s", 60, 200)
    eng.refit()
    cm = eng.cost_model
    assert cm.predict_refit_us(1) >= 1.0 and cm.predict_refit_us(0) == 0.0
    rec = [r for r in cm.records() if r.get("kind") == "refit"]
    assert rec and rec[0]["b"] == 1 and rec[0]["us"] > 0
    assert eng.stats().refit_us_sum == rec[0]["us"]


# ------------------------------------------------------- DPG growth, vote
def test_drift_grows_the_jax_member_and_it_votes():
    """Drift past the threshold grows the member the JAX engine grows (the
    same ``dpg_params`` seed, bit-equal leaves); it trains on the clean
    stream and joins the weighted vote.  Drift and the voted outputs agree
    with the JAX engine (1e-9 relative, 1e-8)."""
    jm, tp, tr = _pair()
    kw = dict(learn=True, drift_threshold=0.05, growth_washout=8,
              growth_max_members=1)
    port = _port(tp, tr, **kw)
    jax_eng = JaxEngine(jm, max_slots=2, **kw)
    noise = np.random.default_rng(0).normal(scale=1.0, size=(len(U), 1))
    votes = []
    for eng in (port, jax_eng):
        _admit(eng, "g", 60, True)
        _stream(eng, "g", 60, 150, noise=noise)
        eng.refit("g")
        assert eng.stats().growth_events == 1
        ls = eng._learn_state["g"]
        assert len(ls.members) == 1 and ls.members[0].w is None
        _stream(eng, "g", 150, 220)
        eng.refit("g")
        assert ls.members[0].w is not None
        _stream(eng, "g", 220, 250)    # the member's held-out error
        eng.refit("g")
        assert ls.members[0].acc.drift is not None
        votes.append(_np(eng.decode_step({"g": U[250]})["g"]))
        votes.append(eng.drift_rmse("g"))
    pm = port._learn_state["g"].members[0].params
    jmb = jax_eng._learn_state["g"].members[0].params
    for k in ("lam_q", "win_q", "wfb_q", "qtq"):
        np.testing.assert_array_equal(_np(getattr(pm, k)),
                                      np.asarray(getattr(jmb, k)))
    assert np.isfinite(votes[0]).all()
    np.testing.assert_allclose(votes[0], votes[2], rtol=0, atol=1e-8)
    assert votes[1] == pytest.approx(votes[3], rel=1e-9)


def test_growth_capped_at_max_members():
    _, tp, tr = _pair()
    eng = _port(tp, tr, learn=True, drift_threshold=1e-6, growth_washout=4,
                growth_max_members=1)
    _admit(eng, "g", 60, True)
    rng = np.random.default_rng(1)
    for k in range(4):                 # four drift excursions, one cap
        noise = rng.normal(scale=1.0, size=(len(U), 1))
        _stream(eng, "g", 60 + 30 * k, 90 + 30 * k, noise=noise)
        eng.refit("g")
    assert len(eng._learn_state["g"].members) == 1
    assert eng.stats().growth_events == 1


def test_vote_weights_members_by_held_out_error():
    """The vote itself: a member with a trained readout and a drift
    estimate weighs 1/(mse + 1e-6) beside the primary's."""
    _, tp, tr = _pair()
    eng = _port(tp, tr, learn=True, drift_threshold=0.05, growth_washout=8,
                growth_max_members=1)
    noise = np.random.default_rng(0).normal(scale=1.0, size=(len(U), 1))
    _admit(eng, "g", 60, True)
    _stream(eng, "g", 60, 150, noise=noise)
    eng.refit("g")
    _stream(eng, "g", 150, 220)
    eng.refit("g")
    _stream(eng, "g", 220, 250)
    eng.refit("g")
    ls = eng._learn_state["g"]
    mb = ls.members[0]
    ln: LearnPlane = eng._learn_plane
    primary = np.array([0.25])
    h_before = mb.h.clone()
    fused = ln.vote("g", U[250], primary)
    pred = _np(mb.pred_last)
    w0 = 1.0 / (ls.acc.drift + 1e-6)
    w1 = 1.0 / (mb.acc.drift + 1e-6)
    np.testing.assert_allclose(fused, (primary * w0 + pred * w1) / (w0 + w1),
                               rtol=1e-12, atol=1e-15)
    assert not torch.equal(mb.h, h_before)


# ------------------------------------------------------ snapshot round trip
def _snap(eng):
    return eng.snapshot(tempfile.mkdtemp(prefix="torch_learn_") + "/s")


def _learn_mid(eng):
    eng.submit("a", U[:60], Y[:60], tenant="A")
    eng.submit("b", U[:60], Y[:60], tenant="B")
    eng.flush()
    for t in range(60, 160):
        eng.decode_step({"a": U[t], "b": U[t]})
        eng.observe("a", Y[t])
        eng.observe("b", Y[t])
    eng.refit("a")                     # tenant A diverges: the pool is live
    eng.decode_step({"a": U[160], "b": U[160]})
    eng.observe("b", Y[160])           # b dirty, one pair buffered


def _learn_continue(eng, w_b=None):
    """Refit b, decode both sessions 9 steps (teacher-forcing a), refit a.
    ``w_b``: serve this readout for tenant B after its refit (the refits of
    two packages part by cond(G) x rounding; decodes are compared on equal
    weights).  Returns (refit readouts, decoded outputs) as numpy."""
    refits = [_np(eng.refit("b")["b"])]
    if w_b is not None:
        eng.set_readout("B", w_b)
    out = []
    for t in range(161, 170):
        o = eng.decode_step({"a": U[t], "b": U[t]})
        out += [_np(o["a"]), _np(o["b"])]
        eng.observe("a", Y[t])
    refits.append(_np(eng.refit("a")["a"]))
    return refits, out


def test_learn_snapshot_resumes_bit_equal_in_the_port():
    _, tp, tr = _pair()
    eng = _port(tp, tr, max_slots=3, learn=True, refit_decay=0.99)
    _learn_mid(eng)
    path = _snap(eng)
    res = ReservoirEngine.restore(path, device="cpu")
    assert res._learn and res._refit_decay == 0.99
    assert set(res._readouts) == {"A"} and res._learn_state["b"].dirty
    np.testing.assert_array_equal(_np(res.readout_for("a")),
                                  _np(eng.readout_for("a")))
    (wa, da), (wb, db) = _learn_continue(eng), _learn_continue(res)
    for x, y in zip(wa + da, wb + db):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_learn_snapshot_crosses_packages(direction):
    """Pools, folded (G, C) and pairing state written by one package
    restore in the other; both continue: refits agree to 1e-5 of the
    largest |w| (two Cholesky implementations), decodes on equal weights
    to 1e-9."""
    jm, tp, tr = _pair()
    if direction == "jax_to_port":
        writer = JaxEngine(jm, max_slots=3, learn=True, refit_decay=0.99)
    else:
        writer = _port(tp, tr, max_slots=3, learn=True, refit_decay=0.99)
    _learn_mid(writer)
    path = _snap(writer)
    with open(os.path.join(path, "manifest.json")) as f:
        assert '"learn": true' in f.read()
    reader = (ReservoirEngine.restore(path, device="cpu")
              if direction == "jax_to_port" else JaxEngine.restore(path))
    assert set(reader._readouts) == {"A"}
    _close_rel(reader.readout_for("a"), writer.readout_for("a"), 1e-15)
    w_ref, d_ref = _learn_continue(writer)
    w_got, d_got = _learn_continue(reader, w_b=w_ref[0])
    for x, y in zip(w_ref, w_got):
        _close_rel(y, x, 1e-5)
    for x, y in zip(d_ref, d_got):
        _close_rel(y, x, 1e-9)
