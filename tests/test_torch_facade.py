"""Port parity: the ``LinearESN`` facade, the pure ``generate``, Theorem 5
and the multi-alpha / streaming ridge against ``repro.core``.

Builders and Theorem 5 agree to float64 rounding (1e-12).  Ridge readouts
are held to 1e-5 relative: JAX's and PyTorch's Cholesky and eigh round
these ill-conditioned systems differently (ROADMAP C3).  Closed-loop
trajectories start from the JAX readout carried over, so they isolate the
recurrence and are held to 1e-9.  The JAX package's ``jax.jit`` cases
(``test_jit_run_matches_facade_method``, ``test_jit_predict_matches_facade_
method`` in ``tests/test_params_api.py``) have no counterpart — PyTorch runs
eagerly — and become "facade method == pure function" cases here; its
``jax.vmap`` cases run the stacked struct directly (per-row coefficients)
or loop over the batch.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import esn as jesn
from repro.core import params as jparams
from repro.core import ridge as jridge
from repro_torch.core import esn as tesn
from repro_torch.core import params as tparams
from repro_torch.core import ridge as tridge
from repro_torch.data.signals import mso_series
from repro_torch.serve.engine import ReservoirEngine

BIT_TOL = dict(rtol=1e-12, atol=1e-12)
TRAJ_TOL = dict(rtol=1e-9, atol=1e-9)
FIT_TOL = dict(rtol=1e-5, atol=1e-8)

CFGS = {
    "plain": dict(n=40, spectral_radius=0.9, leak=0.8, input_scaling=0.5,
                  ridge_alpha=1e-6, seed=7),
    "fb": dict(n=32, spectral_radius=0.9, leak=0.8, input_scaling=0.5,
               use_feedback=True, feedback_scaling=0.2, ridge_alpha=1e-6,
               seed=5),
}
BUILDERS = ("standard", "diagonalized", "dpg")


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _xy(t=600, k=3):
    sig = mso_series(k, t + 1)
    return sig[:-1, None], sig[1:, None]


def _pair(builder, cfg_name="plain", **over):
    """The same facade model built by both packages."""
    kw = {**CFGS[cfg_name], **over}
    jc, tc = jparams.ESNConfig(**kw), tparams.ESNConfig(**kw)
    if builder == "dpg":
        return (jesn.LinearESN.dpg(jc, sigma=0.1),
                tesn.LinearESN.dpg(tc, sigma=0.1, device="cpu"))
    return (getattr(jesn.LinearESN, builder)(jc),
            getattr(tesn.LinearESN, builder)(tc, device="cpu"))


def _carry(jm, tm):
    """Give the port model the JAX model's readout."""
    tm.w_out = np.asarray(jm.w_out)
    return tm


# ----------------------------------------------------------------- builders
@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("cfg_name", sorted(CFGS))
def test_facade_builders_match_jax(builder, cfg_name):
    jm, tm = _pair(builder, cfg_name)
    assert tm.mode == jm.mode and tm.cfg.n == jm.cfg.n
    names = (("w", "w_in", "w_fb") if jm.mode == "standard"
             else ("lam_q", "win_q", "wfb_q", "qtq"))
    for name in names:
        jv, tv = getattr(jm, name), getattr(tm, name)
        assert (jv is None) == (tv is None), name
        if jv is not None:
            np.testing.assert_allclose(_np(tv), np.asarray(jv), **BIT_TOL)
    for raw in ("w_raw", "w_in_raw", "w_fb_raw"):
        jv, tv = getattr(jm, raw), getattr(tm, raw)
        assert (jv is None) == (tv is None), raw
        if jv is not None:
            np.testing.assert_array_equal(tv, jv)
    if jm.mode == "diag":
        assert tm.n_real == jm.n_real
        np.testing.assert_allclose(tm.basis.q(), jm.basis.q(), **BIT_TOL)
    assert tm.readout is None and tm.w_out is None


# ------------------------------------------------------ fit / predict / gen
@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("cfg_name", sorted(CFGS))
def test_facade_fit_predict_generate_match_jax(builder, cfg_name):
    u, y = _xy()
    jm, tm = _pair(builder, cfg_name)
    fb = jm.cfg.use_feedback
    yt = y[:400] if fb else None
    jm.fit(u[:400], y[:400], washout=50)
    tm.fit(u[:400], y[:400], washout=50)
    w_j = np.asarray(jm.w_out)
    np.testing.assert_allclose(_np(tm.w_out), w_j,
                               atol=FIT_TOL["rtol"] * np.abs(w_j).max())
    np.testing.assert_allclose(_np(tm.predict(u[:400], y_teacher=yt)),
                               np.asarray(jm.predict(u[:400], y_teacher=yt)),
                               **FIT_TOL)
    # Trajectories from the same readout: the recurrence alone.
    _carry(jm, tm)
    yw = y[:300] if fb else None
    np.testing.assert_allclose(_np(tm.run(u[:300], y_teacher=yw)),
                               np.asarray(jm.run(u[:300], y_teacher=yw)),
                               **BIT_TOL)
    got = tm.generate(64, u[:300], y[:300])
    want = jm.generate(64, u[:300], y[:300])
    assert got.shape == (64, 1)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TRAJ_TOL)
    # The facade's methods are the pure functions on its structs.
    np.testing.assert_array_equal(
        _np(tesn.generate(tm.params, tm.readout, 64, u[:300], y[:300])),
        _np(got))
    np.testing.assert_array_equal(
        _np(tesn.predict(tm.params, tm.readout, u[:300], y_teacher=yw)),
        _np(tm.predict(u[:300], y_teacher=yw)))


def test_facade_ewt_from_matches_jax_and_equals_standard():
    """EWT: the transplanted readout equals JAX's (from the same standard
    readout) and the diagonal model then predicts what the standard one
    does — the paper's EWT equivalence, inside the port."""
    u, y = _xy()
    jstd, tstd = _pair("standard")
    jstd.fit(u[:400], y[:400], washout=50)
    _carry(jstd, tstd)
    jd, td = _pair("diagonalized")
    jd.ewt_from(jstd)
    td.ewt_from(tstd)
    np.testing.assert_allclose(_np(td.w_out), np.asarray(jd.w_out),
                               **BIT_TOL)
    np.testing.assert_allclose(_np(td.predict(u)), _np(tstd.predict(u)),
                               rtol=1e-8, atol=1e-8)
    with pytest.raises(ValueError, match="diagonal model"):
        tstd.ewt_from(tstd)


def test_eet_equals_standard_ridge_plus_ewt():
    """EET (fit in the eigenbasis) and standard ridge + EWT give the same
    predictions in the port, as ``tests/test_core_esn.py`` holds in JAX."""
    u, y = _xy()
    _, tstd = _pair("standard")
    tstd.fit(u[:400], y[:400], washout=50)
    _, ewt = _pair("diagonalized")
    ewt.ewt_from(tstd)
    _, eet = _pair("diagonalized")
    eet.fit(u[:400], y[:400], washout=50)
    p = _np(tstd.predict(u))
    np.testing.assert_allclose(_np(eet.predict(u)), p, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(ewt.predict(u)), p, rtol=1e-8, atol=1e-8)


def test_w_out_setter_and_unfit_model():
    _, tm = _pair("dpg")
    with pytest.raises(ValueError, match="fit"):
        tm.predict(np.zeros((4, 1)))
    tm.w_out = np.ones((tm.cfg.n_features, 1))
    assert isinstance(tm.readout, tparams.Readout)
    assert tm.w_out.dtype == torch.float64 and tm.w_out.device == tm.device
    tm.w_out = None
    assert tm.readout is None


def test_generate_rejects_non_square_io():
    cfg = tparams.ESNConfig(**{**CFGS["plain"], "d_in": 2})
    params = tesn.diag_params(cfg, device="cpu")
    ro = tparams.Readout(torch.zeros((cfg.n_features, 1),
                                     dtype=torch.float64))
    with pytest.raises(ValueError, match="d_in == d_out"):
        tesn.generate(params, ro, 5, np.zeros((10, 2)), np.zeros((10, 1)))


def test_engine_takes_a_linear_esn():
    """``ReservoirEngine(LinearESN)`` serves the facade's params and readout
    (JAX ``_coerce_model``), matching the JAX engine built the same way."""
    u, y = _xy()
    jm, tm = _pair("dpg")
    jm.fit(u[:400], y[:400], washout=50)
    _carry(jm, tm)
    outs = []
    for eng in (ReservoirEngine(tm, 2, device="cpu"),
                __import__("repro.serve.engine",
                           fromlist=["ReservoirEngine"]).ReservoirEngine(
                    jm, 2)):
        eng.submit("s", u[:120])
        eng.flush()
        outs.append((_np(eng.decode_step({"s": u[120]})["s"]),
                     _np(eng.decode_closed_loop(16)["s"])))
    for g, w in zip(*outs):
        np.testing.assert_allclose(g, w, **TRAJ_TOL)
    with pytest.raises(ValueError, match="LinearESN"):
        ReservoirEngine(object(), 2, device="cpu")


# ---------------------------------------------------------------- Theorem 5
@pytest.mark.parametrize("builder", ("diagonalized", "dpg"))
@pytest.mark.parametrize("method", ("sequential", "associative", "chunked"))
def test_theorem5_matches_jax(builder, method):
    """R(t) (W_in-free states) and r(t) = sum_d W_in,d (.) R_d(t) against
    JAX at 1e-12, and r(t) against the ordinary run."""
    u = np.random.default_rng(0).normal(size=(150, 2))
    jm, tm = _pair(builder, d_in=2)
    r_t = tm.collect_r_states(u, method=method)
    r_j = jm.collect_r_states(u, method=method)
    assert tuple(r_t.shape) == (150, 2, tm.cfg.n)
    np.testing.assert_allclose(_np(r_t), np.asarray(r_j), **BIT_TOL)
    s_t = tm.states_from_r(r_t)
    np.testing.assert_allclose(_np(s_t), np.asarray(jm.states_from_r(r_j)),
                               **BIT_TOL)
    np.testing.assert_allclose(_np(s_t), _np(tm.run(u, method=method)),
                               **BIT_TOL)


# -------------------------------------------------------------------- ridge
def _gram_pair(seed=0, t=700, n=30, d=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, n))
    y = rng.normal(size=(t, d))
    return x, y


@pytest.mark.parametrize("chunk", (64, 700, 4096))
def test_gram_streaming_equals_gram(chunk):
    x, y = _gram_pair()
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    g, c = tridge.gram(tx, ty)
    gs, cs = tridge.gram_streaming(tx, ty, chunk=chunk)
    np.testing.assert_allclose(_np(gs), _np(g), **BIT_TOL)
    np.testing.assert_allclose(_np(cs), _np(c), **BIT_TOL)
    jg, jc = jridge.gram_streaming(x, y, chunk=chunk)
    np.testing.assert_allclose(_np(gs), np.asarray(jg), **BIT_TOL)
    np.testing.assert_allclose(_np(cs), np.asarray(jc), **BIT_TOL)


ALPHAS = [1e-8, 1e-6, 1e-4, 1e-2, 1.0]


def test_ridge_solve_multi_matches_jax_and_single_solves():
    x, y = _gram_pair(1)
    g, c = x.T @ x, x.T @ y
    got = tridge.ridge_solve_multi(torch.as_tensor(g), torch.as_tensor(c),
                                   ALPHAS)
    want = jridge.ridge_solve_multi(g, c, ALPHAS)
    assert tuple(got.shape) == (len(ALPHAS), 30, 2)
    for a, w_t, w_j in zip(ALPHAS, _np(got), np.asarray(want)):
        np.testing.assert_allclose(w_t, w_j, rtol=1e-5,
                                   atol=1e-5 * np.abs(w_j).max())
        single = _np(tridge.ridge_solve(torch.as_tensor(g),
                                        torch.as_tensor(c), a))
        np.testing.assert_allclose(w_t, single, rtol=1e-5,
                                   atol=1e-5 * np.abs(single).max())


def test_ridge_solve_general_multi_matches_jax_and_single_solves():
    """The EET metric blockdiag(I, Q^T Q) of a real diagonal model."""
    u, y = _xy()
    jm, tm = _pair("diagonalized")
    x = _np(tesn.features(tm.params, tm.run(u[:400])))[50:]
    g, c = x.T @ x, x.T @ y[50:400]
    m = _np(tesn.eet_metric(tm.params))
    got = tridge.ridge_solve_general_multi(*map(torch.as_tensor, (g, c, m)),
                                           ALPHAS[2:])
    want = jridge.ridge_solve_general_multi(g, c, m, ALPHAS[2:])
    for a, w_t, w_j in zip(ALPHAS[2:], _np(got), np.asarray(want)):
        np.testing.assert_allclose(w_t, w_j, rtol=1e-5,
                                   atol=1e-5 * np.abs(w_j).max())
        single = _np(tridge.ridge_solve_general(
            *map(torch.as_tensor, (g, c, m)), a))
        np.testing.assert_allclose(w_t, single, rtol=1e-5,
                                   atol=1e-5 * np.abs(single).max())


# --------------------------------------------------------- param batches
def _batch(builder=jesn.dpg_params, tbuilder=tesn.dpg_params, b=3):
    base = jparams.ESNConfig(**CFGS["plain"])
    jb = [builder(dataclasses.replace(base, seed=100 + i)) for i in range(b)]
    tb = [tbuilder(tparams.ESNConfig(**{**CFGS["plain"], "seed": 100 + i}),
                   device="cpu") for i in range(b)]
    return jb, tb


@pytest.mark.parametrize("method", ("auto", "sequential", "associative",
                                    "chunked"))
def test_run_over_param_batch_matches_jax_vmap(method):
    """``tests/test_params_api.py::test_vmap_run_over_param_batch_matches_
    loop``: the stacked struct runs directly (one scan, a row of
    coefficients per reservoir) and equals JAX's vmap and the per-model
    loop."""
    u, _ = _xy(300)
    jb, tb = _batch()
    import jax
    want = jax.vmap(lambda p: jesn.run(p, u, method=method))(
        jparams.stack_params(jb))
    got = tesn.run(tparams.stack_params(tb), u, method=method)
    # Trajectories: the parallel scans treat a row of coefficients as
    # varying in time (a running product where JAX's per-row scan takes
    # powers), so the last bits differ.
    np.testing.assert_allclose(_np(got), np.asarray(want), **TRAJ_TOL)
    for i, p in enumerate(tb):
        np.testing.assert_allclose(_np(got[i]), _np(tesn.run(p, u,
                                                             method=method)),
                                   **TRAJ_TOL)


def test_fit_predict_over_param_batch_matches_jax_vmap():
    """``test_vmap_fit_predict_over_param_batch_matches_loop``, as a loop
    over the batch against JAX's vmapped fit and predict."""
    import jax
    u, y = _xy(400)
    jb, tb = _batch()
    fit_b = jax.vmap(lambda p: jesn.fit(p, u[:300], y[:300], washout=50,
                                        alpha=1e-4))
    stacked = jparams.stack_params(jb)
    ro_b = fit_b(stacked)
    pred_b = jax.vmap(lambda p, r: jesn.predict(p, r, u))(stacked, ro_b)
    for i, p in enumerate(tb):
        ro = tesn.fit(p, u[:300], y[:300], washout=50, alpha=1e-4)
        w_j = np.asarray(ro_b.w_out[i])
        np.testing.assert_allclose(_np(ro.w_out), w_j, rtol=1e-5,
                                   atol=1e-5 * np.abs(w_j).max())
        np.testing.assert_allclose(_np(tesn.predict(p, ro, u)),
                                   np.asarray(pred_b[i]), **FIT_TOL)
