"""Port parity: readout math and the pure model functions against
``repro.core.esn`` / ``repro.core.ridge``.

States agree to float64 rounding (1e-12).  A ridge solve amplifies
rounding by its condition number: JAX's and PyTorch's Cholesky solves of
these EET systems differ by more than 1e-7 relative even at
``ridge_alpha=1e-3``, so readouts and predictions are held to 1e-5 relative
(the reservoir-parity tolerance of the ROADMAP).
"""
import jax.numpy as jnp
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

STATE_TOL = dict(rtol=1e-12, atol=1e-12)
FIT_TOL = dict(rtol=1e-5, atol=1e-8)

MODELS = {
    "dpg": dict(kw=dict(n=40, leak=0.9, ridge_alpha=1e-3, seed=1),
                build="dpg"),
    "diag-fb": dict(kw=dict(n=32, leak=0.8, use_feedback=True,
                            feedback_scaling=0.2, ridge_alpha=1e-3, seed=2),
                    build="diag"),
    "standard": dict(kw=dict(n=36, ridge_alpha=1e-3, seed=3),
                     build="standard"),
    "standard-fb-nobias": dict(kw=dict(n=24, use_feedback=True,
                                       use_bias=False, ridge_alpha=1e-3,
                                       seed=4), build="standard"),
}


def _build(name):
    m = MODELS[name]
    jc, tc = jparams.ESNConfig(**m["kw"]), tparams.ESNConfig(**m["kw"])
    if m["build"] == "dpg":
        return jesn.dpg_params(jc, sigma=0.1), tesn.dpg_params(
            tc, sigma=0.1, device="cpu")
    if m["build"] == "diag":
        return jesn.diag_params(jc), tesn.diag_params(tc, device="cpu")
    return jesn.standard_params(jc), tesn.standard_params(tc, device="cpu")


def _signal(t=600):
    sig = mso_series(3, t + 1)
    return sig[:-1, None], sig[1:, None]


RUN_CASES = [(name, method) for name in MODELS
             for method in (("auto",) if MODELS[name]["build"] == "standard"
                            else ("auto", "sequential", "associative",
                                  "chunked"))]


@pytest.mark.parametrize("name,method", RUN_CASES)
def test_run_matches_jax(name, method):
    jp, tp = _build(name)
    u, y = _signal(300)
    yt = y if jp.cfg.use_feedback else None
    want = jesn.run(jp, u, yt, method=method)
    got = tesn.run(tp, u, yt, method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STATE_TOL)
    fj = jesn.features(jp, want, y)
    ft = tesn.features(tp, got, y)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **STATE_TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_fit_predict_match_jax(name):
    jp, tp = _build(name)
    u, y = _signal(600)
    yt = y if jp.cfg.use_feedback else None
    rj = jesn.fit(jp, u, y, washout=50)
    rt = tesn.fit(tp, u, y, washout=50)
    np.testing.assert_allclose(rt.w_out.numpy(), np.asarray(rj.w_out),
                               **FIT_TOL)
    pj = jesn.predict(jp, rj, u, y_teacher=yt)
    pt = tesn.predict(tp, rt, u, y_teacher=yt)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **FIT_TOL)
    assert float(np.sqrt(np.mean((pt.numpy()[50:] - y[50:]) ** 2))) < 1e-2


def test_eet_metric_and_step_match_jax():
    jp, tp = _build("diag-fb")
    np.testing.assert_array_equal(tesn.eet_metric(tp).numpy(),
                                  np.asarray(jesn.eet_metric(jp)))
    rng = np.random.default_rng(0)
    h = rng.normal(size=(3, jp.cfg.n))
    u = rng.normal(size=(3, 1))
    yp = rng.normal(size=(3, 1))
    dj = jesn.drive(jp, jnp.asarray(u), jnp.asarray(yp))
    dt = tesn.drive(tp, torch.tensor(u), torch.tensor(yp))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **STATE_TOL)
    np.testing.assert_allclose(
        tesn.step_states(tp, torch.tensor(h), dt).numpy(),
        np.asarray(jesn.step_states(jp, jnp.asarray(h), dj)), **STATE_TOL)


def test_ewt_readout_matches_jax():
    from repro.core.esn import LinearESN
    from repro_torch.core.basis import EigenBasis
    kw = dict(n=30, ridge_alpha=1e-3, seed=7)
    u, y = _signal(400)
    std = LinearESN.standard(jparams.ESNConfig(**kw)).fit(u, y)
    dg = LinearESN.diagonalized(jparams.ESNConfig(**kw))
    want = jesn.ewt_readout(dg.basis, dg.cfg, std.readout)
    basis = EigenBasis.from_matrix(np.asarray(std.w_raw))
    got = tesn.ewt_readout(basis, tparams.ESNConfig(**kw),
                           tparams.readout_from_numpy(
                               np.asarray(std.readout.w_out), device="cpu"))
    np.testing.assert_allclose(got.w_out.numpy(), np.asarray(want.w_out),
                               **STATE_TOL)


@pytest.mark.parametrize("cplx", [False, True])
def test_ridge_solvers_match_jax(cplx):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(80, 12))
    y = rng.normal(size=(80, 2))
    if cplx:
        x = x + 1j * rng.normal(size=(80, 12))
    gj, cj = jridge.gram(jnp.asarray(x), jnp.asarray(y))
    gt, ct = tridge.gram(torch.tensor(x), torch.tensor(y, dtype=torch.tensor(
        x).dtype))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **STATE_TOL)
    np.testing.assert_allclose(
        tridge.ridge_solve(gt, ct, 1e-3).numpy(),
        np.asarray(jridge.ridge_solve(gj, cj, 1e-3)), **STATE_TOL)
    m = rng.normal(size=(12, 12))
    m = m @ m.T + 12 * np.eye(12)
    np.testing.assert_allclose(
        tridge.ridge_solve_general(gt, ct, torch.tensor(m, dtype=gt.dtype),
                                   1e-2).numpy(),
        np.asarray(jridge.ridge_solve_general(gj, cj, jnp.asarray(m), 1e-2)),
        **STATE_TOL)


def test_feedback_run_needs_teacher():
    _, tp = _build("diag-fb")
    u, _ = _signal(50)
    with pytest.raises(ValueError, match="teacher"):
        tesn.run(tp, u)
