"""Port parity: param-batched engines and ensembles against the JAX
package's ``ReservoirEngine.from_param_batch`` and ``serve.arena``.

Both packages build the same batch of reservoirs (the builders are
bit-equal) and serve it with the JAX readouts carried over, so outputs and
states agree to float64 rounding carried through the recurrence: 1e-9.
The port's batched prefill runs ONE scan with a row of coefficients per
reservoir where JAX vmaps a scan per row.  Inside the port, ensemble
reductions are checked against per-model engines (as the JAX suite does)
and the fused ``mean`` route against the step-at-a-time scan path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import esn as jesn
from repro.core import params as jparams
from repro.serve import arena as jarena
from repro.serve.engine import ReservoirEngine as JaxEngine
from repro_torch.core import esn as tesn
from repro_torch.core import params as tparams
from repro_torch.data.signals import mso_series
from repro_torch.launch import serve as tserve
from repro_torch.serve import arena as tarena
from repro_torch.serve.engine import ReservoirEngine

TOL = dict(rtol=1e-9, atol=1e-9)
CFG = dict(n=48, spectral_radius=0.9, leak=0.8, input_scaling=0.5,
           ridge_alpha=1e-8, seed=7)
SIG = mso_series(3, 801)
U, Y = SIG[:-1, None], SIG[1:, None]


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _batch(b=3, fb=False):
    """(jax stacked params, jax stacked readout, port params, port readout,
    the per-model jax structs and readouts, the port structs)."""
    kw = dict(CFG, use_feedback=fb, feedback_scaling=0.2) if fb else CFG
    jb = [jesn.dpg_params(jparams.ESNConfig(**{**kw, "seed": 100 + i}),
                          sigma=0.1) for i in range(b)]
    tb = [tesn.dpg_params(tparams.ESNConfig(**{**kw, "seed": 100 + i}),
                          sigma=0.1, device="cpu") for i in range(b)]
    assert len({p.n_real for p in jb}) == 1
    jr = [jesn.fit(p, U[:400], Y[:400], washout=50) for p in jb]
    w = np.stack([np.asarray(r.w_out) for r in jr])
    return (jparams.stack_params(jb), jparams.Readout(jnp.asarray(w)),
            tparams.stack_params(tb), tparams.Readout(torch.tensor(w)),
            jb, jr, tb)


def _engines(ensemble="off", fb=False, b=3, **kw):
    jp, jr, tp, tr, *_ = _batch(b, fb)
    return (JaxEngine.from_param_batch(jp, readout=jr, ensemble=ensemble,
                                       **kw),
            ReservoirEngine.from_param_batch(tp, tr, ensemble=ensemble,
                                             device="cpu", **kw))


def _prompts(eng, fb, lengths=(180, 100, 40)):
    for i, t in enumerate(lengths):
        lo = 30 * i
        extra = {"y_teacher": Y[lo:lo + t]} if fb else {}
        eng.submit(i, U[lo:lo + t], **extra)
    return eng.flush(want_outputs=True)


# ----------------------------------------------------- engine vs JAX engine
@pytest.mark.parametrize("ensemble", ("off", "mean", "weighted"))
@pytest.mark.parametrize("fb", (False, True), ids=("plain", "fb"))
def test_param_batched_engine_matches_jax(ensemble, fb):
    """from_param_batch on both packages: prefill outputs, open-loop steps,
    teacher forcing and the (fused) closed loop agree slot for slot."""
    je, te = _engines(ensemble, fb)
    if ensemble == "weighted":
        for e in (je, te):
            e.set_ensemble_weights([0.5, 2.0, 1.0])
    outs = [_prompts(e, fb) for e in (je, te)]
    for i in range(3):
        np.testing.assert_allclose(_np(outs[1][i]), _np(outs[0][i]), **TOL)
    rec = []
    for e in (je, te):
        got = [e.decode_step({i: U[400 + i] for i in range(3)})
               for _ in range(2)]
        e.observe(1, [0.25])
        got.append(e.decode_step({i: U[410] for i in range(3)}))
        cl = e.decode_closed_loop(25)
        rec.append(([_np(g[i]) for g in got for i in range(3)]
                    + [_np(cl[i]) for i in sorted(cl)]
                    + [_np(e.states), _np(e.y_prev)]))
    for g, w in zip(rec[1], rec[0]):
        np.testing.assert_allclose(g, w, **TOL)


def test_batched_engine_matches_individual_engines():
    """``tests/test_params_api.py``: one param-batched engine == B
    per-model engines, slot for slot (inside the port, bit for bit up to
    the batched matmul's rounding)."""
    *_, jb, jr, tb = _batch()
    _, te = _engines()
    prompts = [U[i * 30: i * 30 + 180] for i in range(3)]
    for i in range(3):
        te.submit(i, prompts[i])
    te.flush()
    got = te.decode_step({i: U[400 + i] for i in range(3)})
    got_cl = te.decode_closed_loop(25)
    assert te.param_batched and te.max_slots == 3
    for i, (p, r) in enumerate(zip(tb, jr)):
        single = ReservoirEngine(p, 1, readout=np.asarray(r.w_out),
                                 device="cpu")
        single.submit("s", prompts[i])
        single.flush()
        np.testing.assert_allclose(
            got[i], single.decode_step({"s": U[400 + i]})["s"], **TOL)
        np.testing.assert_allclose(
            _np(got_cl[i]), _np(single.decode_closed_loop(25)["s"]), **TOL)


def test_batched_engine_readmission_requires_slot_pin():
    _, te = _engines()
    for i in range(3):
        te.submit(i, U[:64])
    te.flush()
    h1, y1 = te.release(1)
    with pytest.raises(ValueError, match="slot=<original slot>"):
        te.submit("back", h0=h1, y0=y1)
    te.submit("back", h0=h1, y0=y1, slot=1)
    np.testing.assert_array_equal(te.state_of("back"), _np(h1))
    with pytest.raises(ValueError, match="occupied"):
        te.submit("clash", slot=0)
    with pytest.raises(ValueError, match="out of range"):
        te.submit("oob", slot=3)


def test_param_batch_validation():
    _, _, tp, tr, _, _, tb = _batch()
    with pytest.raises(ValueError, match="max_slots == 3"):
        ReservoirEngine(tp, 2, device="cpu", _param_batch=True)
    with pytest.raises(ValueError, match="param-batched"):
        ReservoirEngine(tb[0], 2, readout=tr.w_out[0], device="cpu",
                        ensemble="mean")
    with pytest.raises(ValueError, match="param-batched"):
        ReservoirEngine.from_param_batch(tp, ensemble="mean", device="cpu")
    with pytest.raises(ValueError, match="'off', 'mean' or 'weighted'"):
        ReservoirEngine.from_param_batch(tp, tr, ensemble="median",
                                         device="cpu")
    eng = ReservoirEngine.from_param_batch(tp, tr, ensemble="mean",
                                           device="cpu")
    with pytest.raises(ValueError, match="ensemble='weighted'"):
        eng.set_ensemble_weights([1.0, 1.0, 1.0])


# ------------------------------------------------ ensemble reductions (port)
def _singles(tb, jr, prompt):
    out = []
    for p, r in zip(tb, jr):
        s = ReservoirEngine(p, 1, readout=np.asarray(r.w_out), device="cpu")
        s.submit("s", prompt)
        s.flush()
        out.append(s)
    return out


@pytest.mark.parametrize("weights", (None, [0.2, 1.0, 3.0]))
def test_ensemble_decode_step_is_weighted_mean_of_slots(weights):
    """``ensemble='mean'`` (or ``'weighted'``): every queried sid sees the
    (weighted) mean of the per-model predictions."""
    *_, jb, jr, tb = _batch()
    _, te = _engines("mean" if weights is None else "weighted")
    if weights is not None:
        te.set_ensemble_weights(weights)
    singles = _singles(tb, jr, U[:128])
    for i in range(3):
        te.submit(i, U[:128])
    te.flush()
    outs = te.decode_step({i: U[128] for i in range(3)})
    w = np.ones(3) if weights is None else np.asarray(weights)
    want = np.sum([wi * s.decode_step({"s": U[128]})["s"]
                   for wi, s in zip(w, singles)], axis=0) / w.sum()
    for i in range(3):
        np.testing.assert_allclose(outs[i], want, **TOL)
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("ensemble", ("mean", "weighted"))
def test_ensemble_closed_loop_feeds_the_reduce_back(ensemble):
    """Closed loop under an ensemble: every reservoir is driven by the fused
    output, starting from the fused seed — against a host loop over the
    individual engines."""
    *_, jb, jr, tb = _batch()
    _, te = _engines(ensemble)
    w = np.asarray([1.0, 0.5, 2.0])
    if ensemble == "weighted":
        te.set_ensemble_weights(w)
    else:
        w = np.ones(3)
    singles = _singles(tb, jr, U[:128])
    for i in range(3):
        te.submit(i, U[:128])
    te.flush()
    got = te.decode_closed_loop(15)
    y = np.sum([wi * _np(s.y_prev[0]) for wi, s in zip(w, singles)],
               axis=0) / w.sum()
    ref = []
    for _ in range(15):
        y = np.sum([wi * s.decode_step({"s": y})["s"]
                    for wi, s in zip(w, singles)], axis=0) / w.sum()
        ref.append(y)
    for i in range(3):
        np.testing.assert_allclose(_np(got[i]), np.stack(ref), **TOL)


@pytest.mark.parametrize("partial", (False, True))
def test_fused_mean_route_matches_scan_path(partial):
    """``tests/test_decode_fused.py``: the fused kernel's ``mean`` route
    (its plain version on the CPU) equals the step-at-a-time scan path,
    with the fused seed, on a full and a partial mask."""
    _, _, tp, tr, *_ = _batch()
    eng = ReservoirEngine.from_param_batch(tp, tr, ensemble="mean",
                                           device="cpu")
    for i in range(3):
        eng.submit(i, U[600:700])
    eng.flush()
    arena0 = eng.arena
    mask = torch.tensor([True, not partial, True])
    a_s, ys_scan = tarena.closed_loop(tp, tr.w_out, arena0, mask, 7,
                                      batched=True, ensemble="mean")
    a_f, ys_fused = tarena.closed_loop_fused(tp, tr.w_out, arena0, mask, 7,
                                             batched=True, ensemble="mean")
    for g, w in ((ys_fused, ys_scan), (a_f.states, a_s.states),
                 (a_f.y_prev, a_s.y_prev)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-12, atol=1e-12)
    if partial:
        np.testing.assert_array_equal(_np(a_f.states[1]),
                                      _np(arena0.states[1]))
    ys = eng.decode_closed_loop(7)
    for i in range(1, 3):
        np.testing.assert_array_equal(_np(ys[0]), _np(ys[i]))


@pytest.mark.parametrize("method", ("auto", "kernel", "ref"))
def test_closed_loop_fused_method_matches_jax(method):
    """``closed_loop_fused(..., method=)`` as in the JAX package: every
    method gives the JAX fused loop's ``method="ref"`` stream on the CPU
    (1e-9), and the port's methods agree with each other bit for bit."""
    jp, jr, tp, tr, *_ = _batch()
    je = JaxEngine.from_param_batch(jp, readout=jr, ensemble="mean")
    te = ReservoirEngine.from_param_batch(tp, tr, ensemble="mean",
                                          device="cpu")
    for eng in (je, te):
        for i in range(3):
            eng.submit(i, U[600 + 10 * i:700])
        eng.flush()
    mask = np.array([True, False, True])
    ja, jys = jarena.closed_loop_fused(jp, jr.w_out, je.arena,
                                       jnp.asarray(mask), 7, batched=True,
                                       ensemble="mean", method="ref")
    ta, tys = tarena.closed_loop_fused(tp, tr.w_out, te.arena,
                                       torch.tensor(mask), 7, batched=True,
                                       ensemble="mean", method=method)
    for g, w in ((tys, jys), (ta.states, ja.states), (ta.y_prev, ja.y_prev)):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    _, auto = tarena.closed_loop_fused(tp, tr.w_out, te.arena,
                                       torch.tensor(mask), 7, batched=True,
                                       ensemble="mean")
    assert torch.equal(tys, auto)


# ------------------------------------------- the closed-loop route (C7)
@pytest.mark.parametrize("slots, per_slot, route", [
    (16, True, "fused"), (8, True, "fused"), (16, False, "fused"),
    (9, True, "fused"), (32, True, "fused"), (32, False, "fused"),
    (128, True, "fused"), (129, True, "step"), (129, False, "step")])
def test_decode_route_is_a_function_of_the_shapes(slots, per_slot, route):
    """The route chooser, asked for a CUDA device with no card present:
    ``mean`` over B rows of 525 float64 lanes (n = 1024) takes B2 while
    the rows fit its thread-block cluster (128 rows) and the step path
    past it; the CPU's plain version and ``off`` take the fused path at
    every B; ``weighted`` always steps."""
    kw = dict(ensemble="mean", per_slot=per_slot)
    assert tarena.decode_route(slots, 525, 1, 8, "cuda", **kw) == route
    assert tarena.decode_route(slots, 525, 1, 8, "cpu", **kw) == "fused"
    assert tarena.decode_route(slots, 525, 1, 8, "cuda", ensemble="off",
                               per_slot=per_slot) == "fused"
    assert tarena.decode_route(slots, 525, 1, 8, "cuda", ensemble="weighted",
                               per_slot=per_slot) == "step"


def _port_batch(b, n=48):
    ps = [tesn.dpg_params(tparams.ESNConfig(**{**CFG, "n": n,
                                              "seed": 100 + i}),
                          sigma=0.1, device="cpu") for i in range(b)]
    w = torch.stack([tesn.fit(p, U[:400], Y[:400], washout=50).w_out
                     for p in ps])
    return tparams.stack_params(ps), tparams.Readout(w)


def test_mean_closed_loop_of_16_slots_fused_equals_step():
    """At 16 slots the fused ``mean`` path (its plain version on the CPU)
    and the step path agree to 1e-12 relative, so the route the shapes
    pick does not change the served stream."""
    tp, tr = _port_batch(16)
    eng = ReservoirEngine.from_param_batch(tp, tr, ensemble="mean",
                                           device="cpu")
    for i in range(16):
        eng.submit(i, U[20 * i:20 * i + 150])
    eng.flush()
    mask = torch.ones(16, dtype=torch.bool)
    a_s, ys_s = tarena.closed_loop(tp, tr.w_out, eng.arena, mask, 9,
                                   batched=True, ensemble="mean")
    a_f, ys_f = tarena.closed_loop_fused(tp, tr.w_out, eng.arena, mask, 9,
                                         batched=True, ensemble="mean")
    for g, w in ((ys_f, ys_s), (a_f.states, a_s.states),
                 (a_f.y_prev, a_s.y_prev)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-12, atol=0)
    assert tarena.closed_loop_route(tp, tr.w_out, eng.arena,
                                    ensemble="mean") == "fused"


@pytest.mark.parametrize("ensemble, route", [("mean", "fused"),
                                             ("weighted", "step"),
                                             ("off", "fused")])
def test_engine_counts_decode_waves_by_route(ensemble, route):
    """``stats().decode_waves_by_route`` counts each decode wave under the
    path it took; single steps count as ``step``."""
    tp, tr = _port_batch(3)
    eng = ReservoirEngine.from_param_batch(tp, tr, ensemble=ensemble,
                                           device="cpu")
    for i in range(3):
        eng.submit(i, U[30 * i:30 * i + 100])
    eng.flush()
    eng.decode_closed_loop(4)
    eng.decode_closed_loop(4)
    eng.decode_step({i: U[200 + i] for i in range(3)})
    assert eng.stats().decode_waves_by_route == {
        "fused": 2 * (route == "fused"), "step": 1 + 2 * (route == "step")}
    waves = eng.collect_decoded().waves
    assert [w["fused"] for w in waves] == [route == "fused"] * 2 + [False]


# ------------------------------------------------------- batched prefill
@pytest.mark.parametrize("method", ("sequential", "associative", "chunked",
                                    "kernel"))
@pytest.mark.parametrize("fb", (False, True), ids=("plain", "fb"))
@pytest.mark.parametrize("want", (True, False), ids=("outputs", "seed"))
def test_batched_prefill_wave_matches_jax(method, fb, want):
    """``arena.prefill_wave(batched=True)`` over a wave of slots 2, 0 (not
    in order, one slot idle) with ragged lengths and a resumed carry.
    ``kernel`` is the card's route — per-row (B, 1, nc) coefficient lanes
    into the kernel wrapper — run here through its plain version (JAX has
    no such route: held against its sequential scan)."""
    jp, jr, tp, tr, *_ = _batch(fb=fb)
    rng = np.random.default_rng(3)
    b, t = 2, 96
    h0 = rng.normal(size=(3, CFG["n"]))
    y0 = rng.normal(size=(3, 1))
    u = rng.normal(size=(b, t, 1))
    yt = rng.normal(size=(b, t, 1)) if fb else None
    lengths = np.asarray([96, 61])
    slots = np.asarray([2, 0])
    ja = jarena.SlotArena(jnp.asarray(h0), jnp.asarray(y0),
                          jnp.ones((3,), bool))
    ta = tarena.SlotArena(torch.tensor(h0), torch.tensor(y0),
                          torch.ones(3, dtype=torch.bool))
    kw = dict(method=method, chunk=32, want_outputs=want)
    jkw = dict(kw, method="sequential" if method == "kernel" else method)
    ja2, jout = jarena.prefill_wave(
        jp, jr.w_out, ja, jnp.asarray(slots), jnp.asarray(u),
        jnp.asarray(lengths), None if yt is None else jnp.asarray(yt),
        batched=True, **jkw)
    ta2, tout = tarena.prefill_wave(
        tp, tr.w_out, ta, torch.tensor(slots), torch.tensor(u),
        torch.tensor(lengths), None if yt is None else torch.tensor(yt),
        batched=True, **kw)
    np.testing.assert_allclose(_np(ta2.states), _np(ja2.states), **TOL)
    np.testing.assert_allclose(_np(ta2.y_prev), _np(ja2.y_prev), **TOL)
    assert (tout is None) == (jout is None)
    if want:
        np.testing.assert_allclose(_np(tout), _np(jout), **TOL)
    # No readout: the wave streams states.
    _, sout = tarena.prefill_wave(
        tp, None, ta, torch.tensor(slots), torch.tensor(u),
        torch.tensor(lengths), None if yt is None else torch.tensor(yt),
        batched=True, method=method, chunk=32)
    _, jsout = jarena.prefill_wave(
        jp, None, ja, jnp.asarray(slots), jnp.asarray(u),
        jnp.asarray(lengths), None if yt is None else jnp.asarray(yt),
        batched=True, method=jkw["method"], chunk=32)
    np.testing.assert_allclose(_np(sout), _np(jsout), **TOL)


# ------------------------------------------------------------- the driver
@pytest.mark.parametrize("ensemble", ("mean", "weighted", "independent"))
def test_serve_driver_ensemble_on_cpu(ensemble):
    """``launch.serve --reservoir --ensemble`` on the CPU: the fused stream
    tracks the signal; the independent batch serves the session loop."""
    argv = ["--reservoir", "--n", "48", "--slots", "3", "--sessions", "4",
            "--prompt-len", "200", "--gen", "16", "--device", "cpu",
            "--ensemble", ensemble]
    res = tserve.main(argv)
    assert res["finite"]
    if ensemble == "independent":
        assert res["sessions"] == 4 and res["decode_tokens"] == 64
    else:
        assert res["sessions"] == 3 and res["ensemble"] == ensemble
        assert res["continuation"].shape == (16,)
        assert res["rmse_vs_signal"] < 1e-2
        fused = int(ensemble == "mean")
        assert res["decode_waves_by_route"] == {"fused": 2 * fused,
                                                "step": 2 * (1 - fused)}
