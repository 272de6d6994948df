"""Port parity: teacher forcing (``observe``) and teacher-driven decode
(``arena.driven_loop``, the engine's driven waves) against the JAX package.

The cases of ``tests/test_serve_engine.py`` (the observe regression and the
mean ensemble's all-slots write) and ``tests/test_decode_fused.py`` (a
teacher write landing between fused waves) run on the port and against the
JAX engine on the same model (1e-9; the dense hand loops 1e-5 as in the
JAX suite).  ``driven_loop`` is K ``decode_step`` calls bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import esn as jesn
from repro.core import params as jparams
from repro.serve.engine import ReservoirEngine as JaxEngine
from repro_torch.core import esn as tesn
from repro_torch.core import params as tparams
from repro_torch.data.signals import mso_series
from repro_torch.serve import arena as tarena
from repro_torch.serve.engine import ReservoirEngine

TOL = dict(rtol=1e-9, atol=1e-9)
FB = dict(n=40, spectral_radius=0.9, leak=0.8, input_scaling=0.5,
          use_feedback=True, seed=5)
DIAG = dict(n=48, spectral_radius=0.9, leak=0.8, input_scaling=0.5,
            ridge_alpha=1e-8, seed=7)
SIG = mso_series(3, 801)
U, Y = SIG[:-1, None], SIG[1:, None]


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _facades(builder, kw, t=300):
    """The same facade fitted by JAX, the port carrying its readout."""
    jm = getattr(jesn.LinearESN, builder)(jparams.ESNConfig(**kw))
    jm.fit(U[:t], Y[:t], washout=50)
    tm = getattr(tesn.LinearESN, builder)(tparams.ESNConfig(**kw),
                                          device="cpu")
    tm.w_out = np.asarray(jm.w_out)
    return jm, tm


def test_observe_regression_teacher_forcing_is_not_a_noop():
    """``tests/test_serve_engine.py``: an observed output changes the next
    prediction, and decode_step + observe in a loop is the dense lock-step
    teacher-forced reference — on the port, and equal to the JAX engine."""
    jm, tm = _facades("standard", FB)
    w, w_in, w_fb = (_np(tm.w), _np(tm.w_in), _np(tm.w_fb))
    w_out = _np(tm.w_out)
    r = np.zeros(FB["n"])
    yfb = np.zeros(1)
    for t in range(300):
        r = r @ w + U[t] @ w_in + yfb @ w_fb
        yfb = Y[t]
    r_pre = r.copy()

    def fresh(cls, m, **kw):
        e = cls(m, max_slots=1, **kw)
        e.submit("s", U[:300], y_teacher=Y[:300])
        e.flush()
        return e

    forced, free = (fresh(ReservoirEngine, tm, device="cpu")
                    for _ in range(2))
    y_obs = Y[300] + 7.0
    forced.observe("s", y_obs)
    p_forced = forced.decode_step({"s": U[300]})["s"]
    p_free = free.decode_step({"s": U[300]})["s"]
    assert not np.allclose(p_forced, p_free, atol=1e-3)
    r_f = r_pre @ w + U[300] @ w_in + y_obs @ w_fb
    np.testing.assert_allclose(
        p_forced, np.concatenate([[1.0], y_obs.ravel(), r_f]) @ w_out,
        rtol=0, atol=1e-5)

    engines = (fresh(ReservoirEngine, tm, device="cpu"),
               fresh(JaxEngine, jm))
    y_prev = Y[299]
    for t in range(300, 320):
        r = r @ w + U[t] @ w_in + y_prev @ w_fb
        ref = np.concatenate([[1.0], y_prev.ravel(), r]) @ w_out
        got = [e.decode_step({"s": U[t]})["s"] for e in engines]
        np.testing.assert_allclose(got[0], ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[0], _np(got[1]), **TOL)
        for e in engines:
            e.observe("s", Y[t])
        np.testing.assert_allclose(_np(engines[0].y_prev[0]), Y[t],
                                   rtol=0, atol=1e-12)
        y_prev = Y[t]
    np.testing.assert_allclose(engines[0].state_of("s"),
                               _np(engines[1].state_of("s")), **TOL)


def test_observe_ensemble_mean_corrects_every_slot():
    """Under ``ensemble='mean'`` the correction lands in every ready slot's
    feedback row, and the fused free-run starts from it (against JAX)."""
    kw = dict(DIAG, use_feedback=False)
    jb = [jesn.dpg_params(jparams.ESNConfig(**{**kw, "seed": 5 + i}),
                          "noisy_golden", sigma=0.1) for i in range(3)]
    tb = [tesn.dpg_params(tparams.ESNConfig(**{**kw, "seed": 5 + i}),
                          "noisy_golden", sigma=0.1, device="cpu")
          for i in range(3)]
    w = np.stack([np.asarray(jesn.fit(p, U[:400], Y[:400], washout=50).w_out)
                  for p in jb])
    engines = (ReservoirEngine.from_param_batch(
        tparams.stack_params(tb), tparams.Readout(torch.tensor(w)),
        ensemble="mean", device="cpu"),
        JaxEngine.from_param_batch(jparams.stack_params(jb),
                                   readout=jparams.Readout(jnp.asarray(w)),
                                   ensemble="mean"))
    ys = []
    for e in engines:
        for i in range(3):
            e.submit(i, U[:100])
        e.flush()
        e.decode_step({i: U[100] for i in range(3)})
        e.observe(0, [3.25])
        np.testing.assert_array_equal(_np(e.y_prev), np.full((3, 1), 3.25))
        ys.append(_np(e.decode_closed_loop(4)[0]))
    np.testing.assert_allclose(ys[0], ys[1], **TOL)


def _diag_engine(cls, m, sids, **kw):
    eng = cls(m, max_slots=max(4, len(sids)), **kw)
    for i, s in enumerate(sids):
        eng.submit(s, SIG[600 + i:700 + i, None])
    eng.flush()
    return eng


def test_observe_teacher_write_lands_mid_wave():
    """``tests/test_decode_fused.py``: a teacher value observed between two
    fused closed-loop waves drives the next wave's first step — the port's
    waves equal its own step-by-step replay bit for bit and the JAX
    engine's waves to 1e-9."""
    jm, tm = _facades("diagonalized", DIAG, t=800)
    s = "chat"
    y_star = np.asarray([1.5])
    waves = []
    for cls, m, kw in ((ReservoirEngine, tm, {"device": "cpu"}),
                       (JaxEngine, jm, {})):
        eng = _diag_engine(cls, m, [s], **kw)
        w1 = _np(eng.decode_closed_loop(3)[s])
        eng.observe(s, y_star)
        waves.append((w1, _np(eng.decode_closed_loop(3)[s])))
    for g, w in zip(*waves):
        np.testing.assert_allclose(g, w, **TOL)
    step = _diag_engine(ReservoirEngine, tm, [s], device="cpu")
    cur = {s: _np(step.y_prev[step.sessions[s].slot])}
    ref1 = []
    for _ in range(3):
        cur = step.decode_step(cur)
        ref1.append(cur[s])
    np.testing.assert_allclose(waves[0][0].ravel(), np.ravel(ref1),
                               rtol=0, atol=1e-12)
    cur = {s: y_star}
    ref2 = []
    for _ in range(3):
        cur = step.decode_step(cur)
        ref2.append(cur[s])
    np.testing.assert_allclose(waves[0][1].ravel(), np.ravel(ref2),
                               rtol=0, atol=1e-12)


# ------------------------------------------------------------ driven_loop
@pytest.mark.parametrize("kind", ("diag", "standard-fb", "batched-mean",
                                  "batched-weighted"))
def test_driven_loop_is_k_decode_steps_bit_for_bit(kind):
    """``arena.driven_loop`` over K queued inputs == K ``decode_step``
    calls, bit for bit (masked rows frozen), and equals JAX's driven loop
    to 1e-9."""
    from repro.serve import arena as jarena
    rng = np.random.default_rng(1)
    kw, ens, batched = {}, "off", kind.startswith("batched")
    if batched:
        b = 3
        base = dict(DIAG, n=24)
        tb = [tesn.dpg_params(tparams.ESNConfig(**{**base, "seed": i}),
                              sigma=0.1, device="cpu") for i in range(b)]
        jb = [jesn.dpg_params(jparams.ESNConfig(**{**base, "seed": i}),
                              sigma=0.1) for i in range(b)]
        tp, jp = tparams.stack_params(tb), jparams.stack_params(jb)
        f = base["n"] + 1
        w = rng.normal(size=(b, f, 1)) / f
        ens = kind.split("-")[1]
        weights = np.asarray([1.0, 2.0, 0.5]) if ens == "weighted" else None
    else:
        b = 4
        if kind == "diag":
            jm, tm = _facades("diagonalized", DIAG)
        else:
            jm, tm = _facades("standard", FB)
        tp, jp, w, weights = tm.params, jm.params, _np(tm.w_out), None
    n = tp.cfg.n
    h = rng.normal(size=(b, n))
    y = rng.normal(size=(b, 1))
    mask = np.ones(b, bool)
    mask[1] = False
    u_seq = rng.normal(size=(5, b, 1))
    ta = tarena.SlotArena(torch.tensor(h), torch.tensor(y),
                          torch.ones(b, dtype=torch.bool))
    tw = torch.tensor(w)
    tk = dict(batched=batched, ensemble=ens)
    tweights = None if weights is None else torch.tensor(weights)
    got_a, got = tarena.driven_loop(tp, tw, ta, torch.tensor(mask),
                                    torch.tensor(u_seq), tweights, **tk)
    a = ta
    for k in range(5):
        a, yk = tarena.decode_step(tp, tw, a, torch.tensor(u_seq[k]),
                                   torch.tensor(mask), tweights, **tk)
        np.testing.assert_array_equal(_np(got[k]), _np(yk))
    np.testing.assert_array_equal(_np(got_a.states), _np(a.states))
    np.testing.assert_array_equal(_np(got_a.y_prev), _np(a.y_prev))
    np.testing.assert_array_equal(_np(got_a.states[1]), h[1])
    ja = jarena.SlotArena(jnp.asarray(h), jnp.asarray(y), jnp.ones(b, bool))
    ja2, want = jarena.driven_loop(
        jp, jnp.asarray(w), ja, jnp.asarray(mask), jnp.asarray(u_seq),
        None if weights is None else jnp.asarray(weights), **tk)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(got_a.states), np.asarray(ja2.states),
                               **TOL)


def test_engine_driven_wave_equals_decode_steps():
    """Queued open-loop inputs drained by an interleaved flush's driven
    waves give the tokens K ``decode_step`` calls give, bit for bit."""
    from repro_torch.serve.cost import WaveCostModel
    _, tm = _facades("diagonalized", DIAG, t=800)
    inputs = SIG[200:212, None]

    def build():
        cm = WaveCostModel()
        for t in (64, 128):
            for bb in (1, 2):
                cm.observe(bb, t, 5000.0 + 100.0 * bb)
        e = ReservoirEngine(tm, 4, device="cpu", chunk_max=100,
                            cost_model=cm, decode_slo_us=1.0,
                            decode_wave_tokens=4)
        e.submit("d", U[:30])
        e.flush()
        return e

    eng = build()
    eng.queue_inputs("d", inputs)
    for i in range(2):
        eng.submit(("f", i), U[:300])
    eng.flush(decode_interleave=True, decode_sids=["d"])
    res = eng.collect_decoded("d")
    assert res.waves and all(w["kind"] == "driven" and not w["fused"]
                             for w in res.waves)
    got = _np(res["d"])
    ref = build()
    want = [ref.decode_step({"d": row})["d"] for row in inputs[:len(got)]]
    np.testing.assert_array_equal(got, np.stack(want))
    assert len(got) == min(12, 4 * len(res.waves))
