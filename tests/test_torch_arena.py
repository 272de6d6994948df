"""Port parity: the slot-arena functions against ``repro.serve.arena``.

Value semantics, batched prefill (padding inert under garbage tails), the
single-step and fused closed loops.  Float64 tolerance 1e-12: the same
arithmetic in another framework.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import esn as jesn
from repro.core import params as jparams
from repro.serve import arena as jarena
from repro_torch.core import params as tparams
from repro_torch.serve import arena as tarena

TOL = dict(rtol=1e-12, atol=1e-12)


def _models(use_feedback=False):
    jc = jparams.ESNConfig(n=24, leak=0.9, use_feedback=use_feedback,
                           feedback_scaling=0.3, seed=4)
    jp = jesn.dpg_params(jc, sigma=0.1)
    arrays = {k: None if getattr(jp, k) is None else np.asarray(getattr(jp, k))
              for k in ("lam_q", "win_q", "wfb_q", "qtq")}
    tp = tparams.params_from_numpy("diag", arrays, dataclasses.asdict(jc),
                                   n_real=jp.n_real, device="cpu")
    w_out = 0.1 * np.random.default_rng(0).normal(size=(jc.n_features, 1))
    return jp, tp, w_out


def _arenas(rng, n, slots=4):
    states, ys = rng.normal(size=(slots, n)), rng.normal(size=(slots, 1))
    active = np.array([True, False, True, False])
    return (jarena.SlotArena(jnp.asarray(states), jnp.asarray(ys),
                             jnp.asarray(active)),
            tarena.SlotArena(torch.tensor(states), torch.tensor(ys),
                             torch.tensor(active)))


def _same_arena(t, j, **tol):
    for name in ("states", "y_prev"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), **(tol or TOL))
    np.testing.assert_array_equal(t.active.numpy(), np.asarray(j.active))


def test_place_gather_release_match_and_keep_values():
    jp, tp, _ = _models()
    rng = np.random.default_rng(1)
    ja, ta = _arenas(rng, jp.cfg.n)
    h = rng.normal(size=(2, jp.cfg.n))
    y = rng.normal(size=(2, 1))
    before = ta.states.clone()
    ja2 = jarena.place_many(ja, jnp.asarray([1, 3]), jnp.asarray(h),
                            jnp.asarray(y))
    ta2 = tarena.place_many(ta, torch.tensor([1, 3]), torch.tensor(h),
                            torch.tensor(y))
    _same_arena(ta2, ja2)
    assert torch.equal(ta.states, before)          # the old value survives
    for a, b in zip(tarena.gather_rows(ta2, torch.tensor([3, 0])),
                    jarena.gather_rows(ja2, [3, 0])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _same_arena(tarena.release_many(ta2, torch.tensor([0, 1])),
                jarena.release_many(ja2, jnp.asarray([0, 1])))
    _same_arena(tarena.release(tarena.place(ta, 1, h[0], y[0]), 2),
                jarena.release(jarena.place(ja, 1, jnp.asarray(h[0]),
                                            jnp.asarray(y[0])), 2))


@pytest.mark.parametrize("use_feedback", [False, True])
@pytest.mark.parametrize("want_outputs", [False, True])
@pytest.mark.parametrize("method", ["sequential", "associative", "chunked",
                                    "kernel"])
def test_prefill_wave_matches_jax_and_ignores_tails(use_feedback,
                                                    want_outputs, method):
    jp, tp, w_out = _models(use_feedback)
    rng = np.random.default_rng(2)
    ja, ta = _arenas(rng, jp.cfg.n)
    lengths = np.array([40, 17, 64])
    u = rng.normal(size=(3, 64, 1))
    yt = rng.normal(size=(3, 64, 1)) if use_feedback else None
    slots = np.array([2, 0, 3])
    j_method = "pallas" if method == "kernel" else method
    ja2, jout = jarena.prefill_wave(
        jp, jnp.asarray(w_out), ja, jnp.asarray(slots), jnp.asarray(u),
        jnp.asarray(lengths), None if yt is None else jnp.asarray(yt),
        method=j_method, chunk=16, want_outputs=want_outputs)
    # Garbage past each row's length must not reach the gathered carry.
    u_bad = u.copy()
    for i, t in enumerate(lengths):
        u_bad[i, t:] = 1e6
    ta2, tout = tarena.prefill_wave(
        tp, torch.tensor(w_out), ta, torch.tensor(slots), torch.tensor(u_bad),
        torch.tensor(lengths), None if yt is None else torch.tensor(yt),
        method=method, chunk=16, want_outputs=want_outputs)
    _same_arena(ta2, ja2)
    if want_outputs:
        mask = np.arange(64)[None, :, None] < lengths[:, None, None]
        np.testing.assert_allclose(tout.numpy() * mask,
                                   np.asarray(jout) * mask, **TOL)
    else:
        assert tout is None and jout is None


@pytest.mark.parametrize("use_feedback", [False, True])
def test_closed_loops_match_jax(use_feedback):
    jp, tp, w_out = _models(use_feedback)
    rng = np.random.default_rng(3)
    ja, ta = _arenas(rng, jp.cfg.n)
    mask = np.array([True, True, False, True])
    want = jarena.closed_loop(jp, jnp.asarray(w_out), ja, jnp.asarray(mask),
                              7)
    for fn in (tarena.closed_loop, tarena.closed_loop_fused):
        got = fn(tp, torch.tensor(w_out), ta, torch.tensor(mask), 7)
        _same_arena(got[0], want[0], rtol=1e-11, atol=1e-11)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-11, atol=1e-11)
    u = rng.normal(size=(4, 1))
    jd = jarena.decode_step(jp, jnp.asarray(w_out), ja, jnp.asarray(u),
                            jnp.asarray(mask))
    td = tarena.decode_step(tp, torch.tensor(w_out), ta, torch.tensor(u),
                            torch.tensor(mask))
    _same_arena(td[0], jd[0])
    np.testing.assert_allclose(td[1].numpy(), np.asarray(jd[1]), **TOL)
