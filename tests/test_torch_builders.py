"""Port parity: reservoir builders, param structs and the weight carry-over.

The port's builders generate weights on the host with numpy exactly as the
JAX package does, so every leaf must be bit-identical for the same config.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import esn as jesn
from repro.core import params as jparams
from repro.data import signals as jsignals
from repro_torch.core import esn as tesn
from repro_torch.core import params as tparams
from repro_torch.data import signals as tsignals

CONFIGS = [
    dict(n=16, seed=0),
    dict(n=24, d_in=2, d_out=2, use_feedback=True, feedback_scaling=0.3,
         leak=0.7, seed=3),
    dict(n=33, use_bias=False, connectivity=0.5, input_connectivity=0.7,
         spectral_radius=0.8, seed=5),
    dict(n=48, use_feedback=True, use_bias=False, input_scaling=0.4, seed=9),
]


def _cfgs(kw):
    return jparams.ESNConfig(**kw), tparams.ESNConfig(**kw)


def _same(t, j):
    if j is None:
        assert t is None
        return
    t = t.numpy()
    j = np.asarray(j)
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("kw", CONFIGS)
def test_standard_params_bit_equal(kw):
    jc, tc = _cfgs(kw)
    jp, tp = jesn.standard_params(jc), tesn.standard_params(tc, device="cpu")
    for name in ("w", "w_in", "w_fb"):
        _same(getattr(tp, name), getattr(jp, name))
    assert tp.mode == "standard" and tp.dtype == torch.float64


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("builder", ["diag", "uniform", "golden",
                                     "noisy_golden", "sim"])
def test_diag_params_bit_equal(kw, builder):
    jc, tc = _cfgs(kw)
    if builder == "diag":
        jp, tp = jesn.diag_params(jc), tesn.diag_params(tc, device="cpu")
    else:
        jp = jesn.dpg_params(jc, builder, sigma=0.1)
        tp = tesn.dpg_params(tc, builder, sigma=0.1, device="cpu")
    for name in ("lam_q", "win_q", "wfb_q", "qtq"):
        _same(getattr(tp, name), getattr(jp, name))
    assert tp.n_real == jp.n_real and tp.cfg.n_features == jc.n_features


def test_mso_series_bit_equal():
    np.testing.assert_array_equal(tsignals.mso_series(5, 333),
                                  jsignals.mso_series(5, 333))


@pytest.mark.parametrize("kind", ["standard", "diag"])
def test_params_from_numpy_carries_jax_leaves(kind):
    kw = CONFIGS[1]
    jc, _ = _cfgs(kw)
    jp = (jesn.standard_params(jc) if kind == "standard"
          else jesn.dpg_params(jc, sigma=0.1))
    names = ("w", "w_in", "w_fb") if kind == "standard" else (
        "lam_q", "win_q", "wfb_q", "qtq")
    arrays = {k: None if getattr(jp, k) is None else np.asarray(getattr(jp, k))
              for k in names}
    tp = tparams.params_from_numpy(kind, arrays, dataclasses.asdict(jc),
                                   n_real=getattr(jp, "n_real", None),
                                   device="cpu")
    for name in names:
        _same(getattr(tp, name), getattr(jp, name))
    assert tp.cfg == tparams.ESNConfig(**kw)
    ro = tparams.readout_from_numpy(np.arange(6.0).reshape(3, 2), device="cpu")
    np.testing.assert_array_equal(ro.w_out.numpy(),
                                  np.arange(6.0).reshape(3, 2))
    with pytest.raises(ValueError, match="n_real"):
        tparams.params_from_numpy("diag", arrays if kind == "diag" else {},
                                  jc.__dict__, device="cpu")


def test_stack_params_matches_jax():
    kws = [dict(n=16, seed=s) for s in (0, 1, 2)]
    jps = [jesn.dpg_params(jparams.ESNConfig(**k)) for k in kws]
    tps = [tesn.dpg_params(tparams.ESNConfig(**k), device="cpu") for k in kws]
    js, ts = jparams.stack_params(jps), tparams.stack_params(tps)
    for name in ("lam_q", "win_q", "qtq"):
        _same(getattr(ts, name), getattr(js, name))
    assert ts.wfb_q is None and ts.cfg == tps[0].cfg
    with pytest.raises(ValueError, match="only cfg.seed"):
        tparams.stack_params([tps[0], tesn.dpg_params(
            tparams.ESNConfig(n=16, leak=0.5), device="cpu")])
    with pytest.raises(ValueError, match="at least one"):
        tparams.stack_params([])


def test_params_to_moves_every_leaf():
    tp = tesn.dpg_params(tparams.ESNConfig(n=16), device="cpu")
    moved = tparams.params_to(tp, torch.device("cpu"))
    assert moved.device.type == "cpu" and moved.n_real == tp.n_real
    assert jnp.asarray(moved.lam_q.numpy()).shape == (16,)
