"""Port parity: a prompt drained as chunk waves equals the whole prompt.

The case of the JAX package's
``tests/test_chunked_wave.py::test_chunked_feedback_carry_crosses_boundaries``
(a feedback model, a 200-step prompt with its teacher outputs, ``chunk_max``
48 — four chunks of 48 and one of 8 — against the unchunked prompt, both
through the sequential scan), for standard and diagonal params.  Inside the
port the chunked run is bit-equal to the whole one: outputs, the released
state and ``y_prev`` (the teacher-output carry crosses every chunk boundary
exactly).  Against the JAX engine's whole-prompt run, with the same params
and readout carried over, they agree to 1e-5 (float64 rounding in two
frameworks; the reservoir parity tolerance of the port).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import esn as jesn
from repro.core.esn import ESNConfig
from repro.data.signals import mso_series
from repro.serve import ReservoirEngine as JaxEngine
from repro_torch.core import params as tparams
from repro_torch.serve.engine import ReservoirEngine

CFG = ESNConfig(n=48, d_in=1, d_out=1, spectral_radius=0.9, leak=0.8,
                input_scaling=0.5, ridge_alpha=1e-8, seed=7)
CFG_FB = dataclasses.replace(CFG, n=40, use_feedback=True, seed=5)


def _xy(t=500, k=3):
    sig = mso_series(k, t + 1)
    return sig[:-1, None], sig[1:, None]


def _models(mode):
    """The JAX params and readout, and the port's carried over from them."""
    u, y = _xy()
    jp = (jesn.standard_params(CFG_FB) if mode == "standard"
          else jesn.diag_params(CFG_FB))
    jr = jesn.fit(jp, u[:400], y[:400], washout=50)
    names = ("w", "w_in", "w_fb") if mode == "standard" else (
        "lam_q", "win_q", "wfb_q", "qtq")
    arrays = {k: None if getattr(jp, k) is None else np.asarray(getattr(jp, k))
              for k in names}
    tp = tparams.params_from_numpy(jp.mode, arrays,
                                   dataclasses.asdict(jp.cfg),
                                   n_real=getattr(jp, "n_real", None),
                                   device="cpu")
    tr = tparams.readout_from_numpy(np.asarray(jr.w_out), device="cpu")
    return jp, jr, tp, tr, u, y


def _run(params, readout, u, y, **kw):
    """The prompt with its teacher outputs through a one-slot engine (the
    JAX one for JAX params, the port's on the CPU for the port's): the
    outputs, the slot's state and its ``y_prev``, as numpy."""
    if isinstance(params, tparams.DiagParams | tparams.StandardParams):
        eng = ReservoirEngine(params, max_slots=1, readout=readout,
                              device="cpu", **kw)
    else:
        eng = JaxEngine(params, max_slots=1, readout=readout, **kw)
    eng.submit("s", u[:200], y_teacher=y[:200])
    out = eng.flush(want_outputs=True, method="sequential")["s"]
    return tuple(v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v)
                 for v in (out, eng.state_of("s"), eng.y_prev[0]))


@pytest.mark.parametrize("mode", ["standard", "diag"])
def test_chunked_feedback_carry_crosses_boundaries(mode):
    jp, jr, tp, tr, u, y = _models(mode)
    whole = _run(tp, tr, u, y)
    chunked = _run(tp, tr, u, y, chunk_max=48)        # uneven: 48*4 + 8
    for name, c, w in zip(("outputs", "state", "y_prev"), chunked, whole):
        assert c.shape == w.shape, name
        np.testing.assert_array_equal(c, w, err_msg=name)
    ref = _run(jp, jr, u, y)
    for name, c, w in zip(("outputs", "state", "y_prev"), chunked, ref):
        np.testing.assert_allclose(c, w, rtol=1e-5, atol=1e-5, err_msg=name)
