"""The facade-parity workload (``tests/facade_parity_workload.py``) through
the PyTorch port: the same model, engine arguments and script, imported
from ``repro_torch`` and numpy only, on any device.

Churn (submit / flush over a paged 3-slot arena with a cold tier), chunked
prefill, teacher-forced streaming with learning and a refit, closed-loop
decode, release / drop / re-admit, ``flush(refit=True)`` and a snapshot of
the surviving per-session state, all through the public engine surface.
Its outputs must reproduce ``tests/data/facade_parity_ref.npz`` (31
arrays, recorded from the JAX engine) to 1e-5 with equal NaN patterns:
``tests/test_torch_facade_parity.py`` on the CPU, ``chip_smoke.py`` on the
GPU.
"""
import os
import tempfile

import numpy as np

from repro_torch.core.esn import LinearESN
from repro_torch.core.params import ESNConfig
from repro_torch.data.signals import mso_series

REF_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "facade_parity_ref.npz")

CFG = ESNConfig(n=24, d_in=1, d_out=1, spectral_radius=0.9, leak=0.8,
                input_scaling=0.5, ridge_alpha=1e-4, seed=11,
                use_feedback=True)


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def build_model(device):
    """Standard fit on the first 400 steps, then EWT into the diagonalized
    model — built on ``device``."""
    sig = mso_series(3, 901)
    u, y = sig[:-1, None], sig[1:, None]
    std = LinearESN.standard(CFG, device=device).fit(u[:400], y[:400],
                                                     washout=50)
    model = LinearESN.diagonalized(CFG, device=device).ewt_from(std)
    return model, u, y


def run_workload(device="cpu", engine_cls=None):
    """Drive the scripted mixed workload on ``device``; return
    {name: np.ndarray} under the reference's names."""
    if engine_cls is None:
        from repro_torch.serve.engine import ReservoirEngine as engine_cls
    model, u, y = build_model(device)
    eng = engine_cls(model, max_slots=3, learn=True, refit_washout=0,
                     park_host_rows=4,
                     cold_dir=tempfile.mkdtemp(prefix="parity_cold_"),
                     decode_wave_tokens=2, chunk_max=48, device=device)
    out = {}

    # Churn 6 sessions through a 3-slot paged arena; one long prompt drains
    # as resumable chunk waves (chunk_max=48 < 130).
    lens = [24, 40, 130, 17, 24, 40]
    for i, t in enumerate(lens):
        off = 60 + 31 * i
        tenant = "acme" if i % 2 == 0 else None
        eng.submit(f"s{i}", u[off:off + t], y[off:off + t], tenant=tenant)
    eng.flush()

    # Closed-loop decode on hot and parked sessions (parked targets
    # promote).
    eng.decode_closed_loop(4, sids=["s0", "s2", "s4"])

    # Teacher-forced streaming (learn accumulation) on two sessions.
    for t in range(300, 340):
        eng.decode_step({"s1": u[t], "s3": u[t + 100]})
        eng.observe("s1", y[t])
        eng.observe("s3", y[t + 100])

    # Refit the dirty sessions; the new readouts serve at once.
    w = eng.refit()
    for sid, arr in sorted(w.items()):
        out[f"refit_w:{sid}"] = _np(arr)

    # Release one session with its state, drop another, re-admit the
    # released state under a new sid, plus a fresh prompt.
    ev = eng.release("s5")
    out["release_s5_state"] = _np(ev[0])
    out["release_s5_yprev"] = _np(ev[1])
    eng.release("s4", drop=True)
    eng.submit("s5b", h0=ev[0], y0=ev[1])
    eng.submit("s6", u[500:540], y[500:540])
    eng.flush(refit=True)

    # A second decode burst over the survivors.
    eng.decode_closed_loop(3, sids=["s1", "s5b", "s6"])

    # Drain every buffered token and read the surviving state.
    dec = eng.collect_decoded()
    for sid, arr in sorted(dec.tokens.items()):
        out[f"decoded:{sid}"] = _np(arr)
    for sid in ["s0", "s1", "s2", "s3", "s5b", "s6"]:
        out[f"state:{sid}"] = _np(eng.state_of(sid))
        ro = eng.readout_for(sid)
        if ro is not None:
            out[f"readout:{sid}"] = _np(ro)
    st = eng.stats()
    for k in ("waves_total", "rows_total", "prefill_tokens", "decode_tokens",
              "refit_waves_total", "refit_rows_total", "page_rows_total",
              "sessions_active", "sessions_parked"):
        out[f"stat:{k}"] = np.asarray(getattr(st, k))
    return out


def compare(got, ref, atol: float = 1e-5):
    """Hold ``got`` against the reference arrays: the same names, shapes
    and NaN patterns, and every finite value within ``atol``.  Returns the
    largest absolute difference; raises AssertionError naming the first
    array that disagrees."""
    assert set(got) == set(ref.files), sorted(set(got) ^ set(ref.files))
    worst = 0.0
    for k in ref.files:
        a = np.asarray(got[k], dtype=float)
        b = np.asarray(ref[k], dtype=float)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        na, nb = np.isnan(a), np.isnan(b)
        assert (na == nb).all(), f"{k}: NaN pattern diverged"
        if (~na).any():
            np.testing.assert_allclose(a[~na], b[~nb], rtol=0, atol=atol,
                                       err_msg=k)
            worst = max(worst, float(np.abs(a[~na] - b[~nb]).max()))
    return worst
