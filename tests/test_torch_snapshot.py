"""Port parity: engine snapshots, in the port and across the two packages.

A snapshot is one directory (``manifest.json``, ``arrays.npz``,
``cost.json``, ``_COMPLETE``) in the JAX package's layout.  Inside the port
a restored engine resumes mid-workload (hot sessions, parked sessions in
both tiers, a queued prompt, uncollected decode tokens) bit-equal to the
engine that was not snapshotted.  A snapshot written by the JAX engine
restores in the port and continues to match the JAX engine, and one written
by the port restores in the JAX engine, at ``test_torch_engine.py``'s
tolerance (1e-9).  The learn plane is not ported (ROADMAP A9): a snapshot
carrying learn state is refused, never silently dropped.
"""
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from repro.serve.engine import ReservoirEngine as JaxEngine
from repro_torch.core import esn as tesn
from repro_torch.serve.engine import ReservoirEngine

from test_torch_store import SIG, TOL, _cold, _models, _np, _prompts


def _snap_dir():
    return tempfile.mkdtemp(prefix="torch_snap_") + "/engine"


def _mid_workload(eng):
    """10 prompts into a 3-slot arena over a 4-row pool and a cold dir,
    teacher-forced and decoded (tokens left uncollected), and one prompt
    queued but not flushed."""
    prompts = _prompts(10)
    for sid, u in prompts.items():
        eng.submit(sid, u)
    eng.flush()
    for sid in list(prompts)[:4]:
        eng.observe(sid, prompts[sid][-1] * 0.5)
        eng.decode_closed_loop(2, sids=[sid])
    eng.submit("queued", SIG[300:316, None])
    return list(prompts) + ["queued"]


def _continue(eng, sids):
    """Collect the buffered tokens, admit the queued prompt, decode every
    session 3 tokens; every output as numpy, in order."""
    buf = eng.collect_decoded()
    out = [_np(buf.tokens[s]) for s in sorted(buf.tokens)]
    eng.flush()
    for sid in sids:
        out.append(_np(eng.decode_closed_loop(3, sids=[sid])[sid]))
    return out


def _paged(cls, params, readout, **kw):
    return cls(params, max_slots=3, readout=readout, park_host_rows=4,
               cold_dir=_cold(), **kw)


@pytest.mark.parametrize("readout", ["jax_fit", "port_fit"])
def test_snapshot_restore_resumes_mid_workload_bit_equal(readout):
    """``port_fit``: the port's ridge solve returns the readout strided as a
    column; the snapshot stores it row-major, so the engine must compute on
    that layout from the start for the restored engine to match."""
    _, _, tp, tr = _models()
    if readout == "port_fit":
        tr = tesn.fit(tp, SIG[:1200, None], SIG[1:1201, None], washout=50)
        assert tr.w_out.stride() != (1, 1)
    eng = _paged(ReservoirEngine, tp, tr, autotune=True, device="cpu")
    sids = _mid_workload(eng)
    assert {eng.store.tier_of(s) for s in eng.store.sids} == {"host", "cold"}
    path = eng.snapshot(_snap_dir())
    assert sorted(os.listdir(path)) == ["_COMPLETE", "arrays.npz",
                                        "cost.json", "manifest.json"]
    res = ReservoirEngine.restore(path, device="cpu")
    assert set(res.active_sessions) == set(eng.active_sessions)
    assert set(res.parked_sessions) == set(eng.parked_sessions)
    assert len(res.pending) == len(eng.pending) == 1
    for sid in eng.parked_sessions:
        assert res.store.tier_of(sid) == eng.store.tier_of(sid)
    assert res.store.stats()["epoch"] == eng.store.stats()["epoch"] + 1
    assert res.cost_model.key == eng.cost_model.key == ("cpu", 24, 1)
    assert res.cost_model.n_observations == eng.cost_model.n_observations > 0
    assert res._autotune and res.max_slots == 3
    a, b = _continue(eng, sids), _continue(res, sids)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_crosses_packages(direction):
    """One package snapshots mid-workload, the other restores it; both
    continue the workload and agree to 1e-9."""
    jp, jr, tp, tr = _models()
    if direction == "jax_to_port":
        writer = _paged(JaxEngine, jp, jr)
    else:
        writer = _paged(ReservoirEngine, tp, tr, device="cpu")
    sids = _mid_workload(writer)
    path = writer.snapshot(_snap_dir())
    if direction == "jax_to_port":
        reader = ReservoirEngine.restore(path, device="cpu")
    else:
        reader = JaxEngine.restore(path)
    assert set(reader.parked_sessions) == set(writer.parked_sessions)
    assert set(reader.active_sessions) == set(writer.active_sessions)
    assert reader.store.epoch == writer.store.epoch + 1
    assert tuple(reader.cost_model.key) == tuple(writer.cost_model.key)
    a, b = _continue(writer, sids), _continue(reader, sids)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, **TOL)


def test_auto_decode_wave_tokens_survives_the_round_trip():
    _, _, tp, tr = _models()
    eng = ReservoirEngine(tp, 2, readout=tr, decode_wave_tokens="auto",
                          device="cpu")
    res = ReservoirEngine.restore(eng.snapshot(_snap_dir()), device="cpu")
    assert res._exec._decode_k_auto and res.cost_model is not None


def test_restore_refuses_bad_snapshots():
    _, _, tp, tr = _models()
    eng = ReservoirEngine(tp, 2, readout=tr, device="cpu")
    path = eng.snapshot(_snap_dir())
    os.remove(os.path.join(path, "_COMPLETE"))
    with pytest.raises(FileNotFoundError, match="_COMPLETE"):
        ReservoirEngine.restore(path, device="cpu")
    path = eng.snapshot(_snap_dir())
    man = os.path.join(path, "manifest.json")
    with open(man) as f:
        m = json.load(f)
    m["version"] = 2
    with open(man, "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="version"):
        ReservoirEngine.restore(path, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        ReservoirEngine.restore(eng.snapshot(_snap_dir()), mesh=object())


def test_jax_snapshot_with_learn_state_is_refused_naming_a9():
    jp, jr, _, _ = _models()
    je = JaxEngine(jp, max_slots=2, readout=jr, learn=True)
    je.submit("live", SIG[:64, None], tenant="t")
    je.flush()
    for t in range(64, 72):
        je.decode_step({"live": SIG[t, None]})
        je.observe("live", SIG[t + 1, None])
    path = je.snapshot(_snap_dir())
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["learn_state"]
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        ReservoirEngine.restore(path, device="cpu")


def test_port_snapshot_holds_no_learn_state_and_cpu_tensors_restore():
    """The port writes ``learn: false`` and empty learn fields; restored
    tensors land on the requested device with the snapshot's values."""
    _, _, tp, tr = _models()
    eng = ReservoirEngine(tp, 2, readout=tr, device="cpu")
    eng.submit("a", SIG[:40, None])
    eng.flush()
    path = eng.snapshot(_snap_dir())
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    assert m["engine"]["learn"] is False
    assert m["learn_state"] == [] and m["readout_pools"] == []
    res = ReservoirEngine.restore(path, device="cpu")
    assert res.states.device == torch.device("cpu")
    assert torch.equal(res.states, eng.states)
    assert torch.equal(res.readout.w_out, eng.readout.w_out)


def test_restore_defaults_to_the_gpu(monkeypatch):
    """``restore`` is an entry point: without ``device=`` it places the
    engine on the GPU, and raises where there is none."""
    _, _, tp, tr = _models()
    path = ReservoirEngine(tp, 2, readout=tr, device="cpu").snapshot(
        _snap_dir())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReservoirEngine.restore(path)
