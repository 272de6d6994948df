"""Port parity: engine snapshots, in the port and across the two packages.

A snapshot is one directory (``manifest.json``, ``arrays.npz``,
``cost.json``, ``_COMPLETE``) in the JAX package's layout.  Inside the port
a restored engine resumes mid-workload (hot sessions, parked sessions in
both tiers, a queued prompt, uncollected decode tokens) bit-equal to the
engine that was not snapshotted.  A snapshot written by the JAX engine
restores in the port and continues to match the JAX engine, and one written
by the port restores in the JAX engine, at ``test_torch_engine.py``'s
tolerance (1e-9).  Snapshots carry the learn plane's state (tenant pools,
folded Gram statistics, pairing counters) both ways between the packages;
``tests/test_torch_learn.py`` holds their continuations.
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
    # mesh= is ported: it takes a launch.mesh.Mesh and nothing else.
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        ReservoirEngine.restore(eng.snapshot(_snap_dir()), mesh=object())


def test_jax_snapshot_with_learn_state_is_refused_naming_a9():
    """Since the learn plane is ported (A9) a JAX snapshot with learn state
    is no longer refused: it restores into the port with its tenant, its
    folded (G, C) and its pairing state, and resumes as the JAX engine does
    (1e-9; the refit solves of equal statistics to 1e-5 of the largest
    |w|: 16 rows of 25 features at alpha 1e-8 leave the system
    ill-conditioned, and the two Cholesky implementations round apart)."""
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
    res = ReservoirEngine.restore(path, device="cpu")
    ls, jls = res._learn_state["live"], je._learn_state["live"]
    assert (ls.tenant, ls.acc.pairs, ls.dirty) == ("t", 8, True)
    np.testing.assert_allclose(_np(ls.acc.gram), np.asarray(jls.acc.gram),
                               **TOL)
    for t in range(72, 80):
        outs = [e.decode_step({"live": SIG[t, None]})["live"]
                for e in (res, je)]
        np.testing.assert_allclose(_np(outs[0]), np.asarray(outs[1]), **TOL)
        for e in (res, je):
            e.observe("live", SIG[t + 1, None])
    w, wj = _np(res.refit()["live"]), np.asarray(je.refit()["live"])
    np.testing.assert_allclose(w, wj, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(wj).max()))


def test_port_snapshot_holds_no_learn_state_and_cpu_tensors_restore():
    """An engine without learning writes ``learn: false`` and empty learn
    fields; a learn engine writes its knobs, pools and per-session state in
    the JAX layout.  Restored tensors land on the requested device with
    the snapshot's values."""
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
    learner = ReservoirEngine(tp, 2, readout=tr, learn=True, refit_washout=2,
                              drift_threshold=0.5, device="cpu")
    learner.submit("a", SIG[:40, None], tenant="T")
    learner.flush()
    for t in range(40, 60):
        learner.decode_step({"a": SIG[t, None]})
        learner.observe("a", SIG[t + 1, None])
    learner.refit("a")
    path = learner.snapshot(_snap_dir())
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    ek = m["engine"]
    assert (ek["learn"], ek["refit_washout"], ek["drift_threshold"]) == \
        (True, 2, 0.5)
    assert m["readout_pools"] == [{"key": "T"}]
    (rec,) = m["learn_state"]
    assert (rec["sid"], rec["tenant"], rec["pairs"], rec["gram"]) == \
        ("a", "T", 18, True)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert {"pool0/w", "learn0/gram", "learn0/cg"} <= set(z.files)
    res = ReservoirEngine.restore(path, device="cpu")
    assert torch.equal(res.readout_for("a"), learner.readout_for("a"))


def test_restore_defaults_to_the_gpu(monkeypatch):
    """``restore`` is an entry point: without ``device=`` it places the
    engine on the GPU, and raises where there is none."""
    _, _, tp, tr = _models()
    path = ReservoirEngine(tp, 2, readout=tr, device="cpu").snapshot(
        _snap_dir())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReservoirEngine.restore(path)
