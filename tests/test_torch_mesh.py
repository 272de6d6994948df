"""Port parity: device meshes (``launch.mesh``) and the engine's ``mesh=``
around the sharded arena — the driver's ``--mesh``, paging, a learn
refit and snapshots across meshes and across the two packages.

Meshes here are logical CPU meshes (one device repeated), on which every
shard runs the real sharded code path.  Sharded engines match the JAX
package's plain engines to 1e-9 * max(|ref|, 1) (``test_torch_engine.py``'s
float64 tolerance, scaled as the served states grow); refit solves of
equal statistics to 1e-5 of the largest |w| (``test_torch_learn.py``).
"""
import numpy as np
import pytest
import torch

from repro.serve.engine import ReservoirEngine as JaxEngine
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import Mesh, check_mesh, make_local_mesh
from repro_torch.serve.engine import ReservoirEngine

from test_torch_learn import _admit, _close_rel, _pair, _stream
from test_torch_snapshot import _continue, _mid_workload, _paged, _snap_dir
from test_torch_store import SIG, _cold, _models, _np


def cpu_mesh(d, m):
    return make_local_mesh(d, m, devices=["cpu"] * (d * m))


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert float(err.max(initial=0.0)) <= 1e-9, float(err.max())


# -------------------------------------------------------------------- mesh
def test_make_local_mesh():
    mesh = cpu_mesh(2, 3)
    assert isinstance(mesh, Mesh) and mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 2, "model": 3} and mesh.size == 6
    assert mesh.devices.shape == (2, 3) and mesh.home == torch.device("cpu")
    with pytest.raises(ValueError, match="one device type"):
        make_local_mesh(1, 2, devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="needs 4 devices, got 2"):
        make_local_mesh(2, 2, devices=["cpu", "cpu"])
    # Without devices: the first D*M CUDA devices, or a ValueError naming
    # the count.
    need = torch.cuda.device_count() + 1 if torch.cuda.is_available() else 1
    with pytest.raises(ValueError, match=f"needs {need} CUDA devices"):
        make_local_mesh(need, 1)
    assert check_mesh(mesh) is mesh
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        check_mesh((2, 1))


def test_engine_mesh_device_must_share_the_mesh_type():
    _, _, tp, tr = _models()
    eng = ReservoirEngine(tp, 4, readout=tr, mesh=cpu_mesh(2, 1))
    assert eng.device == torch.device("cpu") and eng.mesh.shape["data"] == 2
    with pytest.raises(ValueError, match="mesh's device type"):
        ReservoirEngine(tp, 4, readout=tr, device="meta", mesh=cpu_mesh(2, 1))


# ------------------------------------------------------------------ driver
def _driver(argv, monkeypatch):
    """Run the reservoir driver and record every closed-loop token and
    released state, in order."""
    rec = []
    loop, release = (ReservoirEngine.decode_closed_loop,
                     ReservoirEngine.release)

    def looped(self, *a, **kw):
        out = loop(self, *a, **kw)
        rec.extend(_np(out[s]) for s in out)
        return out

    def released(self, sid, **kw):
        out = release(self, sid, **kw)
        rec.extend(_np(v) for v in out[:2])
        return out
    monkeypatch.setattr(ReservoirEngine, "decode_closed_loop", looped)
    monkeypatch.setattr(ReservoirEngine, "release", released)
    res = tserve.main(argv)
    monkeypatch.undo()
    return res, rec


def test_driver_mesh_1x1_equals_no_mesh_and_2x1_serves(monkeypatch, capsys):
    argv = ["--reservoir", "--n", "32", "--slots", "4", "--sessions", "6",
            "--prompt-len", "40", "--gen", "8", "--device", "cpu"]
    res, want = _driver(argv, monkeypatch)
    res1, got = _driver(argv + ["--mesh", "1x1"], monkeypatch)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert "arena mesh: (1, 1) over (data, model)" in capsys.readouterr().out
    res2, got2 = _driver(argv + ["--mesh", "2x1"], monkeypatch)
    assert res2["sessions"] == 6 and res2["finite"]
    for g, w in zip(got2, want):
        close(g, w)


# ------------------------------------------------------------------ paging
def _paged_workload(eng):
    """8 prompts through a 4-slot arena over a 4-row host pool and a cold
    dir: admission parks the LRU sessions, decoding them promotes."""
    out = []
    for i in range(8):
        eng.submit(f"s{i}", SIG[40 + 9 * i:40 + 9 * i + 24, None])
    eng.flush()
    for i in (0, 5, 2, 7):
        out.append(_np(eng.decode_closed_loop(3, sids=[f"s{i}"])[f"s{i}"]))
    out += [_np(eng.state_of(f"s{i}")) for i in range(8)]
    for i in (1, 6):
        st, y = eng.release(f"s{i}")
        out += [_np(st), _np(y)]
    return out


def test_paged_engine_on_a_2x1_mesh_matches_jax():
    jp, jr, tp, tr = _models()
    want = _paged_workload(JaxEngine(jp, max_slots=4, readout=jr,
                                     park_host_rows=4, cold_dir=_cold()))
    eng = ReservoirEngine(tp, 4, readout=tr, park_host_rows=4,
                          cold_dir=_cold(), mesh=cpu_mesh(2, 1))
    got = _paged_workload(eng)
    for g, w in zip(got, want):
        close(g, w)
    st = eng.stats()
    assert st.demote_waves > 0 and st.promote_waves > 0


# ------------------------------------------------------------------- learn
def test_refit_on_a_1x2_mesh_matches_jax():
    """One learning session on a split model axis: its open-loop
    predictions match the JAX learn engine, its streamed refit matches
    JAX's solve and is served from the next step."""
    jm, tp, tr = _pair(True, "diag")
    port = ReservoirEngine(tp, 2, readout=tr, learn=True, refit_washout=0,
                           mesh=cpu_mesh(1, 2))
    jax_eng = JaxEngine(jm, max_slots=2, learn=True, refit_washout=0)
    preds = {}
    for name, eng in (("port", port), ("jax", jax_eng)):
        _admit(eng, "s", 60, True)
        preds[name] = [_np(eng.decode_step({"s": SIG[t, None]})["s"])
                       for t in range(60, 64)]
        _stream(eng, "s", 64, 160)
    for g, w in zip(preds["port"], preds["jax"]):
        close(g, w)
    w = _np(port.refit()["s"])
    _close_rel(w, jax_eng.refit()["s"], 1e-5)
    np.testing.assert_array_equal(_np(port.readout_for("s")), w)


# --------------------------------------------------------------- snapshots
@pytest.mark.parametrize("restore_mesh", [None, (1, 2)])
def test_sharded_snapshot_restores_on_other_meshes(restore_mesh):
    """A 3-slot paged engine on (2, 1) (3 slots do not split over 2 data
    shards: the data axis is replicated) snapshots mid-workload; restored
    unsharded or on (1, 2) it continues as the uninterrupted engine."""
    _, _, tp, tr = _models()
    eng = _paged(ReservoirEngine, tp, tr, mesh=cpu_mesh(2, 1))
    sids = _mid_workload(eng)
    path = eng.snapshot(_snap_dir())
    res = ReservoirEngine.restore(
        path, device="cpu",
        mesh=None if restore_mesh is None else cpu_mesh(*restore_mesh))
    assert set(res.active_sessions) == set(eng.active_sessions)
    assert (res.mesh is None) == (restore_mesh is None)
    a, b = _continue(eng, sids), _continue(res, sids)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        close(y, x)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_crosses_packages_and_meshes(direction):
    """A JAX snapshot restored onto a (2, 2) mesh, and a (2, 2) engine's
    snapshot (whole arrays, no shard layout) restored by the JAX engine;
    both continue the workload as their writer does."""
    jp, jr, tp, tr = _models()
    if direction == "jax_to_port":
        writer = JaxEngine(jp, max_slots=4, readout=jr, park_host_rows=4,
                           cold_dir=_cold())
    else:
        writer = ReservoirEngine(tp, 4, readout=tr, park_host_rows=4,
                                 cold_dir=_cold(), mesh=cpu_mesh(2, 2))
    sids = _mid_workload(writer)
    path = writer.snapshot(_snap_dir())
    reader = (ReservoirEngine.restore(path, mesh=cpu_mesh(2, 2))
              if direction == "jax_to_port" else JaxEngine.restore(path))
    assert set(reader.parked_sessions) == set(writer.parked_sessions)
    a, b = _continue(writer, sids), _continue(reader, sids)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        close(y, x)
