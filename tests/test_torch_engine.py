"""Port parity: the serving engine against the JAX ``ReservoirEngine``.

Both engines get the same params and readout (carried over with
``params_from_numpy`` / ``readout_from_numpy``) and the same mixed-length
workload: prompts whose buckets resolve to the sequential, associative and
chunked scans, a chunked long prompt (``chunk_max``), open-loop
``decode_step``, fused ``decode_closed_loop``, and ``release``.  Outputs and
released states agree to 1e-9 (float64 rounding carried through the
recurrence and the closed loop).  Inside the port, ``pipeline_depth`` 0 and
2 are bit-equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import esn as jesn
from repro.core import params as jparams
from repro.serve.engine import ReservoirEngine as JaxEngine
from repro_torch.core import params as tparams
from repro_torch.data.signals import mso_series
from repro_torch.launch import serve as tserve
from repro_torch.serve.cost import WaveCostModel
from repro_torch.serve.engine import ReservoirEngine

TOL = dict(rtol=1e-9, atol=1e-9)
SIG = mso_series(3, 2001)
# Buckets 32 / 128 / 512 / 512+128 (chunk_max=400) / 64: the sequential,
# associative and chunked scans, and a chunked long prompt.
LENGTHS = (20, 100, 300, 520, 45)

MODELS = {
    "dpg": dict(n=48, leak=0.9, input_scaling=0.5, seed=0),
    "dpg-fb": dict(n=40, leak=0.9, use_feedback=True, feedback_scaling=0.3,
                   seed=1),
    "standard": dict(n=32, spectral_radius=0.9, seed=2),
}


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _models(name):
    """(jax params, jax readout, port params, port readout), the port's
    carried over from the JAX structs."""
    jc = jparams.ESNConfig(**MODELS[name])
    jp = (jesn.standard_params(jc) if name == "standard"
          else jesn.dpg_params(jc, sigma=0.1))
    u, y = SIG[:-1, None], SIG[1:, None]
    jr = jesn.fit(jp, u, y, washout=100)
    names = ("w", "w_in", "w_fb") if jp.mode == "standard" else (
        "lam_q", "win_q", "wfb_q", "qtq")
    arrays = {k: None if getattr(jp, k) is None else np.asarray(getattr(jp, k))
              for k in names}
    tp = tparams.params_from_numpy(jp.mode, arrays, dataclasses.asdict(jc),
                                   n_real=getattr(jp, "n_real", None),
                                   device="cpu")
    tr = tparams.readout_from_numpy(np.asarray(jr.w_out), device="cpu")
    return jp, jr, tp, tr


def workload(engine, fb: bool):
    """The mixed workload; returns every output in order as numpy."""
    rec = []

    def prompt(i, t, off=0):
        lo = 7 * i + off
        kw = {"y_teacher": SIG[lo + 1:lo + 1 + t, None]} if fb else {}
        engine.submit(i, SIG[lo:lo + t, None], **kw)

    for i, t in enumerate(LENGTHS[:3]):
        prompt(i, t)
    outs = engine.flush(want_outputs=True)
    rec += [_np(outs[i]) for i in sorted(outs)]
    for t in range(3):
        step = engine.decode_step({0: SIG[t, None], 2: SIG[t + 1, None]})
        rec += [_np(step[0]), _np(step[2])]
    ys = engine.decode_closed_loop(8)
    rec += [_np(ys[s]) for s in sorted(ys)]
    for sid in (1, 2):
        st, y = engine.release(sid)
        rec += [_np(st), _np(y)]
    for i, t in enumerate(LENGTHS[3:], start=3):
        prompt(i, t, off=11)
    engine.flush()
    assert not len(engine.pending)
    ys = engine.decode_closed_loop(12, sids=[3, 4, 0])
    rec += [_np(ys[s]) for s in (3, 4, 0)]
    for sid in sorted(engine.active_sessions):
        st, y = engine.release(sid)
        rec += [_np(st), _np(y)]
    return rec


@pytest.mark.parametrize("name", list(MODELS))
def test_engine_matches_jax_engine(name):
    jp, jr, tp, tr = _models(name)
    fb = jp.cfg.use_feedback
    want = workload(JaxEngine(jp, 3, readout=jr, chunk_max=400), fb)
    got = workload(ReservoirEngine(tp, 3, readout=tr, chunk_max=400,
                                   device="cpu"), fb)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def test_pipeline_depths_bit_equal():
    _, _, tp, tr = _models("dpg")
    runs = [workload(ReservoirEngine(tp, 3, readout=tr, chunk_max=400,
                                     pipeline_depth=d, device="cpu"), False)
            for d in (0, 2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_prompt", [False, True])
def test_state_released_by_jax_continues_in_port(with_prompt):
    jp, jr, tp, tr = _models("dpg")
    je = JaxEngine(jp, 2, readout=jr)
    je.submit("s", SIG[:300, None])
    je.flush()
    je.decode_closed_loop(5)
    h, y = je.release("s")
    h, y = np.asarray(h), np.asarray(y)
    te = ReservoirEngine(tp, 2, readout=tr, device="cpu")
    u = SIG[300:340, None] if with_prompt else None
    for eng in (je, te):
        eng.submit("s", u, h0=h, y0=y)
        eng.flush()
    np.testing.assert_allclose(te.state_of("s"), np.asarray(je.state_of("s")),
                               **TOL)
    np.testing.assert_allclose(_np(te.decode_closed_loop(10)["s"]),
                               np.asarray(je.decode_closed_loop(10)["s"]),
                               **TOL)


def test_engine_stats_and_collect():
    _, _, tp, tr = _models("dpg")
    eng = ReservoirEngine(tp, 2, readout=tr, device="cpu")
    for i in range(3):
        eng.submit(i, SIG[:64, None])
    eng.flush()
    assert len(eng.pending) == 1 and eng.ready_sessions == [0, 1]
    eng.decode_closed_loop(4)
    eng.decode_step({0: SIG[:1]})
    res = eng.collect_decoded()
    assert res[0].shape == (5, 1) and res[1].shape == (4, 1)
    assert [w["kind"] for w in res.waves] == ["closed_loop", "step"]
    st = eng.stats()
    assert st.waves_total == 1 and st.prefill_tokens == 128
    assert st.decode_tokens == 9 and st.sessions_queued == 1
    eng.release(0)
    eng.flush()
    assert eng.ready_sessions == [2, 1] and eng.stats().waves_total == 2
    eng.reset()
    assert not eng.active_sessions and not len(eng.pending)


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(autotune=True),
                                dict(cost_model=WaveCostModel()),
                                dict(decode_slo_us=100.0),
                                dict(park_host_rows=4), dict(cold_dir="x"),
                                dict(learn=True), dict(profile_dir="x"),
                                dict(decode_wave_tokens="auto"),
                                dict(ensemble="mean")])
def test_unported_options_name_their_roadmap_item(kw):
    """Every option is ported and builds (``mesh`` takes a
    ``launch.mesh.Mesh`` and raises ``TypeError`` on anything else;
    ``ensemble`` on a non-batched engine is refused as the JAX engine
    refuses it, and so is ``cold_dir`` without ``park_host_rows``;
    ``park_host_rows`` builds a store and a cost model; ``learn`` builds an
    engine with an enabled learn plane and a cost model that prices its
    refit waves)."""
    _, _, tp, tr = _models("dpg")
    (name, value), = kw.items()
    if name == "mesh":
        with pytest.raises(TypeError, match="launch.mesh.Mesh"):
            ReservoirEngine(tp, 2, readout=tr, device="cpu", **kw)
    elif name == "ensemble":
        with pytest.raises(ValueError, match="param-batched"):
            ReservoirEngine(tp, 2, readout=tr, device="cpu", **kw)
    elif name == "cold_dir":
        with pytest.raises(ValueError, match="cold_dir needs park_host_rows"):
            ReservoirEngine(tp, 2, readout=tr, device="cpu", **kw)
    else:
        eng = ReservoirEngine(tp, 2, readout=tr, device="cpu", **kw)
        assert eng.cost_model is not None or name == "profile_dir"
        assert (eng.store is not None) == (name == "park_host_rows")
        assert eng._learn_plane.enabled == (name == "learn")
        if eng.store is not None:
            assert eng.store.pool.rows == 4
            assert eng.cost_model.key == ("cpu", 48, 1)


def test_from_param_batch_not_ported():
    """from_param_batch is ported: it takes a stacked struct only (a single
    reservoir is refused) and binds slot i to reservoir i."""
    _, _, tp, tr = _models("dpg")
    with pytest.raises(ValueError, match="stacked param struct"):
        ReservoirEngine.from_param_batch(tp, readout=tr, device="cpu")
    eng = ReservoirEngine.from_param_batch(
        tparams.stack_params([tp, tp]),
        tparams.Readout(torch.stack([tr.w_out, tr.w_out])), device="cpu")
    assert eng.param_batched and eng.max_slots == 2


def test_serve_driver_runs_on_cpu_and_rejects_unported_flags():
    res = tserve.main(["--reservoir", "--n", "32", "--slots", "2",
                       "--sessions", "3", "--prompt-len", "40", "--gen", "4",
                       "--device", "cpu"])
    assert res["sessions"] == 3 and res["finite"]
    assert res["prefill_tokens"] == 120 and res["decode_tokens"] == 12
    # --mesh is ported: a 1x1 mesh serves the same workload.
    meshed = tserve.main(["--reservoir", "--n", "32", "--slots", "2",
                          "--sessions", "3", "--prompt-len", "40", "--gen",
                          "4", "--device", "cpu", "--mesh", "1x1"])
    assert all(meshed[k] == res[k] for k in ("sessions", "prefill_tokens",
                                             "decode_tokens", "finite"))
    res = tserve.main(["--reservoir", "--n", "32", "--slots", "2",
                       "--prompt-len", "40", "--gen", "4", "--learn",
                       "--refit-every", "8", "--device", "cpu"])
    assert res["teacher_tokens"] == 64 and res["finite"]
    assert res["refit_waves"] == res["refit_rows"] == 8
    assert res["rmse_second_half"] <= res["rmse_first_half"]
    # Without --reservoir the LM loop runs: its default arch,
    # recurrentgemma-2b, serves, and so does an MoE arch; an
    # encoder-decoder exits with the JAX driver's message.
    res = tserve.main(["--smoke", "--batch", "2", "--prompt-len", "3",
                       "--gen", "2", "--device", "cpu"])
    assert res["arch"] == "recurrentgemma-2b" and res["finite"]
    with pytest.raises(SystemExit, match="enc-dec serving needs audio "
                                         "frames"):
        tserve.main(["--arch", "whisper-tiny", "--device", "cpu"])
    res = tserve.main(["--arch", "kimi-k2-1t-a32b", "--smoke", "--batch",
                       "2", "--prompt-len", "3", "--gen", "2", "--device",
                       "cpu"])
    assert res["arch"] == "kimi-k2-1t-a32b" and res["finite"]


def test_paged_serve_driver_on_cpu_restores_its_snapshot(tmp_path):
    """The driver with the tiered store: 7 sessions through 2 hot slots, 2
    host rows and a cold dir, the engine snapshotted at the end; the
    snapshot restores and serves on."""
    snap = str(tmp_path / "engine")
    res = tserve.main(["--reservoir", "--n", "32", "--slots", "2",
                       "--sessions", "7", "--prompt-len", "40", "--gen", "4",
                       "--park-host-rows", "2",
                       "--cold-dir", str(tmp_path / "cold"),
                       "--snapshot", snap, "--device", "cpu"])
    assert res["sessions"] == 7 and res["finite"]
    assert res["tiers_after_admission"]["host"] == 2
    assert res["tiers_after_admission"]["cold"] == 3
    assert res["demote_waves"] == res["promote_waves"] == 3
    assert res["page_rows"] == 10 and res["snapshot"] == snap
    eng = ReservoirEngine.restore(snap, device="cpu")
    assert eng.store.epoch == 1 and eng.store.pool.rows == 2
    eng.submit("late", SIG[:40, None])
    eng.flush()
    assert np.isfinite(_np(eng.decode_closed_loop(4)["late"])).all()
    with pytest.raises(SystemExit, match="cold_dir needs park_host_rows"):
        tserve.main(["--reservoir", "--device", "cpu", "--cold-dir", "x"])
    with pytest.raises(SystemExit, match="param-batched engine"):
        tserve.main(["--reservoir", "--device", "cpu", "--n", "32",
                     "--slots", "2", "--ensemble", "mean",
                     "--park-host-rows", "2"])


def test_engine_matches_jax_engine_at_16_outputs():
    """A closed loop of 16 outputs fed back (the card serves it through
    B2's wide family): the port's engine against the JAX engine on the
    CPU, 4 slots of teacher-forced prompts then 6 closed-loop tokens, every
    stream and released state within 1e-9 x max(|ref|, 1)."""
    d, t = 16, 2001
    sig = np.stack([mso_series(1 + i % 12, t + i)[i:] for i in range(d)], -1)
    jc = jparams.ESNConfig(n=40, d_in=d, d_out=d, leak=0.9,
                           input_scaling=0.5, use_feedback=True,
                           feedback_scaling=0.3, seed=4)
    jp = jesn.dpg_params(jc, sigma=0.1)
    jr = jesn.fit(jp, sig[:-1], sig[1:], washout=100)
    arrays = {k: np.asarray(getattr(jp, k))
              for k in ("lam_q", "win_q", "wfb_q", "qtq")}
    tp = tparams.params_from_numpy(jp.mode, arrays, dataclasses.asdict(jc),
                                   n_real=jp.n_real, device="cpu")
    tr = tparams.readout_from_numpy(np.asarray(jr.w_out), device="cpu")

    def run(engine):
        rec = []
        for i in range(4):
            lo = 37 * i
            engine.submit(i, sig[lo:lo + 60], y_teacher=sig[lo + 1:lo + 61])
        engine.flush()
        ys = engine.decode_closed_loop(6)
        rec += [_np(ys[s]) for s in sorted(ys)]
        for sid in range(4):
            rec += [_np(v) for v in engine.release(sid)]
        return rec
    want = run(JaxEngine(jp, 4, readout=jr))
    got = run(ReservoirEngine(tp, 4, readout=tr, device="cpu"))
    assert len(got) == len(want) == 12
    assert want[0].shape == (6, d)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-9 * max(np.abs(w).max(), 1.0))
