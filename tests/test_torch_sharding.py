"""Port parity: the sharded slot arena (``sharding.rules.plan_arena``,
``serve.arena.ShardedArena``, the engine's ``mesh=``).

The port's plans equal the JAX package's leaf by leaf (spec for spec) for
diag, standard and param-batched params at (1, 1), (2, 1), (1, 2) and
(2, 2), with an N that divides the model axis and one that does not; the
JAX plans come from one subprocess on 4 placeholder host devices.  On
logical CPU meshes (one device repeated: each shard runs its own launches)
a 1x1 engine is bit-equal to ``mesh=None``, and the JAX package's
``tests/serve_sharded_check.py`` workload on (2, 1), (1, 2) and (2, 2) — a
cut inside an (re, im) pair of the packed Q basis included — matches the
JAX package's plain engine and the port's unsharded engine to
1e-9 * max(|ref|, 1) in float64 (the per-shard readout sums in another
order); so do param batches under ``ensemble`` mean and weighted.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import esn as jesn
from repro.core import params as jparams
from repro.serve.engine import ReservoirEngine as JaxEngine
from repro_torch.core import params as tparams
from repro_torch.data.signals import mso_series
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.serve.engine import ReservoirEngine
from repro_torch.sharding import rules

SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2)]
CFG = dict(n=32, d_in=1, d_out=1, spectral_radius=0.9, leak=0.8,
           input_scaling=0.5, ridge_alpha=1e-8, seed=7)
SIG = mso_series(3, 401)
U, Y = SIG[:-1, None], SIG[1:, None]


def cpu_mesh(d, m):
    return make_local_mesh(d, m, devices=["cpu"] * (d * m))


def close(got, want):
    """Elementwise within 1e-9 * max(|ref|, 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert float(err.max(initial=0.0)) <= 1e-9, float(err.max())


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else (
        np.asarray(v))


def models(mode, n=32):
    """(jax params, jax readout, port params, port readout) of the sharded
    check's model, the port's carried over from the JAX structs."""
    jc = jparams.ESNConfig(**dict(CFG, n=n))
    jp = jesn.diag_params(jc) if mode == "diag" else jesn.standard_params(jc)
    jr = jesn.fit(jp, U[:300], Y[:300], washout=50)
    names = ("lam_q", "win_q", "wfb_q", "qtq") if mode == "diag" else (
        "w", "w_in", "w_fb")
    arrays = {k: None if getattr(jp, k) is None else np.asarray(
        getattr(jp, k)) for k in names}
    tp = tparams.params_from_numpy(mode, arrays, dataclasses.asdict(jc),
                                   n_real=getattr(jp, "n_real", None),
                                   device="cpu")
    return jp, jr, tp, tparams.readout_from_numpy(np.asarray(jr.w_out),
                                                  device="cpu")


def sharded_workload(eng):
    """``tests/serve_sharded_check.py``'s workload: 4 mixed-length prompts
    in one bucket, 10 open-loop steps, 25 closed-loop tokens; then the
    full arena.  Every output as numpy, in order."""
    for i in range(4):
        eng.submit(i, U[10 * i:10 * i + 64 + i])
    eng.flush()
    out = [_np(eng.state_of(i)) for i in range(4)]
    for t in range(80, 90):
        got = eng.decode_step({i: U[t] for i in range(4)})
        out += [_np(got[i]) for i in range(4)]
    got = eng.decode_closed_loop(25)
    out += [_np(got[i]) for i in range(4)]
    out += [_np(eng.states), _np(eng.y_prev)]
    return out


# ------------------------------------------------------------------ plans
_JAX_PLANS = r"""
import json, jax
jax.config.update("jax_enable_x64", True)
from repro.core import esn, params as P
from repro.launch.mesh import make_local_mesh
from repro.sharding.rules import plan_arena
def spec(s):
    return None if s is None else [a if a is None else str(a)
                                   for a in s.spec]
out = {}
for n in (32, 33):
    cfg = P.ESNConfig(n=n, seed=3)
    d, s = esn.diag_params(cfg), esn.standard_params(cfg)
    w = jax.numpy.zeros((cfg.n_features, 1))
    kinds = {"diag": (d, False, w), "standard": (s, False, w),
             "diag-batched": (P.stack_params([d] * 4), True,
                              jax.numpy.zeros((4, cfg.n_features, 1))),
             "standard-batched": (P.stack_params([s] * 4), True,
                                  jax.numpy.zeros((4, cfg.n_features, 1)))}
    for dm in ((1, 1), (2, 1), (1, 2), (2, 2)):
        mesh = make_local_mesh(*dm)
        for kind, (p, batched, ro) in kinds.items():
            plan = plan_arena(mesh, p, 4, batched=batched, readout=ro)
            leaves = {f: spec(getattr(plan.params, f)) for f in
                      (("lam_q", "win_q", "wfb_q", "qtq") if p.mode == "diag"
                       else ("w", "w_in", "w_fb"))}
            out[f"{n}/{dm[0]}x{dm[1]}/{kind}"] = {
                "arena": {k: spec(v) for k, v in plan.arena.items()},
                "params": leaves, "readout": spec(plan.readout)}
print("PLANS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_plans():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", _JAX_PLANS], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(s for s in out.stdout.splitlines() if s.startswith("PLANS "))
    return json.loads(line[len("PLANS "):])


def _port_plan(n, dm, kind):
    cfg = tparams.ESNConfig(n=n, seed=3)
    from repro_torch.core import esn as tesn
    p = (tesn.diag_params(cfg, device="cpu") if kind.startswith("diag")
         else tesn.standard_params(cfg, device="cpu"))
    batched = kind.endswith("batched")
    ro = torch.zeros((cfg.n_features, 1), dtype=torch.float64)
    if batched:
        p, ro = tparams.stack_params([p] * 4), torch.stack([ro] * 4)
    plan = rules.plan_arena(cpu_mesh(*dm), p, 4, batched=batched, readout=ro)
    names = (("lam_q", "win_q", "wfb_q", "qtq") if p.mode == "diag"
             else ("w", "w_in", "w_fb"))

    def spec(s):
        return None if s is None else list(s.spec)
    return {"arena": {k: spec(v) for k, v in plan.arena.items()},
            "params": {f: spec(getattr(plan.params, f)) for f in names},
            "readout": spec(plan.readout)}


@pytest.mark.parametrize("kind", ["diag", "standard", "diag-batched",
                                  "standard-batched"])
@pytest.mark.parametrize("dm", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("n", [32, 33])
def test_plan_arena_specs_equal_jax(jax_plans, n, dm, kind):
    assert _port_plan(n, dm, kind) == jax_plans[f"{n}/{dm[0]}x{dm[1]}/{kind}"]


def test_sharding_split_join_and_the_pair_cut():
    """``Sharding.split`` puts each cell's block on its device and ``join``
    reassembles it; a cut inside an (re, im) pair moves one column on, so
    each model shard is a packed-Q problem with its own ``n_real`` (the
    specs stay JAX's)."""
    from repro_torch.core import esn as tesn
    tp = tesn.diag_params(tparams.ESNConfig(**dict(CFG, n=30)), device="cpu")
    assert tp.n_real == 6                       # 6 reals, 12 pairs
    plan = rules.plan_arena(cpu_mesh(2, 2), tp, 4)
    assert plan.col_bounds == (0, 16, 30) and plan.n_real == (6, 0)
    assert plan.params.lam_q.spec == ("model",)
    x = torch.arange(4 * 30, dtype=torch.float64).reshape(4, 30)
    sh = plan.arena["states"]
    parts = sh.split(x)
    assert parts.shape == (2, 2) and parts[1, 1].shape == (2, 14)
    torch.testing.assert_close(parts[1, 0], x[2:, :16], rtol=0, atol=0)
    torch.testing.assert_close(sh.join(parts, "cpu"), x, rtol=0, atol=0)
    rep = plan.arena["y_prev"].split(x[:, :1])
    torch.testing.assert_close(rep[0, 1], x[:2, :1], rtol=0, atol=0)


# ----------------------------------------------------------------- engines
@pytest.mark.parametrize("mode", ["diag", "standard"])
def test_sharded_arena_1x1_matches_plain_engine(mode):
    """JAX's ``test_sharded_arena_1x1_matches_plain_engine``, at atol 0:
    prefill states, ``decode_step`` and ``decode_closed_loop`` on a 1x1
    mesh are bit-equal to ``mesh=None``."""
    _, _, tp, tr = models(mode)
    want = sharded_workload(ReservoirEngine(tp, 4, readout=tr, device="cpu"))
    got = sharded_workload(ReservoirEngine(tp, 4, readout=tr,
                                           mesh=cpu_mesh(1, 1)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def references():
    """(mode, n) -> (port params, readout, JAX plain engine's outputs, the
    port's unsharded outputs)."""
    out = {}
    for mode, n in (("diag", 32), ("standard", 32), ("diag", 30)):
        jp, jr, tp, tr = models(mode, n)
        out[mode, n] = (tp, tr,
                        sharded_workload(JaxEngine(jp, max_slots=4,
                                                   readout=jr)),
                        sharded_workload(ReservoirEngine(
                            tp, 4, readout=tr, device="cpu")))
    return out


@pytest.mark.parametrize("dm", SHAPES[1:], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode,n", [("diag", 32), ("standard", 32),
                                    ("diag", 30)])
def test_sharded_arena_matches_jax_plain_engine(references, mode, n, dm):
    """The sharded check's workload on a logical CPU mesh against the JAX
    plain engine and the port's unsharded engine; n = 30 on a split model
    axis cuts between the re and im of a pair, which the plan moves."""
    tp, tr, jax_out, port_out = references[mode, n]
    eng = ReservoirEngine(tp, 4, readout=tr, mesh=cpu_mesh(*dm))
    got = sharded_workload(eng)
    for g, jw, pw in zip(got, jax_out, port_out):
        close(g, jw)
        close(g, pw)
    route = eng.stats().decode_waves_by_route
    split_model = dm[1] > 1 and mode == "diag"
    assert route["fused"] == (0 if split_model or mode == "standard" else 1)


@pytest.mark.parametrize("ensemble", ["mean", "weighted"])
def test_param_batch_ensemble_on_a_2x1_mesh(ensemble):
    """Four independently seeded reservoirs, slots split over ``data``:
    the ensemble reduce crosses the data shards every step, so the closed
    loop takes the step route; it matches the JAX and the unsharded port
    engines."""
    jps, jrs, tps, trs = [], [], [], []
    for s in range(4):
        jp, jr, tp, tr = _dpg(s)
        jps.append(jp), jrs.append(jr), tps.append(tp), trs.append(tr)
    jb, tb = jparams.stack_params(jps), tparams.stack_params(tps)
    jw = np.stack([np.asarray(r.w_out) for r in jrs])
    tw = tparams.Readout(torch.stack([r.w_out for r in trs]))
    weights = [1.0, 2.0, 0.5, 1.5]

    def run(eng):
        if ensemble == "weighted":
            eng.set_ensemble_weights(weights)
        for i in range(4):
            eng.submit(i, U[:60 + i])
        eng.flush()
        step = eng.decode_step({i: U[70] for i in range(4)})
        out = [_np(step[i]) for i in range(4)]
        ys = eng.decode_closed_loop(12)
        return out + [_np(ys[i]) for i in range(4)] + [_np(eng.states)]
    want = run(JaxEngine.from_param_batch(jb, jparams.Readout(jw),
                                          ensemble=ensemble))
    plain = run(ReservoirEngine.from_param_batch(tb, tw, ensemble=ensemble,
                                                 device="cpu"))
    eng = ReservoirEngine.from_param_batch(tb, tw, ensemble=ensemble,
                                           mesh=cpu_mesh(2, 1))
    got = run(eng)
    for g, w, p in zip(got, want, plain):
        close(g, w)
        close(g, p)
    # One decode_step, one closed loop on the step route.
    assert eng.stats().decode_waves_by_route == {"fused": 0, "step": 2}


def _dpg(seed):
    """A DPG member (noisy golden, sigma 0.1: every seed has the same
    ``n_real``, so the members stack), carried over to the port."""
    jc = jparams.ESNConfig(**dict(CFG, seed=100 + seed))
    jp = jesn.dpg_params(jc, sigma=0.1)
    jr = jesn.fit(jp, U[:300], Y[:300], washout=50)
    tp = tparams.params_from_numpy(
        "diag", {k: None if getattr(jp, k) is None else np.asarray(
            getattr(jp, k)) for k in ("lam_q", "win_q", "wfb_q", "qtq")},
        dataclasses.asdict(jc), n_real=jp.n_real, device="cpu")
    return jp, jr, tp, tparams.readout_from_numpy(np.asarray(jr.w_out),
                                                  device="cpu")
