"""The port's sharded LM on a device mesh against the JAX package's answers
and the port's own unsharded runs, on 8 gloo ranks of the CPU (one DTensor
rank a mesh device).  The test runs this
file as a script in a subprocess (``python tests/test_torch_distributed.py``
runs it directly), as ``tests/test_distributed.py`` runs the JAX package's
``tests/distributed_check.py`` on 8 placeholder devices; the ranks stop at
their own timeout, so a hung collective fails the test instead of holding
the suite.

The five checks of ``tests/distributed_check.py``, at its tolerances, with
parameters and inputs carried over from the JAX package's inits, each
sharded result held both against the JAX package's one-device answer
(``NULL_PROFILE``, computed in the parent process) and against the port's
unsharded run:

  1. the expert-parallel MoE on a (2, 4) mesh == the one-device MoE, with
     the all-reduce combine and with the reduce-scatter one (seq over tp)
  2. kimi-smoke's sharded loss and gradients == the unsharded ones
  3. qwen2-smoke decode, two steps, KV cache split over its sequence ==
     unsharded decode
  4. ``pipeline_apply`` on (4, 2) ``("pod", "model")``: forward and
     gradient == a sequential stack
  5. a psum of per-shard Gram statistics == the full ``ridge.gram``

and beside them a linear-esn smoke train step on (2, 2) (loss, gradients
and AdamW's first moments at 1e-5 of the port's unsharded step, and the
loss at the new params; the loss at 1e-5 and the gradients at 1e-4 of
JAX's, as ``tests/test_torch_lm.py`` holds the packages), a trainer state
saved on (2, 2) restored onto one device and the reverse, bit for bit,
and ``Trainer(prof=)`` on (2, 2) from JAX's weights — resumed from its own
checkpoint, and with int8 gradient compression — against the unsharded
trainer's losses at 1e-5 and the JAX trainer's at 1e-4 (as
``tests/test_torch_train.py``).  The JAX package runs in the parent process
only; each rank imports only the port.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

WORLD = 8


def check(name, a, b, tol=2e-3):
    a, b = (np.asarray(v.detach() if hasattr(v, "detach") else v,
                       np.float32) for v in (a, b))
    err = float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))
    assert err < tol, (name, err, tol)
    return name, err


def jax_inputs():
    """Every parameter and input, made by the JAX package from its seeds
    (as ``tests/distributed_check.py`` makes them), and the JAX package's
    own answers on one device (``NULL_PROFILE``) for each check, as numpy:
    each rank holds its sharded result against JAX's as well as against
    the port's unsharded run."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config
    from repro.core import ridge as jridge
    from repro.data.pipeline import MarkovTokens
    from repro.models import blocks as jblocks
    from repro.models import lm as jlm
    from repro.models.blocks import NULL_PROFILE
    from repro.train.trainer import TrainConfig, Trainer

    def np_tree(t):
        return jax.tree.map(np.asarray, t)
    out, want = {}, {}
    cfg = dataclasses.replace(smoke_config("kimi-k2-1t-a32b"), n_experts=8,
                              top_k=2, dtype="float32", capacity_factor=8.0)
    pm, _ = jblocks.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32,
                             NULL_PROFILE)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model),
                          jnp.float32)
    out["moe"] = (np_tree(pm), np.asarray(x))
    y, aux = jblocks.apply_moe(pm, x, cfg, NULL_PROFILE)
    want["moe"] = (np.asarray(y), np.asarray(aux["load_balance"]))

    cfg2 = dataclasses.replace(smoke_config("kimi-k2-1t-a32b"),
                               capacity_factor=8.0)
    p2 = jlm.init_params(jax.random.PRNGKey(2), cfg2)[0]
    tok2 = jax.random.randint(jax.random.PRNGKey(3), (4, 16), 0, cfg2.vocab)
    out["train"] = (np_tree(p2), np.asarray(tok2))
    want["train"] = np_tree(jax.jit(jax.value_and_grad(lambda p: jlm.loss_fn(
        p, cfg2, {"tokens": tok2}, NULL_PROFILE,
        scan_method="chunked")[0]))(p2))

    cfg3 = smoke_config("qwen2-72b")
    p3 = jlm.init_params(jax.random.PRNGKey(4), cfg3)[0]
    out["decode"] = np_tree(p3)
    tok = jnp.ones((4, 1), jnp.int32)
    lg, cache = jlm.decode_step(p3, cfg3, jlm.make_decode_cache(
        p3, cfg3, 4, 32, NULL_PROFILE), tok, NULL_PROFILE)
    lg2, _ = jlm.decode_step(p3, cfg3, cache, tok + 1, NULL_PROFILE)
    want["decode"] = (np.asarray(lg), np.asarray(lg2))

    ws = jax.random.normal(jax.random.PRNGKey(7), (4, 16, 16)) * 0.3
    x_micro = jax.random.normal(jax.random.PRNGKey(8), (6, 3, 16))
    out["pipeline"] = (np.asarray(ws), np.asarray(x_micro))

    def seq_stages(ws):
        y = x_micro
        for s in range(ws.shape[0]):
            y = jnp.tanh(y @ ws[s])
        return y
    want["pipeline"] = (np.asarray(seq_stages(ws)), np.asarray(
        jax.grad(lambda w: jnp.sum(seq_stages(w) ** 2))(ws)))

    xs = jax.random.normal(jax.random.PRNGKey(9), (512, 24))
    ys = jax.random.normal(jax.random.PRNGKey(10), (512, 1))
    out["ridge"] = (np.asarray(xs), np.asarray(ys))
    g, c = jridge.gram(xs, ys)
    want["ridge"] = (np.asarray(g), np.asarray(jridge.ridge_solve(g, c,
                                                                  1e-3)))

    esn = smoke_config("linear-esn")
    pe = jlm.init_params(jax.random.PRNGKey(11), esn)[0]
    tok_e = jax.random.randint(jax.random.PRNGKey(12), (4, 32), 0, esn.vocab)
    out["esn"] = (np_tree(pe), np.asarray(tok_e))
    loss_grads = np_tree(jax.jit(jax.value_and_grad(lambda p: jlm.loss_fn(
        p, esn, {"tokens": tok_e})[0]))(pe))
    # The JAX trainer from the same weights (its init at seed 11): 3 steps,
    # and 2 with int8 gradient compression (the data's batches are
    # bit-equal across the packages).
    trainer_losses = []
    for tc in (TrainConfig(steps=3, log_every=0),
               TrainConfig(steps=2, log_every=0, compress_grads=True)):
        tr = Trainer(esn, tc, MarkovTokens(vocab=esn.vocab, batch=4,
                                           seq_len=32), scan_method="chunked")
        tr.run(seed=11)
        trainer_losses.append(list(tr.losses))
    want["esn"] = (loss_grads, trainer_losses)
    out["jax"] = want
    return out


# --------------------------------------------------------------------------- #
# The checks, run on every rank                                                #
# --------------------------------------------------------------------------- #
def _moe(inp, jax_want, mesh, prof):
    import torch

    from repro_torch import dist
    from repro_torch.configs import smoke_config
    from repro_torch.models import blocks
    from repro_torch.models.lm import lm_params_from_numpy
    cfg = dataclasses.replace(smoke_config("kimi-k2-1t-a32b"), n_experts=8,
                              top_k=2, dtype="float32", capacity_factor=8.0)
    pm = lm_params_from_numpy(inp[0], "cpu")
    x = torch.tensor(inp[1])
    want, aux = blocks.apply_moe(pm, x, cfg)
    pm_d = dist.place(pm, blocks.moe_specs(cfg, prof), mesh)
    x_d = dist.place(x, (prof.dp_spec, None, None), mesh)
    got, aux_d = blocks.apply_moe(pm_d, x_d, cfg, prof)
    rows = [check("moe.out", got.full_tensor(), want),
            check("moe.load_balance", aux_d["load_balance"].full_tensor(),
                  aux["load_balance"], tol=0.2)]
    prof_sp = dataclasses.replace(prof, seq="model")
    got_sp, _ = blocks.apply_moe(pm_d, x_d, cfg, prof_sp)
    rows.append(check("moe.out.seq_sharded_scatter", got_sp.full_tensor(),
                      want))
    j_out, j_lb = jax_want
    rows += [check("moe.out.vs_jax", got.full_tensor(), j_out),
             check("moe.load_balance.vs_jax",
                   aux_d["load_balance"].full_tensor(), j_lb, tol=0.2),
             check("moe.out.seq_sharded_scatter.vs_jax",
                   got_sp.full_tensor(), j_out)]
    return rows


def _train(inp, jax_want, mesh, prof):
    import torch

    from repro_torch import dist
    from repro_torch.configs import smoke_config
    from repro_torch.models import lm
    from repro_torch.train.trainer import loss_and_grads
    from repro_torch.tree import flatten
    cfg2 = dataclasses.replace(smoke_config("kimi-k2-1t-a32b"),
                               capacity_factor=8.0)
    params = lm.lm_params_from_numpy(inp[0], "cpu")
    batch = {"tokens": torch.tensor(inp[1])}
    l_plain, _, g_plain = loss_and_grads(cfg2, params, batch)
    params_d = lm.place_params(params, cfg2, prof)
    batch_d = dist.place(batch, {"tokens": (prof.dp_spec, None)}, mesh)
    l_sh, _, g_sh = loss_and_grads(cfg2, params_d, batch_d, prof=prof)
    l_jax, g_jax = jax_want
    rows = [check("train.loss", l_sh, l_plain),
            check("train.loss.vs_jax", l_sh, l_jax)]
    # The six leaves JAX's check compares (sorted by path); the nll path
    # matches closely, the per-shard load-balance statistic loosely.
    fs, fp = flatten(dist.full(g_sh)), flatten(g_plain)
    fj = flatten(lm.lm_params_from_numpy(g_jax, "cpu"))
    for k in sorted(fp)[:6]:
        rows += [check(f"train.grad.{k}", fs[k], fp[k], tol=2.5e-2),
                 check(f"train.grad.{k}.vs_jax", fs[k], fj[k], tol=2.5e-2)]
    return rows


def _decode(inp, jax_want, mesh, prof):
    import torch

    from repro_torch import dist
    from repro_torch.configs import smoke_config
    from repro_torch.models import lm
    cfg3 = smoke_config("qwen2-72b")
    p3 = lm.lm_params_from_numpy(inp, "cpu")
    tok = torch.ones((4, 1), dtype=torch.int32)
    cache = lm.make_decode_cache(p3, cfg3, 4, 32)
    lg_plain, cache_p = lm.decode_step(p3, cfg3, cache, tok)
    lg2_plain, _ = lm.decode_step(p3, cfg3, cache_p, tok + 1)
    p3_d = lm.place_params(p3, cfg3, prof)
    cache_d = lm.make_decode_cache(p3, cfg3, 4, 32, prof)
    tok_d = dist.place(tok, (prof.dp_spec, None), mesh)
    lg_d, cache_d = lm.decode_step(p3_d, cfg3, cache_d, tok_d, prof)
    lg2_d, cache_d = lm.decode_step(p3_d, cfg3, cache_d, tok_d + 1, prof)
    # The caches stay split over their sequence, as cache_specs says.
    k = cache_d["kv"]["k"]
    assert list(k.placements) == dist.spec_placements(
        lm.cache_specs(cfg3, prof)["kv"]["k"], mesh.mesh_dim_names)
    return [check("decode.logits.t0", lg_d.full_tensor(), lg_plain),
            check("decode.logits.t1", lg2_d.full_tensor(), lg2_plain),
            check("decode.logits.t0.vs_jax", lg_d.full_tensor(), jax_want[0]),
            check("decode.logits.t1.vs_jax", lg2_d.full_tensor(),
                  jax_want[1])]


def _pipeline(inp, jax_want):
    import torch

    from repro_torch import dist
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.train.pipeline import pipeline_apply
    mesh_pp = make_lm_mesh((4, 2), ("pod", "model"), device_type="cpu")
    ws, x_micro = (torch.tensor(v) for v in inp)

    def stage_fn(w, x):
        return torch.tanh(x @ w)

    def ref(ws):
        y = x_micro
        for s in range(ws.shape[0]):
            y = stage_fn(ws[s], y)
        return y
    ws_d = dist.place(ws.clone().requires_grad_(), ("pod", None, None),
                      mesh_pp)
    ws_d = ws_d.detach().requires_grad_()
    x_d = dist.place(x_micro, (None, None, None), mesh_pp)
    got = pipeline_apply(stage_fn, ws_d, x_d, mesh=mesh_pp, axis="pod")
    rows = [check("pipeline.forward", got.full_tensor(), ref(ws)),
            check("pipeline.forward.vs_jax", got.full_tensor(), jax_want[0])]
    (got ** 2).sum().backward()
    w_ref = ws.clone().requires_grad_()
    (ref(w_ref) ** 2).sum().backward()
    rows += [check("pipeline.grad", ws_d.grad.full_tensor(), w_ref.grad),
             check("pipeline.grad.vs_jax", ws_d.grad.full_tensor(),
                   jax_want[1])]
    return rows


def _ridge(inp, jax_want, mesh):
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch import dist
    from repro_torch.core import ridge
    xs, ys = (torch.tensor(v) for v in inp)
    g_full, c_full = ridge.gram(xs, ys)

    def shard_gram(x, y):
        g, c = ridge.gram(x, y)
        return dist.psum(g, mesh, ("data",)), dist.psum(c, mesh, ("data",))
    rows_pl = [Shard(0), Replicate()]
    rep = [Replicate(), Replicate()]
    fn = local_map(shard_gram, out_placements=(rep, rep),
                   in_placements=(rows_pl, rows_pl), device_mesh=mesh)
    g_d, c_d = fn(dist.place(xs, ("data", None), mesh),
                  dist.place(ys, ("data", None), mesh))
    g_d, c_d = g_d.full_tensor(), c_d.full_tensor()
    w_d = ridge.ridge_solve(g_d, c_d, 1e-3)
    return [check("ridge.gram_psum", g_d, g_full, tol=1e-5),
            check("ridge.weights", w_d,
                  ridge.ridge_solve(g_full, c_full, 1e-3), tol=1e-4),
            check("ridge.gram_psum.vs_jax", g_d, jax_want[0], tol=1e-5),
            check("ridge.weights.vs_jax", w_d, jax_want[1], tol=1e-4)]


def _esn_step(inp, jax_want, prof, ckpt_dir):
    import torch

    from repro_torch import dist
    from repro_torch.configs import smoke_config
    from repro_torch.models import lm
    from repro_torch.train import checkpoint
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.trainer import loss_and_grads
    from repro_torch.tree import flatten
    cfg = smoke_config("linear-esn")
    mesh = prof.mesh
    params = lm.lm_params_from_numpy(inp[0], "cpu")
    batch = {"tokens": torch.tensor(inp[1])}
    opt = opt_mod.AdamW(lr=3e-3)
    l_p, _, g_p = loss_and_grads(cfg, params, batch)
    u_p, o_p = opt.update(g_p, opt.init(params), params)
    new_p = opt_mod.apply_updates(params, u_p)
    params_d = lm.place_params(params, cfg, prof)
    batch_d = dist.place(batch, {"tokens": (prof.dp_spec, None)}, mesh)
    l_d, _, g_d = loss_and_grads(cfg, params_d, batch_d, prof=prof)
    o_d0 = opt.init(params_d)
    u_d, o_d = opt.update(g_d, o_d0, params_d)
    new_d = opt_mod.apply_updates(params_d, u_d)
    (l_jax, g_jax), trainer_jax = jax_want
    rows = [check("esn_2x2.loss", l_d, l_p, tol=1e-5),
            # JAX against the port as tests/test_torch_lm.py holds them:
            # the loss to 1e-5, each gradient leaf to 1e-4 of its largest.
            check("esn_2x2.loss.vs_jax", l_d, l_jax, tol=1e-5)]
    fd, fj = (flatten(dist.full(g_d)),
              flatten(lm.lm_params_from_numpy(g_jax, "cpu")))
    assert set(fd) == set(fj)
    rows.append(("esn_2x2.grad.vs_jax", max(
        check(f"esn_2x2.grad.{k}.vs_jax", fd[k], fj[k], tol=1e-4)[1]
        for k in fj)))
    # The gradients and AdamW's first moments (0.1 g) at 1e-5 of each
    # leaf's largest entry.  The new params are held through the loss they
    # give: Adam's first step is about sign(g), so an entry whose gradient
    # is within rounding of zero may step either way in either run.
    for name, got, want in (("grad", g_d, g_p), ("adam_m", o_d["m"],
                                                 o_p["m"])):
        fs, fp = flatten(dist.full(got)), flatten(want)
        rows.append((f"esn_2x2.{name}", max(
            check(f"esn_2x2.{name}.{k}", fs[k], fp[k], tol=1e-5)[1]
            for k in fp)))
    l2_p = loss_and_grads(cfg, new_p, batch)[0]
    l2_d = loss_and_grads(cfg, new_d, batch_d, prof=prof)[0]
    rows.append(check("esn_2x2.loss_after_step", l2_d, l2_p,
                      tol=1e-5))
    # The state's placements are opt_state_specs' (moments as the params).
    for k, v in flatten(o_d["m"]).items():
        assert v.placements == flatten(params_d)[k].placements, k
    # Elastic checkpoints: (2, 2) -> one device, one device -> (2, 2).
    state_d = {"params": new_d, "opt": o_d}
    checkpoint.save(os.path.join(ckpt_dir, "mesh"), 1, state_d)
    like = {"params": new_p, "opt": o_p}
    back = checkpoint.restore(os.path.join(ckpt_dir, "mesh"), 1, like)
    full_d = flatten(dist.full(state_d))
    assert all(torch.equal(v, full_d[k]) and not dist.is_dtensor(v)
               for k, v in flatten(back).items())
    plain_dir = os.path.join(ckpt_dir, f"plain_{os.getpid()}")
    checkpoint.save(plain_dir, 1, like)
    from repro_torch.sharding.rules import opt_state_specs
    specs = {"params": lm.param_specs(cfg, prof),
             "opt": opt_state_specs(opt, lm.param_specs(cfg, prof))}
    from repro_torch.tree import tree_map
    shardings = tree_map(lambda sp: (mesh, sp), specs)
    onto = checkpoint.restore(plain_dir, 1, like, shardings=shardings)
    fl = flatten(like)
    for k, v in flatten(onto).items():
        assert dist.is_dtensor(v), k
        assert torch.equal(v.full_tensor(), fl[k]), k
    rows.append(("checkpoint.elastic_bit_equal", 0.0))
    # The trainer on the mesh (Trainer(prof=)): 3 steps from JAX's weights
    # against the unsharded trainer and the JAX trainer, with a checkpoint
    # at step 2 that a restarted sharded trainer resumes from.
    from repro_torch.data.pipeline import MarkovTokens
    from repro_torch.train.trainer import TrainConfig, Trainer
    data = MarkovTokens(vocab=cfg.vocab, batch=4, seq_len=32)

    def run(tc, prof=None):
        tr = Trainer(cfg, tc, data, device="cpu", prof=prof)
        state = tr.run(start_state=tr.state_of(
            lm.lm_params_from_numpy(inp[0], "cpu")))
        return tr, state
    plain = run(TrainConfig(steps=3, log_every=0))[0]
    tc = TrainConfig(steps=3, log_every=0, ckpt_every=2, ckpt_dir=os.path.join(
        ckpt_dir, "trainer"))
    sharded = run(dataclasses.replace(tc, steps=2), prof)[0]
    resumed, state = run(tc, prof)
    assert dist.is_dtensor(flatten(state["params"])["head"])
    losses = sharded.losses + resumed.losses
    # JAX's trainer against the port's as tests/test_torch_train.py holds
    # them (1e-4 relative).
    rows += [check("trainer_2x2.losses", losses, plain.losses, tol=1e-5),
             check("trainer_2x2.losses.vs_jax", losses, trainer_jax[0],
                   tol=1e-4)]
    # With int8 gradient compression and error feedback (one absmax scale
    # a whole leaf, so the same payload split or not).
    tc8 = TrainConfig(steps=2, log_every=0, compress_grads=True)
    plain8 = run(tc8)[0]
    sharded8 = run(tc8, prof)[0]
    rows += [check("trainer_2x2.int8_losses", sharded8.losses,
                   plain8.losses, tol=1e-5),
             check("trainer_2x2.int8_losses.vs_jax", sharded8.losses,
                   trainer_jax[1], tol=1e-4)]
    return rows


def rank_main(rank, inp, ckpt_dir):
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.blocks import ShardProfile
    mesh = make_lm_mesh((2, 4), device_type="cpu")
    prof = ShardProfile(mesh=mesh, tp="model", fsdp=None, dp=("data",),
                        tp_size=4)
    want = inp["jax"]
    rows = _moe(inp["moe"], want["moe"], mesh, prof)
    rows += _train(inp["train"], want["train"], mesh, prof)
    rows += _decode(inp["decode"], want["decode"], mesh, prof)
    rows += _pipeline(inp["pipeline"], want["pipeline"])
    rows += _ridge(inp["ridge"], want["ridge"], mesh)
    # Two (2, 2) meshes side by side (ranks 0-3 and 4-7), each the same run.
    cube = make_lm_mesh((2, 2, 2), ("rep", "data", "model"),
                        device_type="cpu")
    sub = cube["data", "model"]
    prof22 = ShardProfile(mesh=sub, tp="model", dp=("data",), tp_size=2)
    rows += _esn_step(inp["esn"], want["esn"], prof22, ckpt_dir)
    return rows


def test_sharded_lm_matches_unsharded_on_8_gloo_ranks():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src")
    env["TORCH_DIST_CHECK_TIMEOUT"] = "200"
    out = subprocess.run([sys.executable, os.path.abspath(__file__)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n" \
        f"{out.stderr[-6000:]}"
    assert "ALL OK" in out.stdout
    for name in ("moe.out", "moe.out.seq_sharded_scatter", "train.loss",
                 "decode.logits.t1", "pipeline.grad", "ridge.gram_psum",
                 "esn_2x2.grad", "checkpoint.elastic_bit_equal",
                 "trainer_2x2.losses"):
        assert f"] {name}: " in out.stdout, name
        if name != "checkpoint.elastic_bit_equal":
            assert f"] {name}.vs_jax: " in out.stdout, name


def main():
    from repro_torch.launch.mesh import spawn_ranks
    inp = jax_inputs()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        results = spawn_ranks(rank_main, WORLD, args=(inp, ckpt_dir),
                              timeout=float(os.environ.get(
                                  "TORCH_DIST_CHECK_TIMEOUT", "150")))
    for name, err in results[0]:
        print(f"[test_torch_distributed] {name}: rel_err={err:.2e} OK",
              flush=True)
    print("[test_torch_distributed] ALL OK", flush=True)


if __name__ == "__main__":
    main()
