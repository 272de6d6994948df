"""Port parity: the training substrate (``train/``, ``data/pipeline.py``)
against the JAX package's, plus the port's own checkpoint/restart, gradient
accumulation and preemption behaviour.

Inputs and weights come from numpy seeds and the JAX package's init (carried
over with ``lm_params_from_numpy``).  Tolerances: optimizer updates on the
same gradients 1e-6 (float32, the same arithmetic); Trainer losses 1e-4
relative (three float32 steps through two frameworks); the step after a
cross-package restore 1e-5; quantization and data batches bit-equal.

Parameters are never compared elementwise after an Adam step at a tight
tolerance: the first update is about ``lr * sign(g)``, so where a gradient
is near zero a last-bit difference flips its sign and moves that parameter
by ``2 lr``.  The tests compare losses, gradients and the optimizer's
updates on identical gradients instead.
"""
import dataclasses
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.data import pipeline as jpipe
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch.data import pipeline as tpipe
from repro_torch.models import lm as tlm
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import TrainConfig, Trainer, make_step_fn
from repro_torch.tree import flatten, tree_map


def _cfg():
    return dataclasses.replace(smoke_config("linear-esn"), vocab=64,
                               n_layers=2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _grad_tree(rng):
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "stack": {"b": rng.normal(size=(3, 4)).astype(np.float32),
                      "s": rng.normal(size=(7,)).astype(np.float32)}}


# --------------------------------------------------------------------------- #
# Data                                                                         #
# --------------------------------------------------------------------------- #
def test_token_batches_are_bit_equal_to_jax():
    for j, t in ((jpipe.MarkovTokens(vocab=97, batch=4, seq_len=33, seed=3),
                  tpipe.MarkovTokens(vocab=97, batch=4, seq_len=33, seed=3)),
                 (jpipe.SyntheticTokens(vocab=50, batch=6, seq_len=9, seed=1),
                  tpipe.SyntheticTokens(vocab=50, batch=6, seq_len=9, seed=1))):
        for step, shard, n in ((0, 0, 1), (5, 1, 2)):
            want = j.batch_at(step, shard, n)["tokens"]
            got = t.batch_at(step, shard, n)["tokens"]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# Optimizers and compression                                                   #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name,kw", [
    ("adamw", {}),
    ("adamw", {"clip_norm": None, "weight_decay": 0.0}),
    ("adafactor", {"weight_decay": 0.01}),
], ids=["adamw", "adamw-noclip", "adafactor"])
def test_optimizer_updates_match_jax(name, kw):
    rng = np.random.default_rng(0)
    params = _grad_tree(rng)
    jo = jopt.make_optimizer(name, lr=0.05, **kw)
    to = topt.make_optimizer(name, lr=0.05, **kw)
    jp, tp = jax.tree.map(jnp.asarray, params), tree_map(torch.tensor, params)
    js, ts = jo.init(jp), to.init(tp)
    assert set(flatten(ts)) == set(flatten(_np_tree(js)))
    for _ in range(4):
        grads = _grad_tree(rng)
        ju, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tu, ts = to.update(tree_map(torch.tensor, grads), ts, tp)
        for k, w in flatten(_np_tree(ju)).items():
            np.testing.assert_allclose(flatten(tu)[k].numpy(), w, rtol=1e-6,
                                       atol=1e-6)
        # Both sides step from the same params, so the comparison stays one
        # update deep.
        jp = jopt.apply_updates(jp, ju)
        tp = tree_map(torch.tensor, _np_tree(jp))
    for k, w in flatten(_np_tree(js)).items():
        np.testing.assert_allclose(flatten(ts)[k].numpy(), w, rtol=1e-6,
                                   atol=1e-7)


def test_cosine_schedule_matches_jax():
    jf = jopt.cosine_schedule(0.1, 5, 40)
    tf = topt.cosine_schedule(0.1, 5, 40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 60):
        np.testing.assert_allclose(float(tf(step)), float(jf(step)),
                                   rtol=1e-6)


def test_compression_is_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    grads = _grad_tree(rng)
    ef_j = jcomp.init_ef(jax.tree.map(jnp.asarray, grads))
    ef_t = tcomp.init_ef(tree_map(torch.tensor, grads))
    for _ in range(3):
        out_j, ef_j = jcomp.compress_decompress_ef(
            jax.tree.map(jnp.asarray, grads), ef_j)
        out_t, ef_t = tcomp.compress_decompress_ef(
            tree_map(torch.tensor, grads), ef_t)
        for tree_t, tree_j in ((out_t, out_j), (ef_t, ef_j)):
            for k, w in flatten(_np_tree(tree_j)).items():
                np.testing.assert_array_equal(flatten(tree_t)[k].numpy(), w)
        grads = _grad_tree(rng)
    q_j, s_j = jcomp.quantize(jnp.asarray(grads["w"]))
    q_t, s_t = tcomp.quantize(torch.tensor(grads["w"]))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    assert float(s_t) == float(s_j)


# --------------------------------------------------------------------------- #
# Trainer                                                                      #
# --------------------------------------------------------------------------- #
def test_trainer_losses_match_jax_trainer():
    """Three AdamW steps from the same weights and batches."""
    cfg = _cfg()
    data = tpipe.MarkovTokens(vocab=cfg.vocab, batch=4, seq_len=32)
    jdata = jpipe.MarkovTokens(vocab=cfg.vocab, batch=4, seq_len=32)
    jtr = JTrainer(cfg, JTrainConfig(steps=3, log_every=0, lr=1e-2), jdata,
                   scan_method="chunked")
    jstate = jtr.init_state(0)
    tr = Trainer(cfg, TrainConfig(steps=3, log_every=0, lr=1e-2), data,
                 device="cpu")
    tstate = tlm.lm_params_from_numpy(_np_tree(jstate), "cpu")
    jtr.run(start_state=jstate)
    tr.run(start_state=tstate)
    np.testing.assert_allclose(tr.losses, jtr.losses, rtol=1e-4)


@pytest.mark.parametrize("attn_impl", ["auto", "flash"])
def test_smollm_trainer_losses_match_jax_trainer(attn_impl):
    """Three AdamW steps of the attention LM (smollm-135m at smoke size, 2
    layers) from the same weights and batches; ``auto`` is dense at 32
    tokens, ``flash`` runs the flash forward and its chunked backward."""
    cfg = dataclasses.replace(smoke_config("smollm-135m"), vocab=64,
                              n_layers=2)
    data = tpipe.MarkovTokens(vocab=cfg.vocab, batch=4, seq_len=32)
    jdata = jpipe.MarkovTokens(vocab=cfg.vocab, batch=4, seq_len=32)
    jtr = JTrainer(cfg, JTrainConfig(steps=3, log_every=0, lr=1e-2), jdata,
                   attn_impl=attn_impl)
    jstate = jtr.init_state(0)
    tr = Trainer(cfg, TrainConfig(steps=3, log_every=0, lr=1e-2), data,
                 device="cpu", attn_impl=attn_impl)
    tstate = tlm.lm_params_from_numpy(_np_tree(jstate), "cpu")
    jtr.run(start_state=jstate)
    tr.run(start_state=tstate)
    np.testing.assert_allclose(tr.losses, jtr.losses, rtol=1e-4)


def test_smollm_launch_train_runs_on_cpu():
    """``launch.train --arch smollm-135m`` at smoke size on the host, at a
    2048-token context so training takes the banded flash route."""
    from repro_torch.launch import train
    res = train.main(["--arch", "smollm-135m", "--smoke", "--steps", "2",
                      "--batch", "1", "--seq", "2048", "--vocab", "64",
                      "--device", "cpu"])
    assert res["steps_run"] == 2 and res["finite"]
    assert res["arch"] == "smollm-135m" and res["seq"] == 2048


class _NegGrads:
    """An 'optimizer' whose update is the gradient itself, so a step's
    parameter change exposes the gradient it used."""

    def update(self, grads, state, params):
        return grads, state


def test_accumulation_equals_the_full_batch():
    cfg = _cfg()
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = {"tokens": torch.as_tensor(tpipe.MarkovTokens(
        vocab=cfg.vocab, batch=4, seq_len=32).batch_at(0)["tokens"])}
    out = {}
    for accum in (1, 2):
        step = make_step_fn(cfg, TrainConfig(accum=accum), _NegGrads())
        new, _, _, loss, _ = step(params, None, None, batch)
        out[accum] = (float(loss), flatten(tree_map(torch.sub, new, params)))
    assert abs(out[2][0] - out[1][0]) <= 1e-6 * abs(out[1][0])
    for k, g in out[1][1].items():
        d = float((out[2][1][k] - g).abs().max())
        assert d <= 1e-5 * max(float(g.abs().max()), 1e-12), k


def test_trainer_loss_decreases():
    cfg = _cfg()
    data = tpipe.MarkovTokens(vocab=cfg.vocab, batch=4, seq_len=32,
                              branching=4)
    tr = Trainer(cfg, TrainConfig(steps=30, log_every=0, lr=1e-2), data,
                 device="cpu")
    tr.run()
    assert np.mean(tr.losses[-5:]) < np.mean(tr.losses[:5]) - 0.3


def test_checkpoint_restart_is_bit_exact(tmp_path):
    """Train 6; separately train 3, stop, restart to 6 (async saves):
    steps 4-6 give the same losses bit for bit."""
    cfg = _cfg()
    data = tpipe.MarkovTokens(vocab=cfg.vocab, batch=4, seq_len=32)
    full = Trainer(cfg, TrainConfig(steps=6, log_every=0, lr=1e-2), data,
                   device="cpu")
    full.run(seed=0)
    ck = str(tmp_path / "ck")
    Trainer(cfg, TrainConfig(steps=3, ckpt_dir=ck, ckpt_every=3, log_every=0,
                             lr=1e-2, ckpt_async=True), data,
            device="cpu").run(seed=0)
    assert tckpt.all_steps(ck) == [3]
    resumed = Trainer(cfg, TrainConfig(steps=6, ckpt_dir=ck, ckpt_every=100,
                                       log_every=0, lr=1e-2), data,
                      device="cpu")
    resumed.run(seed=0)
    assert resumed.losses == full.losses[3:]
    assert tckpt.all_steps(ck) == [3, 6]


class _PreemptAt(tpipe.MarkovTokens):
    """A pipeline that sends SIGTERM to this process at one step."""

    def batch_at(self, step, shard=0, n_shards=1):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return super().batch_at(step, shard, n_shards)


def test_sigterm_checkpoints_and_stops(tmp_path):
    cfg = _cfg()
    ck = str(tmp_path / "ck")
    data = _PreemptAt(vocab=cfg.vocab, batch=2, seq_len=16)
    before = signal.getsignal(signal.SIGTERM)
    tr = Trainer(cfg, TrainConfig(steps=10, ckpt_dir=ck, ckpt_every=100,
                                  log_every=0), data, device="cpu")
    state = tr.run()
    assert len(tr.losses) == 3 and int(state["step"]) == 3
    assert tckpt.latest_step(ck) == 3
    assert signal.getsignal(signal.SIGTERM) == before


def test_checkpoint_layout_bf16_and_retention(tmp_path):
    tree = {"a": torch.ones((3, 4), dtype=torch.bfloat16) * 1.5,
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.zeros((), dtype=torch.float32)}}
    path = tckpt.save(str(tmp_path), 7, tree)
    assert sorted(os.listdir(path)) == ["_COMPLETE", "manifest.json",
                                        "shard_0.npz"]
    out = tckpt.restore(str(tmp_path), 7, tree)
    for k, v in flatten(tree).items():
        assert flatten(out)[k].dtype == v.dtype
        torch.testing.assert_close(flatten(out)[k], v, rtol=0, atol=0)
    # The JAX package reads the same checkpoint.
    jout = jckpt.restore(str(tmp_path), 7, jax.tree.map(
        lambda v: jnp.zeros(v.shape, jnp.float32), {"a": np.zeros((3, 4)),
                                                    "b": {"c": np.zeros(5),
                                                          "d": np.zeros(())}}))
    assert str(jout["a"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jout["a"], np.float32), 1.5)
    for s in (8, 9, 10):
        tckpt.save(str(tmp_path), s, tree, keep=2)
    os.makedirs(tmp_path / "step_00000011")      # partial: no _COMPLETE
    assert tckpt.all_steps(str(tmp_path)) == [9, 10]
    assert tckpt.latest_step(str(tmp_path)) == 10
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(str(tmp_path), 10, {**tree, "a": torch.zeros(2)})


def test_async_save_and_wait_pending_as_in_jax(tmp_path):
    """``save(..., async_=True)`` returns the path at once and
    ``wait_pending`` joins the writes, as in the JAX package: the same
    files as a blocking save, the tree copied when ``save`` was called
    (later in-place edits do not reach it), and the JAX package reads it;
    a write that fails raises from ``wait_pending``."""
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "s": torch.tensor(5, dtype=torch.int64)}
    want = {k: v.clone() for k, v in tree.items()}
    path = tckpt.save(str(tmp_path / "port"), 3, tree, async_=True)
    tree["w"].add_(100.0)
    tckpt.wait_pending()
    assert path == str(tmp_path / "port" / "step_00000003")
    out = tckpt.restore(str(tmp_path / "port"), 3, tree)
    for k, v in want.items():
        torch.testing.assert_close(out[k], v, rtol=0, atol=0)
    jpath = jckpt.save(str(tmp_path / "jax"), 3,
                       {k: jnp.asarray(v.numpy()) for k, v in want.items()},
                       async_=True)
    jckpt.wait_pending()
    assert sorted(os.listdir(path)) == sorted(os.listdir(jpath))
    jout = jckpt.restore(str(tmp_path / "port"), 3, {
        "w": jnp.zeros((3, 4), jnp.float32), "s": jnp.zeros((), jnp.int64)})
    np.testing.assert_array_equal(np.asarray(jout["w"]), want["w"].numpy())
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    tckpt.save(str(blocker), 1, want, async_=True)
    with pytest.raises(OSError):
        tckpt.wait_pending()
    tckpt.wait_pending()                  # nothing left pending


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint the JAX Trainer wrote restores into the port's state
    with the same keys, shapes and values, and the next step's loss matches
    the JAX Trainer's next step.  (Only reads what the JAX package wrote.)"""
    cfg = _cfg()
    jdata = jpipe.MarkovTokens(vocab=cfg.vocab, batch=4, seq_len=32)
    data = tpipe.MarkovTokens(vocab=cfg.vocab, batch=4, seq_len=32)
    ck_jax, ck_port = str(tmp_path / "jax"), str(tmp_path / "port")
    jtr = JTrainer(cfg, JTrainConfig(steps=1, ckpt_dir=ck_jax, log_every=0,
                                     lr=1e-2), jdata, scan_method="chunked")
    jtr.run(seed=0)
    shutil.copytree(ck_jax, ck_port)
    # The JAX trainer's next step, resumed from its own checkpoint.
    jtr.tc = dataclasses.replace(jtr.tc, steps=2)
    jtr.run(seed=0)

    tr = Trainer(cfg, TrainConfig(steps=2, ckpt_dir=ck_port, log_every=0,
                                  lr=1e-2), data, device="cpu")
    like = tr.init_state(seed=1)
    restored = tckpt.restore(ck_port, 1, like)
    with np.load(os.path.join(ck_port, "step_00000001", "shard_0.npz")) as z:
        stored = dict(z)
    assert sorted(flatten(restored)) == sorted(stored) == sorted(flatten(like))
    for k, v in flatten(restored).items():
        assert tuple(v.shape) == tuple(flatten(like)[k].shape)
        np.testing.assert_array_equal(v.numpy(), stored[k])
    tr.run(seed=1)
    assert len(tr.losses) == 1
    assert abs(tr.losses[0] - jtr.losses[1]) <= 1e-5 * abs(jtr.losses[1])
