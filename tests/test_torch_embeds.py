"""Port parity: embedding inputs (``llava-next-mistral-7b``: ``batch
["embeds"]`` in place of the token lookup, ``batch["labels"]`` as the
targets), and the registry as a whole.

llava at smoke size against the JAX package: logits, loss and gradients
leaf by leaf to 1e-5 relative in float32 — the token embeddings, which the
loss does not reach, get zero gradients as under ``jax.grad``.  Every
registered config is ported (``ported_archs()`` is the registry), and every
one's JAX ``init_params`` tree carries across key for key, value for value
and dtype for dtype (at smoke size in the config's own dtype: bfloat16
weights beside the MoE block's float32 router).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, smoke_config
from repro.models import lm as jlm
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.train.trainer import loss_and_grads
from repro_torch.tree import flatten

B, S = 2, 20


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _paths(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_embeds_and_labels_match_jax():
    cfg = smoke_config("llava-next-mistral-7b")
    assert cfg.input_mode == "embeddings"
    jp, _ = jlm.init_params(jax.random.PRNGKey(13), cfg)
    tp = tlm.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(13)
    batch = {"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(
                 np.float32),
             "labels": rng.integers(0, cfg.vocab, size=(B, S)).astype(
                 np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    want, _, _ = jax.jit(lambda p: jlm.forward(p, cfg, jb))(jp)
    got, _, _ = tlm.forward(tp, cfg, tb)
    assert _rel(got.detach().numpy(), want) <= 1e-5
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, cfg, jb), has_aux=True))(jp)
    loss, _, grads = loss_and_grads(cfg, tp, tb)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jgf = _paths(jg)
    for k, g in flatten(grads).items():
        if k == "embed":
            assert not np.abs(jgf[k]).any() and not g.abs().any()
        else:
            assert _rel(g.numpy(), jgf[k]) <= 1e-5, k
    # The labels are the targets: shifted tokens would give another loss.
    shifted = {"embeds": tb["embeds"],
               "tokens": torch.roll(tb["labels"], 1, dims=1)}
    assert abs(float(tlm.loss_fn(tp, cfg, shifted)[0]) - float(loss)) > 1e-3


def test_every_registered_arch_is_ported():
    assert tlm.ported_archs() == list(REGISTRY)
    # A11's LM half is ported: a mesh profile is accepted for every config
    # (tests/test_torch_lm_sharding.py); one naming an axis its mesh lacks
    # is refused.
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((2, 4)))
    for name in REGISTRY:
        tlm.check_ported(smoke_config(name), tblocks.ShardProfile(
            mesh=mesh, tp="model", dp=("data",), tp_size=4))
    with pytest.raises(ValueError, match="not in the mesh"):
        tlm.check_ported(smoke_config("smollm-135m"),
                         tblocks.ShardProfile(mesh=mesh, dp=("pod",)))


@pytest.mark.parametrize("name", list(REGISTRY))
def test_init_params_carry_across_key_for_key(name):
    cfg = dataclasses.replace(smoke_config(name), dtype=REGISTRY[name].dtype)
    jp, _ = jlm.init_params(jax.random.PRNGKey(0), cfg)
    want = _paths(jp)
    got = flatten(tlm.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                           "cpu"))
    own = flatten(tlm.init_params(torch.Generator(), cfg, "cpu"))
    assert list(got) == list(own) == sorted(want)
    for k, v in want.items():
        assert str(got[k].dtype).removeprefix("torch.") == str(v.dtype), k
        assert (own[k].dtype, own[k].shape) == (got[k].dtype, got[k].shape)
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      v.astype(np.float32))
    if cfg.n_experts:
        assert got["layers/moe/router"].dtype == torch.float32
        assert got["layers/moe/wg"].dtype == torch.bfloat16


def test_only_the_unreached_embeddings_get_zero_gradients():
    """Fed ``embeds``, only an untied model's token table may go unused;
    a leaf that a wiring fault cut off from the loss still raises."""
    cfg = smoke_config("llava-next-mistral-7b")
    tp = tlm.init_params(torch.Generator().manual_seed(2), cfg, "cpu")
    rng = np.random.default_rng(2)
    tb = {"embeds": torch.tensor(rng.normal(size=(B, S, cfg.d_model)),
                                 dtype=torch.float32),
          "labels": torch.tensor(rng.integers(0, cfg.vocab, size=(B, S)))}
    _, _, grads = loss_and_grads(cfg, tp, tb)
    assert not grads["embed"].abs().any() and grads["head"].abs().any()
    with pytest.raises(RuntimeError, match="not have been used"):
        loss_and_grads(cfg, dict(tp, stray=torch.ones(3)), tb)
