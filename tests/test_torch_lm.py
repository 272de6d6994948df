"""Port parity: the reservoir LM (``models/``) against the JAX package's.

The weights are the JAX ``init_params`` output carried over with
``lm_params_from_numpy``, so both packages compute the same function; inputs
come from numpy seeds.  On the CPU the port's scan runs its plain version
(forward and backward); the JAX side runs as its own tests run it — the
chunked scan in the LM, and the Pallas kernel in interpret mode where
``use_pallas=True``.  Everything is float32: logits, losses and layer
outputs agree to 1e-5 of their largest value, gradients leaf-wise to 1e-4 of
each leaf's largest value (the two frameworks sum in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro_torch.configs import smoke_config as tsmoke_config
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.train.trainer import loss_and_grads
from repro_torch.tree import flatten, tree_map

B, S = 2, 48


def _cfg(n_layers):
    return dataclasses.replace(smoke_config("linear-esn"), n_layers=n_layers)


@pytest.fixture(scope="module", params=[2, 3], ids=["2-layer", "3-layer"])
def model(request):
    """(cfg, JAX params, port params, tokens) of one smoke-size LM."""
    cfg = _cfg(request.param)
    jp, _ = jlm.init_params(jax.random.PRNGKey(request.param), cfg)
    tp = tlm.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(request.param).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)
    return cfg, jp, tp, toks


def _assert_rel(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, tol)


def test_configs_are_the_jax_packages():
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    assert list(tconfigs.REGISTRY) == list(jconfigs.REGISTRY)
    for name, cfg in jconfigs.REGISTRY.items():
        assert dataclasses.asdict(tconfigs.REGISTRY[name]) == \
            dataclasses.asdict(cfg)
        assert dataclasses.asdict(tsmoke_config(name)) == \
            dataclasses.asdict(smoke_config(name))
        assert tconfigs.REGISTRY[name].param_count() == cfg.param_count()
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED


def test_carried_params_keep_keys_shapes_and_values(model):
    cfg, jp, tp, _ = model
    want = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = flatten(tp)
    assert list(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and v.dtype == np.float32
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert got["layers/res/nu"].shape == (cfg.n_layers, cfg.d_rnn)


def test_port_init_has_the_jax_layout(model):
    """The port's own init draws a tree of the same keys, shapes and dtypes
    (and the same DPG spectrum family: |lambda| < 1)."""
    cfg, _, tp, _ = model
    own = tlm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {k: (v.shape, v.dtype) for k, v in flatten(own).items()} == \
        {k: (v.shape, v.dtype) for k, v in flatten(tp).items()}
    mag = torch.exp(-torch.exp(own["layers"]["res"]["nu"]))
    assert bool((mag < 1).all())


@pytest.mark.parametrize("use_pallas", [False, True], ids=["scan", "pallas"])
@pytest.mark.parametrize("with_cache", [False, True], ids=["h0=0", "h0"])
def test_apply_reservoir_matches_jax(model, use_pallas, with_cache):
    cfg, jp, tp, _ = model
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, 40, cfg.d_model)).astype(np.float32)
    n = cfg.d_rnn
    cache = ({"h_re": rng.normal(size=(B, n)).astype(np.float32),
              "h_im": rng.normal(size=(B, n)).astype(np.float32)}
             if with_cache else None)
    jres = jax.tree.map(lambda v: v[1], jp["layers"]["res"])
    tres = tree_map(lambda v: v[1], tp["layers"]["res"])
    want, wcache = jblocks.apply_reservoir(
        jres, jnp.asarray(x), cfg, use_pallas=use_pallas,
        cache=None if cache is None else jax.tree.map(jnp.asarray, cache))
    got, gcache = tblocks.apply_reservoir(
        tres, torch.tensor(x), cfg,
        cache=None if cache is None else tree_map(torch.tensor, cache))
    _assert_rel(got.numpy(), want, 1e-5)
    for k in ("h_re", "h_im"):
        _assert_rel(gcache[k].numpy(), wcache[k], 1e-5)


def test_forward_and_loss_match_jax(model):
    cfg, jp, tp, toks = model
    want, _, _ = jlm.forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    got, _, _ = tlm.forward(tp, cfg, {"tokens": torch.tensor(toks)})
    _assert_rel(got.numpy(), want, 1e-5)
    wl, wm = jlm.loss_fn(jp, cfg, {"tokens": jnp.asarray(toks)})
    gl, gm = tlm.loss_fn(tp, cfg, {"tokens": torch.tensor(toks)})
    assert abs(float(gl) - float(wl)) <= 1e-5 * abs(float(wl))
    assert set(gm) == set(wm)
    assert float(gm["load_balance"]) == 0.0 == float(wm["load_balance"])


def test_grads_match_jax(model):
    cfg, jp, tp, toks = model
    wgrads = jax.grad(lambda p: jlm.loss_fn(
        p, cfg, {"tokens": jnp.asarray(toks)})[0])(jp)
    want = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(wgrads)[0]}
    _, _, grads = loss_and_grads(cfg, tp, {"tokens": torch.tensor(toks)})
    got = flatten(grads)
    assert set(got) == set(want)
    for k, w in want.items():
        d = float(np.abs(got[k].numpy() - w).max())
        assert d <= 1e-4 * float(np.abs(w).max()), (k, d)


def test_remat_gives_the_same_grads(model):
    cfg, _, tp, toks = model
    batch = {"tokens": torch.tensor(toks)}
    l0, _, g0 = loss_and_grads(cfg, tp, batch)
    l1, _, g1 = loss_and_grads(cfg, tp, batch, remat=True)
    assert float(l0) == float(l1)
    for k, v in flatten(g0).items():
        torch.testing.assert_close(flatten(g1)[k], v, rtol=0, atol=0)


def test_decode_matches_forward_and_jax(model):
    """K decode steps equal the full forward (state-cache correctness, as
    ``tests/test_arch_smoke.py`` checks the JAX package) and the JAX
    package's own decode steps; the prefill caches equal the decode's."""
    cfg, jp, tp, toks = model
    k = 12
    full, caches, _ = tlm.forward(tp, cfg, {"tokens": torch.tensor(toks[:, :k])},
                                  mode="prefill")
    tcache = tlm.make_decode_cache(tp, cfg, B, k + 4)
    jcache = jlm.make_decode_cache(jp, cfg, B, k + 4)
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(p, cfg, c, t))
    for t in range(k):
        got, tcache = tlm.decode_step(tp, cfg, tcache,
                                      torch.tensor(toks[:, t:t + 1]))
        want, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        _assert_rel(got.numpy(), want, 1e-5)
        _assert_rel(got[:, 0].numpy(), full[:, t].detach().numpy(), 1e-5)
    for key, v in flatten(caches).items():
        _assert_rel(flatten(tcache)[key].numpy(), v.detach().numpy(), 1e-5)
        _assert_rel(flatten(tcache)[key].numpy(),
                    flatten(jax.tree.map(np.asarray, jcache))[key], 1e-5)


def test_unported_blocks_name_their_roadmap_item():
    for name in ("smollm-135m", "recurrentgemma-2b", "xlstm-125m",
                 "arctic-480b", "whisper-tiny"):
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            tlm.init_params(torch.Generator(), tsmoke_config(name), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        tblocks.constrain(torch.zeros(1), None,
                          tblocks.ShardProfile(mesh=object()))
