"""Port parity: the reservoir LM and the attention LM (``models/``) against
the JAX package's.

The weights are the JAX ``init_params`` output carried over with
``lm_params_from_numpy``, so both packages compute the same function; inputs
come from numpy seeds.  On the CPU the port's scan and flash attention run
their plain versions (forward and backward); the JAX side runs as its own
tests run it — the chunked scan and ``jnp_flash`` in the LM, and the Pallas
scan kernel in interpret mode where ``use_pallas=True``.  Everything is
float32: logits, losses and layer outputs agree to 1e-5 of their largest
value, gradients leaf-wise to 1e-4 of each leaf's largest value (the two
frameworks sum in different orders).
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
    # The A12 families are ported: their params build and match the JAX
    # package's tree key for key, shape for shape.
    for name in ("kimi-k2-1t-a32b", "arctic-480b", "whisper-tiny",
                 "llava-next-mistral-7b"):
        cfg = tsmoke_config(name)
        p = flatten(tlm.init_params(torch.Generator(), cfg, "cpu"))
        jp, _ = jlm.init_params(jax.random.PRNGKey(0), smoke_config(name))
        want = {"/".join(str(k.key) for k in path): tuple(v.shape) for
                path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
        assert {k: tuple(v.shape) for k, v in p.items()} == want
    # The recurrent families are ported: their params build.
    for name in ("recurrentgemma-2b", "xlstm-125m"):
        p = tlm.init_params(torch.Generator(), tsmoke_config(name), "cpu")
        assert set(p) == {"embed", "layers", "final_norm", "head"}
    # A11's LM half is ported (tests/test_torch_lm_sharding.py and
    # tests/test_torch_distributed.py): on a mesh, constrain redistributes
    # DTensors and refuses a plain tensor.
    with pytest.raises(TypeError, match="DTensor"):
        tblocks.constrain(torch.zeros(1), (None,),
                          tblocks.ShardProfile(mesh=object()))


# --------------------------------------------------------------------------- #
# The attention LM: smollm-135m at smoke size                                  #
# --------------------------------------------------------------------------- #
ATTN_MODELS = {
    "smollm-2-layer": ("attn", 2),
    "smollm-3-layer": ("attn", 3),
    "swa-window16": ("swa", 2),
}


def _attn_cfg(kind, n_layers):
    cfg = dataclasses.replace(smoke_config("smollm-135m"), n_layers=n_layers)
    if kind == "swa":
        cfg = dataclasses.replace(cfg, block_pattern=("swa",), window=16)
    return cfg


@pytest.fixture(scope="module", params=list(ATTN_MODELS))
def attn_model(request):
    """(cfg, JAX params, port params, tokens (B, 40)) of one smoke-size
    attention LM (d_model 128, 4 query and 2 KV heads of 32)."""
    cfg = _attn_cfg(*ATTN_MODELS[request.param])
    seed = list(ATTN_MODELS).index(request.param)
    jp, _ = jlm.init_params(jax.random.PRNGKey(seed), cfg)
    tp = tlm.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, 40)).astype(np.int32)
    return cfg, jp, tp, toks


def _jax_flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_attn_carried_params_keep_keys_shapes_and_values(attn_model):
    cfg, jp, tp, _ = attn_model
    want, got = _jax_flat(jp), flatten(tp)
    assert list(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and v.dtype == np.float32
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert got["layers/attn/wq"].shape == (cfg.n_layers, cfg.d_model,
                                           cfg.n_heads, cfg.head_dim)
    assert got["layers/attn/wo"].shape == (cfg.n_layers, cfg.n_heads,
                                           cfg.head_dim, cfg.d_model)


def test_attn_port_init_has_the_jax_layout(attn_model):
    cfg, _, tp, _ = attn_model
    own = tlm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {k: (v.shape, v.dtype) for k, v in flatten(own).items()} == \
        {k: (v.shape, v.dtype) for k, v in flatten(tp).items()}
    # wo is scaled by 1/sqrt(Hq * hd) = 1/sqrt(d_model): std ~ 0.088.
    assert 0.07 < float(own["layers"]["attn"]["wo"].std()) < 0.11


def test_qkv_bias_block_matches_jax():
    """A block with q/k/v biases (the qwen2 flavour), at nonzero biases."""
    cfg = dataclasses.replace(smoke_config("smollm-135m"), qkv_bias=True)
    jp, _ = jblocks.init_attention(jax.random.PRNGKey(3), cfg, jnp.float32,
                                   jblocks.NULL_PROFILE)
    rng = np.random.default_rng(3)
    jp = {k: (jnp.asarray(rng.normal(size=v.shape), jnp.float32)
              if k.startswith("b") else v) for k, v in jp.items()}
    tp = tlm.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = rng.normal(size=(B, 20, cfg.d_model)).astype(np.float32)
    want, (wk, wv) = jblocks.apply_attention(jp, jnp.asarray(x), cfg)
    got, (gk, gv) = tblocks.apply_attention(tp, torch.tensor(x), cfg)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _assert_rel(g.numpy(), w, 1e-5)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_attn_forward_loss_and_grads_match_jax(attn_model, impl):
    cfg, jp, tp, toks = attn_model
    batch_j, batch_t = {"tokens": jnp.asarray(toks)}, {
        "tokens": torch.tensor(toks)}
    want, _, _ = jlm.forward(jp, cfg, batch_j, attn_impl=impl)
    got, _, _ = tlm.forward(tp, cfg, batch_t, attn_impl=impl)
    _assert_rel(got.numpy(), want, 1e-5)
    wl, wgrads = jax.value_and_grad(lambda p: jlm.loss_fn(
        p, cfg, batch_j, attn_impl=impl)[0])(jp)
    gl, _, grads = loss_and_grads(cfg, tp, batch_t, attn_impl=impl)
    assert abs(float(gl) - float(wl)) <= 1e-5 * abs(float(wl))
    got_g, want_g = flatten(grads), _jax_flat(wgrads)
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        d = float(np.abs(got_g[k].numpy() - w).max())
        assert d <= 1e-4 * float(np.abs(w).max()), (k, d)


def test_attn_banded_training_path_matches_jax(monkeypatch):
    """impl="auto" at 1024 tokens takes the flash route through
    ``_banded_attention``; with 512-row query chunks that is two launches a
    layer at offsets 0 and 512, as the published 2048-token context runs
    two 1024-row chunks."""
    from repro.models import attention as jattn
    from repro_torch.kernels import ops as tops
    from repro_torch.models import attention as tattn
    monkeypatch.setattr(jattn, "BAND_Q_CHUNK", 512)
    monkeypatch.setattr(tattn, "BAND_Q_CHUNK", 512)
    cfg = _attn_cfg("attn", 2)
    jp, _ = jlm.init_params(jax.random.PRNGKey(5), cfg)
    tp = tlm.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, size=(1, 1024))
    batch_j = {"tokens": jnp.asarray(toks, jnp.int32)}
    calls = []
    real = tattn.jnp_flash
    monkeypatch.setattr(tattn, "jnp_flash",
                        lambda *a: calls.append(a[5]) or real(*a))
    wl, wgrads = jax.value_and_grad(lambda p: jlm.loss_fn(
        p, cfg, batch_j)[0])(jp)
    before = tops.flash_attention_fwd.launches
    gl, _, grads = loss_and_grads(cfg, tp, {"tokens": torch.tensor(toks)})
    assert calls == [0, 512] * cfg.n_layers
    assert tops.flash_attention_fwd.launches == before   # the CPU route
    assert abs(float(gl) - float(wl)) <= 1e-5 * abs(float(wl))
    for k, w in _jax_flat(wgrads).items():
        d = float(np.abs(flatten(grads)[k].numpy() - w).max())
        assert d <= 1e-4 * float(np.abs(w).max()), (k, d)


def test_attn_prefill_caches_match_jax(attn_model):
    cfg, jp, tp, toks = attn_model
    _, wc, _ = jlm.forward(jp, cfg, {"tokens": jnp.asarray(toks)},
                           mode="prefill")
    _, gc, _ = tlm.forward(tp, cfg, {"tokens": torch.tensor(toks)},
                           mode="prefill")
    want, got = _jax_flat(wc), flatten(gc)
    assert set(got) == set(want) == {"kv/k", "kv/v"}
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape == (
            cfg.n_layers, B, cfg.n_kv, toks.shape[1], cfg.head_dim)
        _assert_rel(got[k].detach().numpy(), w, 1e-5)


def test_attn_decode_matches_forward_and_jax(attn_model):
    """Token-by-token decode through the KV caches equals the full forward
    and the JAX package's decode steps, logits and caches.  For the
    window-16 variant the cache is a 16-slot ring buffer and 40 tokens wrap
    it twice."""
    cfg, jp, tp, toks = attn_model
    s = toks.shape[1]
    full, _, _ = tlm.forward(tp, cfg, {"tokens": torch.tensor(toks)})
    tcache = tlm.make_decode_cache(tp, cfg, B, s + 4)
    jcache = jlm.make_decode_cache(jp, cfg, B, s + 4)
    eff = min(s + 4, cfg.window or s + 4)
    assert tuple(tcache["kv"]["k"].shape) == (cfg.n_layers, B, cfg.n_kv, eff,
                                              cfg.head_dim)
    assert tcache["kv"]["len"].dtype == torch.int32
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(p, cfg, c, t))
    for t in range(s):
        got, tcache = tlm.decode_step(tp, cfg, tcache,
                                      torch.tensor(toks[:, t:t + 1]))
        want, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        _assert_rel(got.numpy(), want, 1e-5)
        _assert_rel(got[:, 0].numpy(), full[:, t].detach().numpy(), 1e-5)
    assert [int(v) for v in tcache["kv"]["len"]] == [s] * cfg.n_layers
    for key, w in flatten(jax.tree.map(np.asarray, jcache)).items():
        _assert_rel(flatten(tcache)[key].numpy(), w, 1e-5)


# --------------------------------------------------------------------------- #
# bfloat16 decode: the serve loop's dtype                                      #
# --------------------------------------------------------------------------- #
def _bf16_model(arch, seed):
    cfg = dataclasses.replace(smoke_config(arch), dtype="bfloat16")
    jp, _ = jlm.init_params(jax.random.PRNGKey(seed), cfg)
    tp = tlm.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    return cfg, jp, tp


@pytest.mark.parametrize("arch", ["smollm-135m", "linear-esn"])
def test_bf16_decode_matches_jax(arch):
    """The LM serve loop runs in the config's bfloat16, as the JAX loop does:
    ``decode_step`` of both packages from the same bfloat16 weights, over a
    few tokens.  Logits agree within 2e-2 of the largest |logit|: XLA
    compiles the JAX step (its ``lax.scan`` over layers) as one program and
    keeps some intermediates in float32 that each PyTorch op rounds to
    bfloat16 (8 bits of mantissa), so the two differ by a few bfloat16 ulps
    of the activations (about 1e-2 of the largest logit at this size).
    ``test_bf16_layer_rounds_as_the_jax_ops`` pins the port's own rounding
    points."""
    cfg, jp, tp = _bf16_model(arch, 11)
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab, size=(B, 8)).astype(np.int32)
    tcache = tlm.make_decode_cache(tp, cfg, B, toks.shape[1])
    jcache = jlm.make_decode_cache(jp, cfg, B, toks.shape[1])
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(p, cfg, c, t))
    for t in range(toks.shape[1]):
        got, tcache = tlm.decode_step(tp, cfg, tcache,
                                      torch.tensor(toks[:, t:t + 1]))
        want, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        _assert_rel(got.float().numpy(), np.asarray(want, np.float32), 2e-2)


@pytest.mark.parametrize("arch", ["smollm-135m", "linear-esn"])
def test_bf16_layer_rounds_as_the_jax_ops(arch):
    """Run op by op, one bfloat16 decode layer of the JAX package (norms,
    mixer, SwiGLU MLP with ``jax.nn.silu``'s rounding of the logistic,
    residual adds) equals the port's bit for bit."""
    cfg, jp, tp = _bf16_model(arch, 12)
    kind = jlm.layer_kinds(cfg)[0]
    x = np.random.default_rng(12).normal(size=(B, 1, cfg.d_model))
    jl = jax.tree.map(lambda v: v[0], jp["layers"])
    tl = tree_map(lambda v: v[0], tp["layers"])
    jc = jax.tree.map(lambda v: v[0], jlm.make_decode_cache(jp, cfg, B, 4))
    tc = tree_map(lambda v: v[0], tlm.make_decode_cache(tp, cfg, B, 4))
    want, _, _ = jlm.apply_layer(jl, jnp.asarray(x, jnp.bfloat16), cfg, kind,
                                 jblocks.NULL_PROFILE, mode="decode",
                                 cache=jc)
    got, _, _ = tlm.apply_layer(tl, torch.tensor(x).bfloat16(), cfg, kind,
                                mode="decode", cache=tc)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
