"""Port parity: the recurrent LM families — recurrentgemma's RG-LRU block
and xLSTM's mLSTM / sLSTM blocks (``models/blocks.py``), and the
``recurrentgemma-2b`` / ``xlstm-125m`` LMs (``models/lm.py``) — against the
JAX package's.

Weights are the JAX ``init_params`` output carried over with
``lm_params_from_numpy``; inputs come from numpy seeds.  On the CPU the
port's scans (RG-LRU, sLSTM) and flash attention run their plain versions;
the JAX side runs as its own tests run it (``diag_scan(method="chunked")``,
``jnp_flash``).  Tolerances, float32: block outputs, logits and losses 1e-5
of their largest value, gradients leaf-wise 1e-4 of each leaf's largest
value (the frameworks sum in different orders; the sLSTM stabiliser's
max-plus scan groups its sums in another tree than XLA's), trainer losses
1e-4 relative, as ``tests/test_torch_train.py``.  The bfloat16 tests hold
the port to JAX's dtypes: recurrentgemma's embed scale makes the
activations float32, so its decode agrees with JAX to 1e-4 of the largest
logit over a few steps (the weights are bfloat16 but the products are
float32 on both sides; the local layer's bfloat16 keys, values and
attention output round at the same points in both).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.data import pipeline as jpipe
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import smoke_config as tsmoke_config
from repro_torch.data import pipeline as tpipe
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.train.trainer import TrainConfig, Trainer, loss_and_grads
from repro_torch.tree import flatten, tree_map

B = 2
ARCHS = ("recurrentgemma-2b", "xlstm-125m")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return tree_map(torch.tensor, tree)


def _assert_rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (err, tol)


def _smoke_model(arch):
    """(cfg, JAX params, port params, tokens) of one smoke-size LM."""
    cfg = smoke_config(arch)
    jp, _ = jlm.init_params(jax.random.PRNGKey(3), cfg)
    tp = tlm.lm_params_from_numpy(_np(jp), "cpu")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(B, 40)).astype(np.int32)
    return cfg, jp, tp, toks


@pytest.fixture(scope="module")
def rg():
    return _smoke_model("recurrentgemma-2b")


@pytest.fixture(scope="module")
def xl():
    return _smoke_model("xlstm-125m")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return request.getfixturevalue(
        {"recurrentgemma-2b": "rg", "xlstm-125m": "xl"}[request.param])


def _layer(jp, tp, i):
    return jp["layers"][f"layer_{i}"], tp["layers"][f"layer_{i}"]


# --------------------------------------------------------------------------- #
# Blocks                                                                       #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("with_state", [False, True], ids=["pad", "state"])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, 9, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    st = rng.normal(size=(B, 3, 24)).astype(np.float32) if with_state \
        else None
    want, wst = jblocks._causal_conv(
        jnp.asarray(x), jnp.asarray(w), None if st is None else
        jnp.asarray(st))
    got, gst = tblocks._causal_conv(
        torch.tensor(x), torch.tensor(w), None if st is None else
        torch.tensor(st))
    _assert_rel(got.numpy(), want, 1e-6)
    np.testing.assert_array_equal(gst.numpy(), np.asarray(wst))


def test_rglru_init_has_the_jax_layout():
    """Same keys, shapes and dtypes as the JAX init; ``lam_p`` (drawn from
    ``np.random.default_rng(0)`` by both) bit-equal."""
    cfg = smoke_config("recurrentgemma-2b")
    jp, _ = jblocks.init_rglru_block(jax.random.PRNGKey(0), cfg, jnp.float32,
                                     jblocks.NULL_PROFILE)
    tp = tblocks.init_rglru_block(torch.Generator().manual_seed(0), cfg,
                                  torch.float32)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tp.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()}
    np.testing.assert_array_equal(tp["lam_p"].numpy(),
                                  np.asarray(jp["lam_p"]))


@pytest.mark.parametrize("mode", ["train", "decode"])
def test_rglru_block_matches_jax(rg, mode):
    """A sequence from zero state, or one decode token against a carried
    ``{"conv", "h"}`` cache (the sequential fast path)."""
    cfg, jp, tp, _ = rg
    jl, tl = _layer(jp, tp, 0)
    rng = np.random.default_rng(5)
    s = 1 if mode == "decode" else 33
    x = rng.normal(size=(B, s, cfg.d_model)).astype(np.float32)
    cache = None if mode == "train" else {
        "conv": rng.normal(size=(B, cfg.conv_width - 1, cfg.d_rnn)
                           ).astype(np.float32),
        "h": rng.normal(size=(B, cfg.d_rnn)).astype(np.float32)}
    want, wc = jblocks.apply_rglru_block(
        jl["rglru"], jnp.asarray(x), cfg, scan_method="chunked",
        cache=None if cache is None else jax.tree.map(jnp.asarray, cache))
    got, gc = tblocks.apply_rglru_block(
        tl["rglru"], torch.tensor(x), cfg,
        cache=None if cache is None else _t(cache))
    _assert_rel(got.numpy(), want, 1e-5)
    for k in ("conv", "h"):
        assert gc[k].dtype == torch.float32
        _assert_rel(gc[k].numpy(), wc[k], 1e-5)


@pytest.mark.parametrize("s", [128, 37], ids=["2-chunks", "odd-length"])
def test_mlstm_matches_jax(xl, s):
    """Two 64-token chunks, and an odd length (one chunk), each from a
    carried ``{"C", "n"}`` state."""
    cfg, jp, tp, _ = xl
    jl, tl = _layer(jp, tp, 0)
    rng = np.random.default_rng(6)
    hd = cfg.d_model // cfg.n_heads
    x = rng.normal(size=(B, s, cfg.d_model)).astype(np.float32)
    cache = {"C": rng.normal(size=(B, cfg.n_heads, hd, hd)).astype(
        np.float32) * 0.1,
        "n": np.abs(rng.normal(size=(B, cfg.n_heads, hd))).astype(np.float32)}
    want, wc = jblocks.apply_mlstm(jl["mix"], jnp.asarray(x), cfg,
                                   cache=jax.tree.map(jnp.asarray, cache))
    got, gc = tblocks.apply_mlstm(tl["mix"], torch.tensor(x), cfg,
                                  cache=_t(cache))
    _assert_rel(got.numpy(), want, 1e-5)
    for k in ("C", "n"):
        _assert_rel(gc[k].numpy(), wc[k], 1e-5)


@pytest.mark.parametrize("start", ["none", "fresh", "carried"])
def test_slstm_matches_jax(xl, start):
    """No cache; a fresh decode cache (``m`` = -1e30, the max-plus carry
    folded into step 0); a carried ``{"c", "n", "m"}`` state."""
    cfg, jp, tp, _ = xl
    jl, tl = _layer(jp, tp, 1)
    rng = np.random.default_rng(7)
    d = cfg.d_model
    x = rng.normal(size=(B, 29, d)).astype(np.float32)
    cache = None
    if start == "fresh":
        cache = {"c": np.zeros((B, d), np.float32),
                 "n": np.zeros((B, d), np.float32),
                 "m": np.full((B, d), -1e30, np.float32)}
    elif start == "carried":
        cache = {"c": rng.normal(size=(B, d)).astype(np.float32),
                 "n": np.abs(rng.normal(size=(B, d))).astype(np.float32) + 1,
                 "m": rng.normal(size=(B, d)).astype(np.float32)}
    want, wc = jblocks.apply_slstm(
        jl["mix"], jnp.asarray(x), cfg,
        cache=None if cache is None else jax.tree.map(jnp.asarray, cache))
    got, gc = tblocks.apply_slstm(
        tl["mix"], torch.tensor(x), cfg,
        cache=None if cache is None else _t(cache))
    _assert_rel(got.numpy(), want, 1e-5)
    for k in ("c", "n", "m"):
        _assert_rel(gc[k].numpy(), wc[k], 1e-5)


def test_maxplus_scan_equals_the_recurrence():
    """The doubling scan against the recurrence it stands for, step by
    step in float64, over lengths that are and are not powers of two."""
    rng = np.random.default_rng(8)
    for t in (1, 2, 5, 16, 37):
        f = -np.abs(rng.normal(size=(3, t, 4)))
        i = rng.normal(size=(3, t, 4))
        m, want = np.full((3, 4), -np.inf), []
        for k in range(t):
            m = np.maximum(f[:, k] + m, i[:, k])
            want.append(m)
        got = tblocks._maxplus_scan(torch.tensor(f), torch.tensor(i))
        np.testing.assert_allclose(got.numpy(), np.stack(want, 1),
                                   rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------------------- #
# Whole models                                                                 #
# --------------------------------------------------------------------------- #
def test_carried_params_keep_keys_shapes_and_values(model):
    cfg, jp, tp, _ = model
    want = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = flatten(tp)
    assert list(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    own = tlm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {k: (v.shape, v.dtype) for k, v in flatten(own).items()} == \
        {k: (v.shape, v.dtype) for k, v in got.items()}
    assert "norm2" not in tp["layers"]["layer_0"] or cfg.d_ff > 0


def test_forward_loss_and_grads_match_jax(model):
    cfg, jp, tp, toks = model
    batch = {"tokens": jnp.asarray(toks)}

    @jax.jit
    def jax_side(p):
        logits = jlm.forward(p, cfg, batch)[0]
        loss, grads = jax.value_and_grad(
            lambda p: jlm.loss_fn(p, cfg, batch)[0])(p)
        return logits, loss, grads
    want, wl, wgrads = jax_side(jp)
    got, _, _ = tlm.forward(tp, cfg, {"tokens": torch.tensor(toks)})
    _assert_rel(got.detach().numpy(), want, 1e-5)
    gl, _, grads = loss_and_grads(cfg, tp, {"tokens": torch.tensor(toks)})
    assert abs(float(gl) - float(wl)) <= 1e-5 * abs(float(wl))
    want = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(wgrads)[0]}
    got = flatten(grads)
    assert set(got) == set(want)
    for k, w in want.items():
        d = float(np.abs(got[k].numpy() - w).max())
        assert d <= 1e-4 * float(np.abs(w).max()), (k, d)


def test_decode_matches_forward_and_jax(model):
    """K decode steps from a fresh cache equal the full forward and the
    JAX package's decode steps; the last cache equals JAX's."""
    cfg, jp, tp, toks = model
    k = 10
    full, _, _ = tlm.forward(tp, cfg, {"tokens": torch.tensor(toks[:, :k])})
    tcache = tlm.make_decode_cache(tp, cfg, B, k + 2)
    jcache = jlm.make_decode_cache(jp, cfg, B, k + 2)
    assert {key: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for key, v in flatten(tcache).items()} == \
        {key: (tuple(v.shape), str(v.dtype))
         for key, v in flatten(_np(jcache)).items()}
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(p, cfg, c, t))
    for t in range(k):
        got, tcache = tlm.decode_step(tp, cfg, tcache,
                                      torch.tensor(toks[:, t:t + 1]))
        want, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        _assert_rel(got.numpy(), want, 1e-5)
        _assert_rel(got[:, 0].numpy(), full[:, t].detach().numpy(), 1e-5)
    for key, w in flatten(_np(jcache)).items():
        _assert_rel(flatten(tcache)[key].numpy(), w, 1e-5)


def test_prefill_caches_match_jax(model):
    cfg, jp, tp, toks = model
    _, wc, _ = jlm.forward(jp, cfg, {"tokens": jnp.asarray(toks)},
                           mode="prefill")
    _, gc, _ = tlm.forward(tp, cfg, {"tokens": torch.tensor(toks)},
                           mode="prefill")
    want = flatten(_np(wc))
    got = flatten(gc)
    assert set(got) == set(want)
    for key, w in want.items():
        _assert_rel(got[key].detach().numpy(), w, 1e-5)


# --------------------------------------------------------------------------- #
# bfloat16: the serve loop's dtype and the embed scale's promotion            #
# --------------------------------------------------------------------------- #
def _bf16_model(arch, seed):
    cfg = dataclasses.replace(smoke_config(arch), dtype="bfloat16")
    jp, _ = jlm.init_params(jax.random.PRNGKey(seed), cfg)
    tp = tlm.lm_params_from_numpy(_np(jp), "cpu")
    # Every leaf carries over in its JAX dtype, bfloat16 bit for bit (the
    # RG-LRU's lam_p stays float32).
    for key, w in flatten(_np(jp)).items():
        got = flatten(tp)[key]
        assert str(got.dtype).split(".")[-1] == str(w.dtype), key
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(w, np.float32))
    assert tp["embed"].dtype == torch.bfloat16
    return cfg, jp, tp


@pytest.mark.parametrize("layer", [0, 2], ids=["rglru", "local"])
def test_bf16_embed_scale_promotes_as_jax(layer):
    """recurrentgemma scales its bfloat16 embeddings by a float32 scalar;
    JAX promotes them to float32, and every later product with a bfloat16
    weight runs in float32 (the RG-LRU conv state and the local layer's
    float32 keys and values written into its bfloat16 cache included).
    One decode layer of each kind from a fresh cache, on the scaled
    embeddings of a few tokens: outputs and caches in JAX's dtypes,
    values within float32 rounding (1e-5)."""
    cfg, jp, tp = _bf16_model("recurrentgemma-2b", 21)
    kind = jlm.layer_kinds(cfg)[layer]
    toks = np.random.default_rng(21).integers(0, cfg.vocab, size=(B, 1))
    jx = jlm._embed_tokens(jp, cfg, jnp.asarray(toks), jblocks.NULL_PROFILE)
    jx = jx * np.sqrt(cfg.d_model).astype(np.float32)
    tx = tlm._embed_tokens(tp, cfg, torch.tensor(toks), tblocks.NULL_PROFILE)
    assert jx.dtype == jnp.float32 and tx.dtype == torch.float32
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    jl, tl = _layer(jp, tp, layer)
    jc = jlm.make_decode_cache(jp, cfg, B, 4)[f"layer_{layer}"]
    tc = tlm.make_decode_cache(tp, cfg, B, 4)[f"layer_{layer}"]
    for _ in range(2):
        want, jc, _ = jlm.apply_layer(jl, jx, cfg, kind, jblocks.NULL_PROFILE,
                                      mode="decode", cache=jc)
        got, tc, _ = tlm.apply_layer(tl, tx, cfg, kind, mode="decode",
                                     cache=tc)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        _assert_rel(got.numpy(), want, 1e-5)
        for key, w in flatten(_np(jc)).items():
            g = flatten(tc)[key]
            assert str(g.dtype).split(".")[-1] == str(w.dtype), key
            _assert_rel(g.float().numpy(), np.asarray(w, np.float32), 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_matches_jax(arch):
    """The bfloat16 serve loop's ``decode_step`` of both packages over a
    few tokens.  recurrentgemma's logits are float32 on both sides (the
    embed scale) and agree to 1e-4; xlstm has no embed scale, so it runs
    bfloat16 activations, and agrees to 2e-2 of the largest |logit|, as
    ``tests/test_torch_lm.py::test_bf16_decode_matches_jax`` explains."""
    cfg, jp, tp = _bf16_model(arch, 22)
    toks = np.random.default_rng(22).integers(
        0, cfg.vocab, size=(B, 6)).astype(np.int32)
    tcache = tlm.make_decode_cache(tp, cfg, B, toks.shape[1])
    jcache = jlm.make_decode_cache(jp, cfg, B, toks.shape[1])
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(p, cfg, c, t))
    promoted = cfg.embed_scale
    for t in range(toks.shape[1]):
        got, tcache = tlm.decode_step(tp, cfg, tcache,
                                      torch.tensor(toks[:, t:t + 1]))
        want, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        assert str(got.dtype).split(".")[-1] == str(want.dtype) == \
            ("float32" if promoted else "bfloat16")
        _assert_rel(got.float().numpy(), np.asarray(want, np.float32),
                    1e-4 if promoted else 2e-2)


# --------------------------------------------------------------------------- #
# Trainer and drivers                                                          #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_losses_match_jax_trainer(arch):
    """Three AdamW steps from the same weights and batches."""
    cfg = dataclasses.replace(smoke_config(arch), vocab=64)
    data = tpipe.MarkovTokens(vocab=cfg.vocab, batch=2, seq_len=32)
    jdata = jpipe.MarkovTokens(vocab=cfg.vocab, batch=2, seq_len=32)
    jtr = JTrainer(cfg, JTrainConfig(steps=3, log_every=0, lr=1e-2), jdata,
                   scan_method="chunked")
    jstate = jtr.init_state(0)
    tr = Trainer(cfg, TrainConfig(steps=3, log_every=0, lr=1e-2), data,
                 device="cpu")
    tstate = tlm.lm_params_from_numpy(_np(jstate), "cpu")
    jtr.run(start_state=jstate)
    tr.run(start_state=tstate)
    np.testing.assert_allclose(tr.losses, jtr.losses, rtol=1e-4)


def test_recurrent_archs_are_ported():
    names = tlm.ported_archs()
    assert "recurrentgemma-2b" in names and "xlstm-125m" in names
    for name in ARCHS:
        tlm.check_ported(tsmoke_config(name))


@pytest.mark.parametrize("argv", [
    [],
    ["--arch", "xlstm-125m"],
], ids=["default-recurrentgemma", "xlstm"])
def test_serve_driver_runs_recurrent_lms_on_cpu(argv):
    from repro_torch.launch import serve
    res = serve.main(argv + ["--smoke", "--batch", "2", "--prompt-len", "5",
                             "--gen", "4", "--device", "cpu"])
    assert res["arch"] == (argv[1] if argv else "recurrentgemma-2b")
    assert res["finite"] and res["tokens"].shape == (2, 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_driver_runs_recurrent_lms_on_cpu(arch):
    """``launch.train`` at smoke size; recurrentgemma at 1024 tokens so its
    local layer takes the flash route."""
    from repro_torch.launch import train
    seq = 1024 if arch == "recurrentgemma-2b" else 64
    res = train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch",
                      "1", "--seq", str(seq), "--vocab", "64", "--device",
                      "cpu"])
    assert res["steps_run"] == 2 and res["finite"] and res["arch"] == arch
