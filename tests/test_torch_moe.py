"""Port parity: the MoE block (``models/blocks.py``: ``init_moe``,
``moe_route``, ``_moe_local``, ``apply_moe``) and the MoE LMs
(``arctic-480b`` with its dense residual MLP, ``kimi-k2-1t-a32b``) against
the JAX package's.

``_moe_local`` runs at a size where the expert buffers overflow, so the
capacity drops are tested: the kept (token, expert, slot) triples of the
port equal those JAX keeps.  JAX does not return its dispatch, so its kept
(token, expert) pairs are read from its output: each token's output is the
weighted sum of the experts it kept, and exactly one subset of its top-k
reproduces it (the other subsets miss by orders of magnitude more); a kept
assignment's slot is its rank among its expert's kept assignments in
token-major order, which is what JAX's running count gives.  float32
outputs and aux losses to 1e-6, the LMs' logits, losses with aux and
gradients to 1e-5 relative (leaf by leaf); a bfloat16 ``apply_moe`` is held
bit for bit against the JAX ops.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.train.trainer import loss_and_grads
from repro_torch.tree import flatten

T, D, F, E, K, CAP = 96, 16, 24, 8, 2, 14


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def moe_inputs():
    """Tokens whose router logits favour experts 0-2, so those buffers
    overflow CAP (the mean load is T·K/E = 24 against 14 rows)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(T, D)).astype(np.float32)
    router = rng.normal(size=(D, E)).astype(np.float32)
    router[:, :3] += 0.6 * np.sign(x.mean(0))[:, None]
    w = [(rng.normal(size=s) / np.sqrt(s[1])).astype(np.float32)
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    return x, router, w


def _experts_np(x, wg, wu, wd):
    """(T, E, D): every expert's output for every token, float64."""
    x, wg, wu, wd = (np.asarray(v, np.float64) for v in (x, wg, wu, wd))
    g = np.einsum("td,edf->tef", x, wg)
    h = g / (1 + np.exp(-g)) * np.einsum("td,edf->tef", x, wu)
    return np.einsum("tef,efd->ted", h, wd)


def _jax_kept(out, x, router, w, top_w, top_e):
    """JAX's kept (token, expert) pairs, read from its output."""
    f = _experts_np(x, *w)
    kept = set()
    for t in range(T):
        cands = []
        for mask in itertools.product((0, 1), repeat=K):
            y = sum(m * top_w[t, j] * f[t, top_e[t, j]]
                    for j, m in enumerate(mask))
            cands.append((float(np.abs(y - out[t]).max()), mask))
        cands.sort()
        assert cands[0][0] < 1e-4 and cands[1][0] > 100 * cands[0][0], cands
        kept |= {(t, int(top_e[t, j])) for j, m in enumerate(cands[0][1])
                 if m}
    return kept


def test_moe_local_keeps_and_drops_what_jax_does(moe_inputs):
    x, router, w = moe_inputs
    want, jaux = jblocks._moe_local(
        jnp.asarray(x), jnp.asarray(router), *map(jnp.asarray, w), top_k=K,
        capacity=CAP, e_total=E, e_offset=0)
    tx, tr = torch.tensor(x), torch.tensor(router)
    tw = [torch.tensor(v) for v in w]
    got, taux = tblocks._moe_local(tx, tr, *tw, top_k=K, capacity=CAP,
                                   e_total=E)
    assert _rel(got, want) <= 1e-6
    for k in ("load_balance", "router_z"):
        assert abs(float(taux[k]) - float(jaux[k])) <= 1e-6 * abs(
            float(jaux[k])), k
    _, _, top_w, top_e, slot, keep = tblocks.moe_route(
        tx, tr, top_k=K, capacity=CAP, e_local=E)
    jw, je = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ router), K)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(je))
    # The port's triples, and JAX's: its kept pairs, slotted by rank.
    flat_t = np.repeat(np.arange(T), K)
    flat_e = top_e.numpy().reshape(-1)
    keep, slot = keep.numpy(), slot.numpy()
    port = {(int(t), int(e), int(s)) for t, e, s, k in
            zip(flat_t, flat_e, slot, keep) if k}
    jkept = _jax_kept(np.asarray(want), x, router, w,
                      top_w.numpy(), top_e.numpy())
    rank = {e: 0 for e in range(E)}
    jtriples = set()
    for t, e in zip(flat_t, flat_e):
        if (int(t), int(e)) in jkept:
            jtriples.add((int(t), int(e), int(e) * CAP + rank[int(e)]))
            rank[int(e)] += 1
    assert port == jtriples
    dropped = int((~keep).sum())
    assert 0 < dropped and len(port) + dropped == T * K
    assert max(rank.values()) == CAP          # a full buffer


def test_bf16_apply_moe_rounds_as_the_jax_ops():
    """bfloat16 tokens and experts, the float32 router: the products, the
    activation and each of the k weighted adds round as JAX's do."""
    cfg = dataclasses.replace(smoke_config("kimi-k2-1t-a32b"),
                              dtype="bfloat16")
    jp = jblocks.init_moe(jax.random.PRNGKey(5), cfg, jnp.bfloat16,
                          jblocks.NULL_PROFILE)[0]
    tp = tlm.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["router"].dtype == torch.float32
    assert tp["wg"].dtype == torch.bfloat16
    x = np.random.default_rng(5).normal(size=(2, 24, cfg.d_model))
    want, jaux = jblocks.apply_moe(jp, jnp.asarray(x, jnp.bfloat16), cfg,
                                   jblocks.NULL_PROFILE)
    got, taux = tblocks.apply_moe(tp, torch.tensor(x).bfloat16(), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    for k in jaux:
        assert abs(float(taux[k]) - float(jaux[k])) <= 1e-6 * abs(
            float(jaux[k]))


B, S = 2, 24


@pytest.fixture(scope="module", params=["arctic-480b", "kimi-k2-1t-a32b"])
def model(request):
    cfg = smoke_config(request.param)
    jp, _ = jlm.init_params(jax.random.PRNGKey(7), cfg)
    tp = tlm.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab,
                                             size=(B, S)).astype(np.int32)
    return cfg, jp, tp, toks


def test_moe_params_carry_across(model):
    cfg, jp, tp, _ = model
    want = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = flatten(tp)
    assert list(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert "layers/moe/router" in got
    assert ("layers/mlp/wi" in got) == cfg.dense_residual
    assert "layers/mlp/bi" not in got       # arctic's residual: no biases
    own = flatten(tlm.init_params(torch.Generator(), cfg, "cpu"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in got.items()}


def test_moe_lm_logits_loss_and_grads_match_jax(model):
    cfg, jp, tp, toks = model
    batch = {"tokens": jnp.asarray(toks)}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, cfg, batch), has_aux=True))(jp)
    loss, m, grads = loss_and_grads(cfg, tp, {"tokens": torch.tensor(toks)})
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for k in ("nll", "load_balance", "router_z"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k]))
    assert float(m["load_balance"]) > 0 and float(m["router_z"]) > 0
    jgf = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
           jax.tree_util.tree_flatten_with_path(jg)[0]}
    for k, g in flatten(grads).items():
        assert _rel(g.numpy(), jgf[k]) <= 1e-5, k
    logits, _, _ = tlm.forward(tp, cfg, {"tokens": torch.tensor(toks)})
    jlogits, _, _ = jax.jit(lambda p: jlm.forward(p, cfg, batch))(jp)
    assert _rel(logits.detach().numpy(), jlogits) <= 1e-5


def test_moe_lm_decode_step_matches_jax(model):
    cfg, jp, tp, toks = model
    tcache = tlm.make_decode_cache(tp, cfg, B, 8)
    jcache = jlm.make_decode_cache(jp, cfg, B, 8)
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(p, cfg, c, t))
    for t in range(2):
        got, tcache = tlm.decode_step(tp, cfg, tcache,
                                      torch.tensor(toks[:, t:t + 1]))
        want, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        assert _rel(got.numpy(), want) <= 1e-5
