"""Port parity: the encoder-decoder stack (``whisper-tiny`` at smoke size:
``lm.encode``, the decoder's learned positions ``dec_pos`` and the dense
cross-attention of every decoder layer) against the JAX package's.

``forward`` with ``attn_impl`` ``"dense"`` and ``"flash"`` (the flash path
through B3's plain version here, JAX's through ``jnp_flash``), the loss and
its gradients leaf by leaf, to 1e-5 relative in float32.  Decode follows
the reference exactly: ``decode_step`` adds no learned position and runs no
cross-attention (ROADMAP C8), so its logits equal JAX's and not those of
the forward at the same positions.  The serve driver refuses the arch with
the JAX driver's message.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import lm as jlm
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.train.trainer import loss_and_grads
from repro_torch.tree import flatten

B, S = 2, 12


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def model():
    cfg = smoke_config("whisper-tiny")
    jp, _ = jlm.init_params(jax.random.PRNGKey(11), cfg)
    tp = tlm.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(
                 np.int32),
             "frames": rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
             .astype(np.float32)}
    return cfg, jp, tp, batch


def _t(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_encdec_params_carry_across(model):
    cfg, jp, tp, _ = model
    want = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = flatten(tp)
    assert list(got) == sorted(want)
    for k in ("dec_pos", "encoder/pos", "encoder/final_norm/bias",
              "encoder/layers/mlp/bi", "layers/xattn/wq", "layers/norm_x/scale"):
        assert k in got
    assert "encoder/layers/xattn/wq" not in got
    own = flatten(tlm.init_params(torch.Generator(), cfg, "cpu"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in got.items()}


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_encdec_forward_matches_jax(model, impl):
    cfg, jp, tp, batch = model
    want, _, _ = jax.jit(lambda p: jlm.forward(p, cfg, _j(batch),
                                               attn_impl=impl))(jp)
    got, _, aux = tlm.forward(tp, cfg, _t(batch), attn_impl=impl)
    assert _rel(got.detach().numpy(), want) <= 1e-5
    assert float(aux["load_balance"]) == 0.0
    enc = tlm.encode(tp, cfg, torch.tensor(batch["frames"]), attn_impl=impl)
    jenc = jlm.encode(jp, cfg, jnp.asarray(batch["frames"]),
                      jlm.blocks.NULL_PROFILE, attn_impl=impl)
    assert _rel(enc.detach().numpy(), jenc) <= 1e-5


def test_encdec_loss_and_grads_match_jax(model):
    cfg, jp, tp, batch = model
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, cfg, _j(batch)), has_aux=True))(jp)
    loss, _, grads = loss_and_grads(cfg, tp, _t(batch))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jgf = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
           jax.tree_util.tree_flatten_with_path(jg)[0]}
    for k, g in flatten(grads).items():
        assert _rel(g.numpy(), jgf[k]) <= 1e-5, k


def test_encdec_decode_is_the_references(model):
    cfg, jp, tp, batch = model
    k = 4
    tcache = tlm.make_decode_cache(tp, cfg, B, k)
    jcache = jlm.make_decode_cache(jp, cfg, B, k)
    assert {key: tuple(v.shape) for key, v in flatten(tcache).items()} == {
        "/".join(str(p.key) for p in path): tuple(v.shape) for path, v in
        jax.tree_util.tree_flatten_with_path(jcache)[0]}
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(p, cfg, c, t))
    toks = batch["tokens"]
    full, _, _ = tlm.forward(tp, cfg, _t(batch))
    for t in range(k):
        got, tcache = tlm.decode_step(tp, cfg, tcache,
                                      torch.tensor(toks[:, t:t + 1]))
        want, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        assert _rel(got.numpy(), want) <= 1e-5
        # C8: no dec_pos, no cross-attention — not the forward's logits.
        assert _rel(got[:, 0].numpy(), full[:, t].detach().numpy()) > 1e-2


def test_serve_driver_refuses_encdec_with_the_jax_message():
    with pytest.raises(SystemExit, match="enc-dec serving needs audio "
                                         "frames"):
        tserve.main(["--arch", "whisper-tiny", "--smoke", "--device", "cpu"])
