"""Port parity: attention (``kernels.ops.flash_attention*``,
``kernels.ref`` attention, ``models/attention.py``) against the JAX
package's.

Inputs come from numpy seeds and go to both packages.  On the CPU the port's
``flash_attention_fwd`` runs its plain version; the JAX side runs as its own
tests run it: the Pallas kernel in interpret mode behind
``repro.kernels.ops.flash_attention``, and the jnp ``jnp_flash`` in the model.
Tolerances: float32 2e-4 against the Pallas wrapper and 5e-2 in bfloat16
(as ``tests/test_kernels.py`` holds the kernel to its oracle); the model's
attention, which runs the same float32 arithmetic in both packages, 1e-5 of
the largest value (gradients 1e-5 of each gradient's largest value); ``lse``
1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

# (b, hq, hkv, sq, skv, d, causal, window, q_offset): tests/test_kernels.py
KERNEL_CASES = {
    "mha-causal": (1, 2, 2, 64, 64, 32, True, None, 0),
    "gqa": (2, 4, 2, 64, 64, 16, True, None, 0),
    "mqa-ragged": (1, 3, 1, 40, 40, 8, True, None, 0),
    "window": (1, 2, 2, 64, 64, 32, True, 16, 0),
    "decode": (1, 2, 1, 1, 96, 16, True, None, 95),
    "cross-ragged": (1, 2, 2, 48, 80, 16, False, None, 0),
}


def _qkv(b, hq, hkv, sq, skv, d, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def _rel(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 1.0
    assert err <= tol * max(scale, 1e-30), (err, tol * scale)


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


# --------------------------------------------------------------------------- #
# The kernel's entries against the Pallas wrapper                              #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_flash_attention_matches_jax_kernel(name):
    b, hq, hkv, sq, skv, d, causal, window, q_offset = KERNEL_CASES[name]
    q, k, v = _qkv(b, hq, hkv, sq, skv, d)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, window, q_offset,
                                32, 32)
    got = tops.flash_attention(*_t(q, k, v), causal, window, q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_flash_attention_bf16_matches_jax_kernel():
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(1, 2, 32, 16)).astype(np.float32)
               for _ in range(3))
    want = jops.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)), True, None, 0, 16, 16)
    got = tops.flash_attention(*(torch.tensor(a).to(torch.bfloat16)
                                 for a in (q, k, v)), True, None, 0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_flash_attention_grad_matches_jax(name):
    """The wrapper's backward (a recompute through ``attention_ref``)
    against ``jax.grad`` of the JAX wrapper; real tensors, so no conjugate."""
    b, hq, hkv, sq, skv, d, causal, window, q_offset = KERNEL_CASES[name]
    q, k, v = _qkv(b, hq, hkv, sq, skv, d)
    cot = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jops.flash_attention(q, k, v, causal, window,
                                            q_offset, 32, 32) * cot)
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = _t(q, k, v, grad=True)
    tops.flash_attention(*leaves, causal, window, q_offset).backward(
        torch.tensor(cot))
    for got, w in zip(leaves, want):
        _rel(got.grad.numpy(), w, 1e-5)


@pytest.mark.parametrize("kv_len", [None, 50, 0], ids=["all", "50", "none"])
@pytest.mark.parametrize("name", ["gqa", "window", "cross-ragged", "decode"])
def test_flash_fwd_ref_lse_matches_jax_residual(name, kv_len):
    """``flash_attention_fwd`` (the plain version on the CPU) returns the
    output and the ``lse`` residual of JAX ``_jf_fwd``, including -1e30 and
    zeros for rows that see no key."""
    b, hq, hkv, sq, skv, d, causal, window, q_offset = KERNEL_CASES[name]
    q, k, v = _qkv(b, hq, hkv, sq, skv, d)
    kv_len = None if kv_len is None else min(kv_len, skv)
    want, (_, _, _, _, lse) = jattn._jf_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, window,
        q_offset, 16, kv_len)
    before = tops.flash_attention_fwd.launches
    got, got_lse = tops.flash_attention_fwd(*_t(q, k, v), causal=causal,
                                            window=window, q_offset=q_offset,
                                            kv_len=kv_len)
    assert tops.flash_attention_fwd.launches == before     # the CPU route
    _rel(got.numpy(), want, 1e-5)
    lse = np.asarray(lse).reshape(b, hq, sq)
    assert got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_lse.numpy(), lse, rtol=1e-6)
    if kv_len == 0:
        assert float(got.abs().max()) == 0.0
        assert bool((got_lse == -1e30).all())


def test_attention_ref_matches_jax():
    q, k, v = _qkv(2, 4, 2, 24, 40, 8)
    for kw in ({"causal": True, "q_offset": 16}, {"causal": False},
               {"causal": True, "window": 5, "q_offset": 16},
               {"causal": True, "q_offset": -3}):
        want = jref.attention_ref(*map(jnp.asarray, (q, k, v)), **kw)
        _rel(tref.attention_ref(*_t(q, k, v), **kw).numpy(), want, 1e-5)


def test_non_cpu_tensors_raise():
    q = torch.zeros((1, 1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device type 'meta'"):
        tops.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="share one device"):
        tops.flash_attention_fwd(q, torch.zeros((1, 1, 4, 8)), q)


# --------------------------------------------------------------------------- #
# models/attention.py                                                          #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("pos_shape", ["S", "BS"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(pos_shape, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 7, 16)).astype(np.float32)
    pos = (np.arange(7) + 5 if pos_shape == "S"
           else rng.integers(0, 100, size=(2, 7)))
    want = jattn.apply_rope(jnp.asarray(x, dtype), jnp.asarray(pos), 500.0)
    got = tattn.apply_rope(torch.tensor(x).to(getattr(torch, dtype)),
                           torch.tensor(pos), 500.0)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = 1e-5 if dtype == "float32" else 1e-2
    _rel(got.float().numpy(), np.asarray(want, np.float32), tol)


@pytest.mark.parametrize("kw", [
    {"causal": True},
    {"causal": True, "window": 4, "q_offset": 6},
    {"causal": False, "kv_len": 17},
    {"causal": True, "q_offset": 4, "kv_len": 20},
], ids=["causal", "window", "kv_len", "offset-kv_len"])
def test_dense_attention_matches_jax(kw):
    q, k, v = _qkv(2, 6, 2, 10, 24, 8)
    want = jattn.dense_attention(*map(jnp.asarray, (q, k, v)), **kw)
    _rel(tattn.dense_attention(*_t(q, k, v), **kw).numpy(), want, 1e-5)


@pytest.mark.parametrize("ring,window,cur", [
    (False, None, 9), (False, 4, 9), (True, 8, 5), (True, 8, 13),
], ids=["plain", "window", "ring-filling", "ring-wrapped"])
def test_decode_attention_matches_jax(ring, window, cur):
    q, k, v = _qkv(2, 4, 2, 1, 8 if ring else 16, 8, seed=3)
    want = jattn.decode_attention(*map(jnp.asarray, (q, k, v)),
                                  jnp.asarray(cur, jnp.int32), window=window,
                                  ring=ring)
    got = tattn.decode_attention(*_t(q, k, v), torch.tensor(cur,
                                                            dtype=torch.int32),
                                 window=window, ring=ring)
    _rel(got.numpy(), want, 1e-5)


def _grads_match(jfn, tfn, q, k, v, tol=1e-5):
    """Forward and q/k/v gradients of ``sum(out * cot)`` in both packages."""
    cot = np.random.default_rng(11).normal(size=q.shape).astype(np.float32)
    want, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    leaves = _t(q, k, v, grad=True)
    got = tfn(*leaves)
    _rel(got.detach().numpy(), want, tol)
    got.backward(torch.tensor(cot))
    for g, w in zip(leaves, vjp(jnp.asarray(cot))):
        _rel(g.grad.numpy(), w, tol)


@pytest.mark.parametrize("causal,window,q_offset,kv_len", [
    (True, None, 0, None), (True, 8, 0, None), (False, None, 0, 40),
    (True, None, 16, None), (True, None, 16, 40),
], ids=["causal", "window", "kv_len", "offset", "offset-kv_len"])
def test_jnp_flash_forward_and_grads_match_jax(causal, window, q_offset,
                                               kv_len):
    q, k, v = _qkv(2, 4, 2, 32, 48, 16, seed=2)
    _grads_match(
        lambda q, k, v: jattn.jnp_flash(q, k, v, causal, window, q_offset,
                                        16, kv_len),
        lambda q, k, v: tattn.jnp_flash(q, k, v, causal, window, q_offset,
                                        16, kv_len), q, k, v)


@pytest.mark.parametrize("window", [None, 20], ids=["causal", "window"])
def test_banded_attention_matches_jax(monkeypatch, window):
    """Several 32-row query chunks with nonzero offsets, as the 1024-row
    chunks run at 2048 tokens."""
    monkeypatch.setattr(jattn, "BAND_Q_CHUNK", 32)
    monkeypatch.setattr(tattn, "BAND_Q_CHUNK", 32)
    q, k, v = _qkv(1, 4, 2, 96, 96, 16, seed=4)
    before = tops.flash_attention_fwd.launches
    _grads_match(
        lambda q, k, v: jattn.attention(q, k, v, causal=True, window=window,
                                        impl="flash", block_k=16),
        lambda q, k, v: tattn.attention(q, k, v, causal=True, window=window,
                                        impl="flash", block_k=16), q, k, v)
    assert tops.flash_attention_fwd.launches == before


@pytest.mark.parametrize("sq,skv,causal,q_offset,impl,block_k", [
    (24, 40, True, 0, "auto", 16),      # dense below 1024 keys
    (48, 64, True, 0, "flash", 16),     # banded: skv % block_k == 0
    (40, 48, True, 8, "flash", 48),     # one block: skv == block_k
    (30, 40, True, 10, "flash", 16),    # pad: keys beyond every query
    (20, 192, False, 0, "flash", 128),  # non-causal: a divisor >= 64
    (20, 40, False, 0, "flash", 16),    # non-causal, no divisor: kv_len
    (20, 40, True, 30, "flash", 16),    # queries past the keys: kv_len
], ids=["dense", "banded", "one-block", "pad-causal", "divisor", "kv_len",
        "past-keys"])
def test_attention_front_door_matches_jax(sq, skv, causal, q_offset, impl,
                                          block_k):
    q, k, v = _qkv(2, 4, 2, sq, skv, 16, seed=8)
    kw = dict(causal=causal, q_offset=q_offset, impl=impl, block_k=block_k)
    _grads_match(lambda q, k, v: jattn.attention(q, k, v, **kw),
                 lambda q, k, v: tattn.attention(q, k, v, **kw), q, k, v)


# --------------------------------------------------------------------------- #
# The CUDA kernel's numerics: why float32 inputs take the 3xTF32 split         #
# --------------------------------------------------------------------------- #
def _tf32(x):
    """x rounded to nearest at TF32's 11 significant bits, as the kernel
    rounds its operands (Veltkamp's split in float32: t = x (2^13 + 1),
    big = t - (t - x))."""
    t = x * 8193.0
    return t - (t - x)


def _unit(x):
    """What the tensor core reads of a float32 register: its top 19 bits
    (the low 13 mantissa bits dropped)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _product(a, b, passes):
    """a @ b as the kernel's tensor-core products compute it: one TF32 pass
    (operands rounded to TF32), or 3xTF32 (big = tf32(x), small = x - big,
    read by the unit as it reads any register; small*big + big*small +
    big*big, summed in float32); ``passes=0``: in float64."""
    if passes == 0:
        return a.double() @ b.double()
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    return _unit(a - ab) @ bb + ab @ _unit(b - bb) + ab @ bb


def _emulated_attention(q, k, v, q_offset, passes):
    d = q.shape[-1]
    s = _product(q, k.transpose(-1, -2), passes) * d ** -0.5
    mask = tref.attention_mask(q.shape[-2], k.shape[-2], q_offset=q_offset)
    s = torch.where(mask, s, tref.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    return _product(p, v, passes) / l, (m + torch.log(l))[..., 0]


@pytest.mark.parametrize("q_scale", [1.0, 30.0], ids=["chunk", "scores-30"])
def test_one_tf32_pass_misses_the_tolerances_and_3xtf32_keeps_them(q_scale):
    """At head_dim 64 and the training chunks' shape of mask (causal, the
    queries 512 positions in), with the chunks' unit-variance inputs (and q
    scaled 30x, scores of magnitude ~30): one TF32 pass misses the kernel's
    lse tolerance (1e-5 relative; at ~30 the output's 2e-4 too), while the
    3xTF32 split the CUDA kernel runs on float32 inputs stays within both,
    against a float64 reference.  The emulation lives in this test only."""
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(size=(3, 512, 64)) * q_scale,
                     dtype=torch.float32)
    k, v = (torch.tensor(rng.normal(size=(3, 1024, 64)), dtype=torch.float32)
            for _ in range(2))
    want, want_lse = _emulated_attention(q.double(), k.double(), v.double(),
                                         512, 0)

    def errors(passes):
        out, lse = _emulated_attention(q, k, v, 512, passes)
        return (float((out.double() - want).abs().max()),
                float(((lse.double() - want_lse).abs()
                       / want_lse.abs().clamp(min=1.0)).max()))
    out_1, lse_1 = errors(1)
    out_3, lse_3 = errors(3)
    assert lse_1 > 1e-5
    if q_scale > 1:
        assert out_1 > 2e-4
    assert out_3 <= 2e-4 and lse_3 <= 1e-5, (out_3, lse_3)


def _split_product(a, b, passes):
    """a @ b as the head_dim 129..256 route computes it: each of two
    warpgroups takes half the head dim (the contraction), the two partials
    are added (in either order: IEEE addition commutes)."""
    h = a.shape[-1] // 2
    lo = _product(a[..., :h], b[..., :h, :], passes)
    hi = _product(a[..., h:], b[..., h:, :], passes)
    assert torch.equal(lo + hi, hi + lo)
    return lo + hi


def _emulated_split_attention(q, k, v, q_offset, passes):
    """The route's arithmetic: S = Q K^T as the sum of the two head-dim
    halves' partials, then the softmax and P V, each warpgroup's P V over
    its own half of V's dims (a plain product per output dim)."""
    d = q.shape[-1]
    s = _split_product(q, k.transpose(-1, -2), passes) * d ** -0.5
    mask = tref.attention_mask(q.shape[-2], k.shape[-2], q_offset=q_offset)
    s = torch.where(mask, s, tref.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    return _product(p, v, passes) / l, (m + torch.log(l))[..., 0]


@pytest.mark.parametrize("q_scale", [1.0, 30.0], ids=["chunk", "scores-30"])
def test_head_dim_256_split_keeps_the_tolerances_one_tf32_pass_does_not(
        q_scale):
    """recurrentgemma's local layer, head_dim 256, the queries 512
    positions in: the head_dim 129..256 route's arithmetic (3xTF32 on each
    warpgroup's 128 dims, the two partial scores added) stays within the
    kernel's 2e-4 (output) and 1e-5 (lse, relative) of a float64
    reference; one TF32 pass over the same split misses the lse
    tolerance (and, with scores of magnitude ~30, the output's)."""
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.normal(size=(2, 512, 256)) * q_scale,
                     dtype=torch.float32)
    k, v = (torch.tensor(rng.normal(size=(2, 1024, 256)), dtype=torch.float32)
            for _ in range(2))
    want, want_lse = _emulated_attention(q.double(), k.double(), v.double(),
                                         512, 0)

    def errors(passes):
        out, lse = _emulated_split_attention(q, k, v, 512, passes)
        return (float((out.double() - want).abs().max()),
                float(((lse.double() - want_lse).abs()
                       / want_lse.abs().clamp(min=1.0)).max()))
    out_1, lse_1 = errors(1)
    out_3, lse_3 = errors(3)
    assert lse_1 > 1e-5
    if q_scale > 1:
        assert out_1 > 2e-4
    assert out_3 <= 2e-4 and lse_3 <= 1e-5, (out_3, lse_3)
