"""Port parity: the fused decode's packed-layout plain version against the
JAX kernel.

``ref.decode_fused_packed_ref`` — the plain version the CUDA kernel's
packed entry is held against on the card, and what ``run_decode_fused``
runs on the CPU — against ``repro.core.dispatch.run_decode_fused(
method="pallas")``, the JAX kernel in interpret mode, on the same packed Q
operands made with numpy: shared 2D and per-slot 3D weights, ``ensemble``
off and mean, partial masks, K in {0, 1, 6}, D in {1, 3}, with and without
the bias and feedback rows, and a 16-slot arena.  The JAX kernel cannot run
K = 0 in interpret mode (its empty ``ys`` output fails a slice), so K = 0 is
held against the JAX funnel's plain route (``method="ref"``).  Tolerance
float64 1e-12 (``tests/test_torch_kernels.py``: the same arithmetic summed
in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro_torch.core import dispatch as tdispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

F64 = dict(rtol=1e-12, atol=1e-12)


def _packed_case(rng, b, nr, npairs, d, batched, bias, fb):
    """Packed Q operands ``(lam_q, w_drive, w_out, states, y_prev)``."""
    n = nr + 2 * npairs
    lead = (b,) if batched else ()
    mag = rng.uniform(0.5, 0.95, lead + (npairs,))
    ph = rng.uniform(0, np.pi, lead + (npairs,))
    pairs = np.stack([mag * np.cos(ph), mag * np.sin(ph)], -1).reshape(
        lead + (2 * npairs,))
    lam = np.concatenate([rng.uniform(-0.9, 0.9, lead + (nr,)), pairs], -1)
    f = n + int(bias) + (d if fb else 0)
    return (lam, 0.3 * rng.normal(size=lead + (d, n)),
            0.1 * rng.normal(size=lead + (f, d)), rng.normal(size=(b, n)),
            rng.normal(size=(b, d)))


def _both(ops, nr, mask, k, **kw):
    """(port plain version, JAX kernel) on the same numpy operands."""
    lam, w_drive, w_out, states, y_prev = ops
    t = [torch.tensor(v) for v in ops]
    got = tref.decode_fused_packed_ref(t[0], nr, *t[1:],
                                       torch.tensor(mask), k=k, **kw)
    want = jdispatch.run_decode_fused(
        jnp.asarray(lam), nr, *map(jnp.asarray, (w_drive, w_out, states,
                                                 y_prev, mask)),
        k, method="pallas" if k else "ref", **kw)
    return got, want


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "3d"])
@pytest.mark.parametrize("ensemble", ["off", "mean"])
@pytest.mark.parametrize("k", [0, 1, 6])
@pytest.mark.parametrize("d", [1, 3])
def test_packed_plain_matches_jax_kernel(batched, ensemble, k, d):
    rng = np.random.default_rng(10 * k + d)
    nr, b = 3, 5
    ops = _packed_case(rng, b, nr, 7, d, batched, bias=True, fb=True)
    mask = np.array([True, False, True, True, False])
    got, want = _both(ops, nr, mask, k, use_bias=True, use_feedback=True,
                      ensemble=ensemble)
    for g, w in zip(got, want):
        assert g.shape == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)
    # Frozen rows keep their packed state and output.
    np.testing.assert_array_equal(got[0][1].numpy(), ops[3][1])
    np.testing.assert_array_equal(got[1][4].numpy(), ops[4][4])


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "3d"])
@pytest.mark.parametrize("ensemble", ["off", "mean"])
@pytest.mark.parametrize("d", [16, 64])
def test_packed_plain_matches_jax_kernel_past_8_outputs(batched, ensemble, d):
    """D = 16 and 64 (the card runs them through B2's wide family; the JAX
    kernel pads D to a multiple of 128), K = 6, a partial mask."""
    rng = np.random.default_rng(100 + d)
    nr, b = 3, 5
    ops = _packed_case(rng, b, nr, 7, d, batched, bias=True, fb=True)
    ops[2][..., 1:1 + d, :] *= 8.0 / d      # the feedback's gain below one
    mask = np.array([True, False, True, True, False])
    got, want = _both(ops, nr, mask, 6, use_bias=True, use_feedback=True,
                      ensemble=ensemble)
    for g, w in zip(got, want):
        assert g.shape == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)
    np.testing.assert_array_equal(got[0][1].numpy(), ops[3][1])
    np.testing.assert_array_equal(got[1][4].numpy(), ops[4][4])


@pytest.mark.parametrize("use_bias,use_feedback",
                         [(False, False), (True, False), (False, True)])
def test_packed_plain_readout_rows_match_jax(use_bias, use_feedback):
    rng = np.random.default_rng(7)
    ops = _packed_case(rng, 4, 0, 9, 2, False, use_bias, use_feedback)
    got, want = _both(ops, 0, np.array([True, True, False, True]), 6,
                      use_bias=use_bias, use_feedback=use_feedback)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)


@pytest.mark.parametrize("ensemble", ["off", "mean"])
def test_packed_plain_sixteen_slots_match_jax(ensemble):
    """A 16-slot arena (the JAX benchmark's mixed-traffic arena size)."""
    rng = np.random.default_rng(16)
    ops = _packed_case(rng, 16, 5, 40, 1, True, bias=True, fb=False)
    mask = np.arange(16) % 5 != 2
    got, want = _both(ops, 5, mask, 6, use_bias=True, use_feedback=False,
                      ensemble=ensemble)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)


def test_cpu_routes_take_the_packed_plain_version():
    """On CPU tensors ``ops.decode_fused_packed`` and ``run_decode_fused``
    are the packed plain version, bit for bit, and launch nothing."""
    rng = np.random.default_rng(3)
    ops = [torch.tensor(v) for v in _packed_case(rng, 4, 2, 6, 1, False,
                                                  True, True)]
    mask = torch.tensor([True, False, True, True])
    kw = dict(use_bias=True, use_feedback=True, ensemble="mean")
    want = tref.decode_fused_packed_ref(ops[0], 2, *ops[1:], mask, k=5, **kw)
    before = tops.decode_fused.launches
    for got in (tops.decode_fused_packed(ops[0], 2, *ops[1:], mask, k=5,
                                         **kw),
                tdispatch.run_decode_fused(ops[0], 2, *ops[1:], mask, 5,
                                           **kw)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert tops.decode_fused.launches == before


def test_packed_plain_past_one_cluster_matches_jax():
    """A ``mean`` arena past one thread-block cluster of the card's kernel
    (160 per-slot members of n = 1024, 525 lanes: a grid of ten clusters
    there) through the plain version the grid route is held against on the
    card, against the JAX funnel's plain route (``method="ref"``; its
    interpret-mode kernel at this size is minutes), K = 8, float64, with
    rows 3 and 100 frozen."""
    rng = np.random.default_rng(160)
    nr, npairs = 26, 499                  # n = 1024, NC = 525
    ops = _packed_case(rng, 160, nr, npairs, 1, True, bias=True, fb=True)
    ops[2][..., 2:, :] *= 5.0 / (nr + 2 * npairs)   # keep the loop's gain < 1
    mask = np.ones(160, dtype=bool)
    mask[[3, 100]] = False
    kw = dict(use_bias=True, use_feedback=True, ensemble="mean")
    t = [torch.tensor(v) for v in ops]
    got = tref.decode_fused_packed_ref(t[0], nr, *t[1:], torch.tensor(mask),
                                       k=8, **kw)
    want = jdispatch.run_decode_fused(
        jnp.asarray(ops[0]), nr, *map(jnp.asarray, (*ops[1:], mask)), 8,
        method="ref", **kw)
    for g, w in zip(got, want):
        assert g.shape == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)
    np.testing.assert_array_equal(got[0][[3, 100]].numpy(), ops[3][[3, 100]])
    np.testing.assert_array_equal(got[1][[3, 100]].numpy(), ops[4][[3, 100]])
    live = np.flatnonzero(mask)
    assert bool((got[2][:, live] == got[2][:, live[:1]]).all())
