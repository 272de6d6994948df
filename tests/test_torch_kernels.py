"""Port parity: the kernel wrappers against the JAX package's kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the only
reason being that the tensors lie on the CPU); the JAX kernels run their
Pallas bodies in interpret mode.  Tolerances: float64 1e-12 (the same
arithmetic, summed in another order), float32 2e-4 (``tests/test_kernels.py``).
The CUDA kernels themselves are held against the plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import gradcheck

from repro.core import dispatch as jdispatch
from repro.kernels import ops as jops
from repro_torch.core import dispatch as tdispatch
from repro_torch.kernels.diag_scan import (DECODE_MAX_CLUSTER,
                                          DECODE_MAX_SMEM_BYTES,
                                          decode_layout, decode_max_threads)
from repro_torch.kernels import ops as tops

F64 = dict(rtol=1e-12, atol=1e-12)
F32 = dict(rtol=2e-4, atol=2e-4)


def _scan_case(rng, case):
    """(a, x, h0, tol) numpy inputs for one diag_scan case."""
    b, t, n = case["shape"]
    cplx = case.get("complex", False)
    dtype = case.get("dtype", np.float64)
    a_shape = {"static": (n,), "time": (t, n), "full": (b, t, n)}[case["a"]]
    a = rng.uniform(0.3, 0.97, size=a_shape)
    x = rng.normal(size=(b, t, n))
    h0 = rng.normal(size=(b, n)) if case.get("h0") else None
    if cplx:
        a = a * np.exp(1j * rng.uniform(0, np.pi, size=a_shape))
        x = x + 1j * rng.normal(size=(b, t, n))
        if h0 is not None:
            h0 = h0 + 1j * rng.normal(size=(b, n))
    cast = (lambda v: None if v is None else v.astype(
        np.complex64 if cplx else np.float32)) if dtype == np.float32 else (
        lambda v: v)
    return cast(a), cast(x), cast(h0), F32 if dtype == np.float32 else F64


SCAN_CASES = [
    dict(shape=(3, 70, 20), a="static"),
    dict(shape=(2, 37, 16), a="time", complex=True),
    dict(shape=(2, 50, 20), a="full", h0=True),
    dict(shape=(4, 45, 33), a="static", complex=True, h0=True),
    dict(shape=(2, 64, 24), a="static", dtype=np.float32),
]


def _t(v, device="cpu"):
    return None if v is None else torch.tensor(v, device=device)


def _j(v):
    return None if v is None else jnp.asarray(v)


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_diag_scan_wrapper_matches_jax_kernel(case):
    a, x, h0, tol = _scan_case(np.random.default_rng(0), case)
    want = jops.diag_scan(_j(a), _j(x), _j(h0), block_b=2, block_t=16,
                          block_n=16)
    before = tops.diag_scan.launches
    got = tops.diag_scan(_t(a), _t(x), _t(h0))
    assert tops.diag_scan.launches == before      # the CPU takes the plain path
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _split(v, cplx):
    if v is None:
        return None, None
    return (_t(v.real.copy()), _t(v.imag.copy())) if cplx else (_t(v), None)


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_diag_scan_lanes_wrapper_matches_jax_kernel(case):
    """The (re, im) lane entry that the prefill route calls."""
    a, x, h0, tol = _scan_case(np.random.default_rng(0), case)
    want = np.asarray(jops.diag_scan(_j(a), _j(x), _j(h0), block_b=2,
                                     block_t=16, block_n=16))
    cplx = case.get("complex", False)
    before = tops.diag_scan.launches
    got_re, got_im = tops.diag_scan_lanes(*_split(a, cplx), *_split(x, cplx),
                                          *_split(h0, cplx))
    assert tops.diag_scan.launches == before
    np.testing.assert_allclose(got_re.numpy(), want.real, **tol)
    if cplx:
        np.testing.assert_allclose(got_im.numpy(), want.imag, **tol)
    else:
        assert got_im is None


def _assert_scaled(got, want, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(np.asarray(got) - want).max()) if want.size else 0.0
    assert err <= tol * scale, (err, tol * scale)


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_diag_scan_grads_match_jax_vjp(case):
    """Gradients of a real loss of the scan, through both port entries,
    against ``jax.grad`` through the JAX kernel's custom VJP.  JAX returns
    the conjugate of PyTorch's convention for complex inputs, so the lanes
    hold (re, -im) of JAX's gradient and the complex entry its ``conj``."""
    a, x, h0, _ = _scan_case(np.random.default_rng(4), case)
    cplx = case.get("complex", False)
    tol = 1e-4 if case.get("dtype") == np.float32 else 1e-10
    rng = np.random.default_rng(5)
    w_re, w_im = (rng.normal(size=x.shape).astype(x.real.dtype)
                  for _ in range(2))
    inputs = [v for v in (a, x, h0) if v is not None]

    def jloss(*args):
        h = jops.diag_scan(*args, block_b=2, block_t=16, block_n=16)
        return jnp.sum(h.real * w_re + h.imag * w_im)
    want = jax.grad(jloss, argnums=tuple(range(len(inputs))))(
        *map(jnp.asarray, inputs))
    want = [np.conj(np.asarray(w)) for w in want]

    # The complex (or real) entry.
    leaves = [_t(v).requires_grad_() for v in inputs]
    fwd, bwd = tops.diag_scan.launches, tops.diag_scan_bwd.launches
    h = tops.diag_scan(*leaves, *([None] * (3 - len(leaves))))
    loss = (h.real * _t(w_re)).sum() + (
        (h.imag * _t(w_im)).sum() if cplx else 0.0)
    got = torch.autograd.grad(loss, leaves)
    for g, w in zip(got, want):
        _assert_scaled(g.numpy(), w, tol)

    # The lane entry: each operand split into (re, im) leaves.
    lanes = []
    for v in inputs:
        lanes += [_t(v.real.copy()).requires_grad_(),
                  _t(v.imag.copy()).requires_grad_()] if cplx else [
            _t(v).requires_grad_(), None]
    lanes += [None] * (6 - len(lanes))
    h_re, h_im = tops.diag_scan_lanes(*lanes)
    loss = (h_re * _t(w_re)).sum() + (
        (h_im * _t(w_im)).sum() if cplx else 0.0)
    got = torch.autograd.grad(loss, [v for v in lanes if v is not None])
    if cplx:
        want = [part for w in want for part in (w.real, w.imag)]
    for g, w in zip(got, want):
        _assert_scaled(g.numpy(), w, tol)
    assert (tops.diag_scan.launches, tops.diag_scan_bwd.launches) == (fwd,
                                                                       bwd)


@pytest.mark.parametrize("a_kind", ["static", "time", "full"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["no-h0", "h0"])
def test_diag_scan_gradcheck(a_kind, cplx, with_h0):
    """``torch.autograd.gradcheck`` (float64, finite differences) of the
    scan's autograd.Function through both entries."""
    case = dict(shape=(2, 5, 3), a=a_kind, complex=cplx, h0=with_h0)
    a, x, h0, _ = _scan_case(np.random.default_rng(6), case)
    inputs = tuple(_t(v).requires_grad_() for v in (a, x, h0)
                   if v is not None)
    assert gradcheck(lambda *v: tops.diag_scan(*v), inputs)
    lanes = []
    for v in (a, x, h0):
        if v is None:
            lanes += [None, None]
        elif cplx:
            lanes += [_t(v.real.copy()).requires_grad_(),
                      _t(v.imag.copy()).requires_grad_()]
        else:
            lanes += [_t(v).requires_grad_(), None]
    assert gradcheck(lambda *v: tuple(
        o for o in tops.diag_scan_lanes(*v) if o is not None), tuple(lanes))


def _decode_case(rng, *, b=4, nc=20, d=1, batched=False, dtype=np.float64):
    lead = (b,) if batched else ()
    mag = rng.uniform(0.5, 0.95, size=(nc,))
    ph = rng.uniform(0, np.pi, size=(nc,))
    ops = dict(
        a_re=mag * np.cos(ph), a_im=mag * np.sin(ph),
        h_re=rng.normal(size=(b, nc)), h_im=rng.normal(size=(b, nc)),
        y0=rng.normal(size=(b, d)),
        wd_re=0.3 * rng.normal(size=lead + (d, nc)),
        wd_im=0.3 * rng.normal(size=lead + (d, nc)),
        wy=0.2 * rng.normal(size=lead + (d, d)),
        b_out=0.1 * rng.normal(size=lead + (d,)),
        wh_re=0.1 * rng.normal(size=lead + (nc, d)),
        wh_im=0.1 * rng.normal(size=lead + (nc, d)))
    return {k: v.astype(dtype) for k, v in ops.items()}


DECODE_NAMES = ("a_re", "a_im", "h_re", "h_im", "y0", "wd_re", "wd_im", "wy",
                "b_out", "wh_re", "wh_im")


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "3d"])
@pytest.mark.parametrize("b,ensemble", [(4, "off"), (4, "mean"),
                                        (16, "mean"), (17, "mean")])
@pytest.mark.parametrize("d,nc", [(1, 20), (2, 20), (2, 800), (8, 800)],
                         ids=["1", "2", "2-nc800", "8-nc800"])
def test_decode_fused_wrapper_matches_jax_kernel(batched, b, ensemble, d, nc):
    """The plain version against the JAX kernel (interpret mode) with a
    frozen row (row 1); B = 16 and 17 are the ``mean`` route's largest
    one-row-a-block cluster and its first two-rows-a-block one; at 800
    lanes and D = 8 the card splits a row over two blocks."""
    rng = np.random.default_rng(1)
    ops = _decode_case(rng, b=b, nc=nc, d=d, batched=batched)
    for k in ("wh_re", "wh_im"):
        ops[k] *= 20 / nc     # the loop's gain as at 20 lanes
    mask = np.arange(b) != 1
    want = jops.decode_fused(*[_j(ops[k]) for k in DECODE_NAMES],
                             jnp.asarray(mask), k=9, ensemble=ensemble)
    before = tops.decode_fused.launches
    got = tops.decode_fused(*[_t(ops[k]) for k in DECODE_NAMES],
                            torch.tensor(mask), k=9, ensemble=ensemble)
    assert tops.decode_fused.launches == before
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)
    # Frozen rows keep their state and output.
    np.testing.assert_array_equal(got[0][1].numpy(), ops["h_re"][1])
    np.testing.assert_array_equal(got[3][:, 1].numpy(),
                                  np.repeat(ops["y0"][1:2], 9, axis=0))


@pytest.mark.parametrize("use_feedback", [False, True])
@pytest.mark.parametrize("ensemble", ["off", "mean"])
def test_run_decode_fused_matches_jax(use_feedback, ensemble):
    """The packed-Q funnel (lane split, weight slicing, mean seed) against
    the JAX funnel; the CPU tensors take the wrapper's plain version."""
    rng = np.random.default_rng(2)
    nr, npairs, b, d = 3, 8, 4, 1
    n = nr + 2 * npairs
    lam_q = np.concatenate([rng.uniform(-0.9, 0.9, nr),
                            0.6 * rng.normal(size=2 * npairs)])
    w_drive = rng.normal(size=(d, n))
    f = n + 1 + (d if use_feedback else 0)
    w_out = 0.1 * rng.normal(size=(f, d))
    states, y_prev = rng.normal(size=(b, n)), rng.normal(size=(b, d))
    mask = np.array([True, True, False, True])
    kw = dict(use_bias=True, use_feedback=use_feedback, ensemble=ensemble)
    want = jdispatch.run_decode_fused(
        jnp.asarray(lam_q), nr, *map(jnp.asarray, (w_drive, w_out, states,
                                                   y_prev, mask)),
        6, method="pallas", **kw)
    got = tdispatch.run_decode_fused(
        _t(lam_q), nr, _t(w_drive), _t(w_out), _t(states), _t(y_prev),
        torch.tensor(mask), 6, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)


@pytest.mark.parametrize("method", ["ref", "kernel"])
def test_run_decode_fused_methods_match_jax(method):
    """``resolve_decode_method`` and ``run_decode_fused(method=)`` as in the
    JAX package: ``"ref"`` off the card (JAX: off the TPU), ``"kernel"``
    on CUDA and by default; each method on CPU tensors against the JAX
    funnel's ``method="ref"``, and ``"auto"`` bit-equal to the method it
    resolves to."""
    assert tdispatch.resolve_decode_method("cpu") == "ref"
    assert jdispatch.resolve_decode_method("cpu") == "ref"
    assert tdispatch.resolve_decode_method("cuda") == "kernel"
    assert tdispatch.resolve_decode_method(torch.device("cuda", 0)) == \
        "kernel"
    assert tdispatch.resolve_decode_method() == "kernel"
    rng = np.random.default_rng(3)
    nr, npairs, b, d = 2, 6, 5, 2
    n = nr + 2 * npairs
    lam_q = np.concatenate([rng.uniform(-0.9, 0.9, (b, nr)),
                            0.6 * rng.normal(size=(b, 2 * npairs))], -1)
    w_drive = rng.normal(size=(b, d, n))
    w_out = 0.1 * rng.normal(size=(b, n + 1 + d, d))
    states, y_prev = rng.normal(size=(b, n)), rng.normal(size=(b, d))
    mask = np.arange(b) != 3
    kw = dict(use_bias=True, use_feedback=True, ensemble="mean")
    want = jdispatch.run_decode_fused(
        *map(jnp.asarray, (lam_q,)), nr,
        *map(jnp.asarray, (w_drive, w_out, states, y_prev, mask)), 5,
        method="ref", **kw)
    args = (_t(lam_q), nr, _t(w_drive), _t(w_out), _t(states), _t(y_prev),
            torch.tensor(mask), 5)
    got = tdispatch.run_decode_fused(*args, method=method, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)
    for g, a in zip(got, tdispatch.run_decode_fused(*args, **kw)):
        assert torch.equal(g, a)
    with pytest.raises(ValueError, match="unknown decode method"):
        tdispatch.run_decode_fused(*args, method="pallas", **kw)


def test_decode_layout_limits():
    """The decode kernel's layout rule and limits (``decode_layout``)."""
    lay = decode_layout(8, 525, 1, 8)
    assert (lay.warps, lay.per, lay.copies, lay.threads) == (4, 5, 1, 128)
    assert (lay.segs, lay.cluster) == (1, 1)
    # ensemble="off": one block a row, so the layout never depends on B.
    for b in (1, 8, 16, 4096):
        assert decode_layout(b, 525, 1, 8) == lay
    # The shapes the one-block kernel refused: a 16-slot arena at n = 1024,
    # the served model at n = 2048 (1043 lanes), and 4096 lanes.
    assert decode_layout(16, 525, 1, 8).warps == 4
    assert decode_layout(8, 1043, 1, 8)[:2] == (8, 5)
    assert decode_layout(4, 4096, 1, 8)[:2] == (8, 16)
    assert decode_layout(4, 4608, 1, 8)[:2] == (16, 9)
    assert decode_layout(4, 525, 8, 8).warps == 8
    assert decode_layout(3, 40, 2, 8)[:2] == (1, 2)
    # Every shape that fits one block keeps its one-block layout (S = 1).
    for shape in ((16, 525, 1, 8), (8, 1043, 1, 8), (4, 4096, 1, 8),
                  (4, 4608, 1, 8), (4, 525, 8, 8), (3, 40, 2, 8)):
        assert (decode_layout(*shape).segs,
                decode_layout(*shape).cluster) == (1, 1)
    # Past one block a row's lanes split over S blocks of one cluster: at
    # 8192 lanes two segments of 4096, laid out as 4096 lanes in one block.
    split = decode_layout(4, 8192, 1, 8)
    assert (split.segs, split.cluster) == (2, 2)
    assert split[:2] == decode_layout(4, 4096, 1, 8)[:2]
    with pytest.raises(ValueError, match="NC <= 73728 fits"):
        decode_layout(4, 73729, 1, 8)
    assert decode_layout(4, 73728, 1, 8).segs == 16
    with pytest.raises(ValueError, match="NC <= 24576 fits"):
        decode_layout(1, 24577, 8, 4)
    with pytest.raises(ValueError, match="segs=1 does not fit"):
        decode_layout(4, 8192, 1, 8, segs=1)
    # D = 9 runs the wide family: 64 lanes in one block, 8244 split over
    # 12 blocks; past 128 outputs the rule raises.
    assert decode_layout(4, 64, 9, 8).wide
    assert decode_layout(4, 64, 9, 8)[7:] == (1, 1)
    assert decode_layout(4, 8244, 9, 8).wide
    assert decode_layout(4, 8244, 9, 8)[6:] == (12, 12, 1)
    with pytest.raises(ValueError, match="1 <= D <= 128"):
        decode_layout(4, 64, 129, 8)
    # ensemble="mean": the rows over one cluster of G <= 16 blocks of R
    # rows, R x W <= 32 warps, W the fewest that fit; R = 1 up to 16 rows.
    # rows=B forces the one-block layout (G = 1).
    one = decode_layout(8, 525, 1, 8, ensemble="mean", batched=True, rows=8)
    assert (one.warps, one.copies, one.threads, one.cluster) == (2, 8, 512, 1)
    assert one.smem <= DECODE_MAX_SMEM_BYTES
    for b in (1, 8, 16):
        mean = decode_layout(b, 525, 1, 8, ensemble="mean", batched=True)
        assert (mean.warps, mean.per, mean.copies, mean.threads, mean.rows,
                mean.cluster) == (2, 9, 1, 64, 1, b)
    for b, batched in ((16, True), (16, False), (17, True), (32, True),
                       (64, True), (64, False), (100, True), (128, True)):
        mean = decode_layout(b, 525, 1, 8, ensemble="mean", batched=batched)
        assert mean.cluster <= DECODE_MAX_CLUSTER
        assert mean.cluster * mean.rows >= b > (mean.cluster - 1) * mean.rows
        assert mean.rows * mean.warps <= 32
        assert mean.copies == (mean.rows if batched else 1)
        assert mean.smem <= DECODE_MAX_SMEM_BYTES
        assert mean.threads <= decode_max_threads(mean.per, 1, 8)
    assert decode_layout(64, 525, 1, 8, ensemble="mean", batched=True)[
        :3] == (2, 9, 4)
    assert decode_layout(128, 525, 1, 8, ensemble="mean", batched=True)[
        :3] == (2, 9, 8)
    # Past one cluster's 128 rows a grid of clusters of 2 blocks, up to the
    # clusters the card holds at once (66 of 2 blocks: 1056 rows).
    for batched in (True, False):
        assert decode_layout(129, 525, 1, 8, ensemble="mean",
                             batched=batched)[5:] == (8, 2, 1, 9)
        with pytest.raises(ValueError, match=r"one cluster of at most 16 "
                                             r"blocks.*grid.*B <= 1056 fits"):
            decode_layout(1057, 525, 1, 8, ensemble="mean", batched=batched)
    # The mean route splits rows too, one segment a block, B x S <= 16 a
    # cluster.
    wide = decode_layout(8, 8244, 1, 8, ensemble="mean", batched=True)
    assert (wide.segs, wide.cluster, wide.rows, wide.copies) == (2, 16, 1, 1)
    assert wide.smem <= DECODE_MAX_SMEM_BYTES
    assert decode_layout(1, 8244, 8, 8, ensemble="mean").cluster == 11
    assert decode_layout(9, 8244, 1, 8, ensemble="mean",
                         batched=True).grid == 9
    with pytest.raises(ValueError, match="B x S <= 16.*B <= 66 fits"):
        decode_layout(67, 8244, 1, 8, ensemble="mean", batched=True)
    assert decode_layout(2, 8244, 8, 8, ensemble="mean")[6:] == (11, 11, 2)
    with pytest.raises(ValueError, match="B <= 7 fits"):
        decode_layout(8, 8244, 8, 8, ensemble="mean")
    with pytest.raises(ValueError, match="warps=1 does not fit"):
        decode_layout(8, 525, 1, 8, warps=1)
    with pytest.raises(ValueError, match="rows=3 does not fit"):
        decode_layout(64, 525, 1, 8, ensemble="mean", rows=3)
    with pytest.raises(ValueError, match="ensemble='mean' only"):
        decode_layout(8, 525, 1, 8, rows=1)


@pytest.mark.parametrize("itemsize", [8, 4], ids=["f64", "f32"])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_decode_layout_splits_n16384(d, itemsize):
    """NC = 8244 (the port's DPG at n = 16384) fits at every D <= 8 in
    both dtypes, ``off``: the fewest segments S whose block fits (S - 1
    does not), S blocks a cluster, the layout the same at every B."""
    lay = decode_layout(1, 8244, d, itemsize)
    assert 1 < lay.segs <= DECODE_MAX_CLUSTER and lay.cluster == lay.segs
    assert lay.smem <= DECODE_MAX_SMEM_BYTES
    assert lay.threads <= decode_max_threads(lay.per, d, itemsize)
    assert 32 * lay.warps * lay.per * lay.segs >= 8244
    with pytest.raises(ValueError, match="does not fit"):
        decode_layout(1, 8244, d, itemsize, segs=lay.segs - 1)
    for b in (8, 17, 4096):
        assert decode_layout(b, 8244, d, itemsize) == lay


@pytest.mark.parametrize("per,d,itemsize,threads", [
    (3, 1, 8, 512), (10, 1, 8, 512), (12, 1, 8, 256), (1, 8, 8, 512),
    (2, 8, 8, 256), (16, 1, 4, 256), (1, 1, 4, 1024)])
def test_decode_max_threads_mirrors_the_kernel_bounds(per, d, itemsize,
                                                       threads):
    """The launcher's thread bounds, which ``csrc/decode_fused.cu`` repeats
    in each instantiation's ``__launch_bounds__``."""
    assert decode_max_threads(per, d, itemsize) == threads


@pytest.mark.parametrize("per,d,itemsize,threads", [
    (1, 8, 8, 256), (1, 2, 8, 256), (2, 8, 8, 256), (1, 1, 8, 512),
    (16, 1, 4, 256), (1, 8, 4, 512)])
def test_decode_max_threads_of_split_rows(per, d, itemsize, threads):
    """The split instantiations' thread bounds: as the unsplit ones but
    256 at float64, D > 1, one lane a thread (512 spilled), so no split
    layout launches a block past them."""
    assert decode_max_threads(per, d, itemsize, True) == threads
    for nc, segs in ((2600, 11), (8244, 2), (8244, 16)):
        for w in (1, 2, 4, 8, 16):
            try:
                lay = decode_layout(2, nc, d, itemsize, segs=segs, warps=w)
            except ValueError:
                continue
            assert lay.threads <= decode_max_threads(lay.per, d, itemsize,
                                                     True)


@pytest.mark.parametrize("per,d,itemsize,threads", [
    (12, 1, 4, 256), (10, 1, 4, 512), (3, 1, 4, 1024), (1, 8, 8, 256),
    (9, 1, 8, 512), (12, 1, 8, 256)])
def test_decode_max_threads_of_grid_clusters(per, d, itemsize, threads):
    """The ``mean`` grid's instantiations carry the split's arithmetic and
    its bounds, and at float32, D = 1, 12 lanes a thread 256 (512
    spilled); no grid layout launches a block past them."""
    assert decode_max_threads(per, d, itemsize, True, True) == threads
    for b, nc in ((129, 525), (600, 40), (30, 3000), (5, 8244)):
        lay = decode_layout(b, nc, d, itemsize, ensemble="mean",
                            batched=True)
        assert lay.threads <= decode_max_threads(lay.per, d, itemsize,
                                                 True, lay.grid > 1)


def test_wrappers_reject_other_devices():
    x = torch.zeros((1, 4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel for device type 'meta'"):
        tops.diag_scan(torch.zeros(3, device="meta"), x)
    with pytest.raises(ValueError, match="share one device"):
        tops.diag_scan(torch.zeros(3), x)
    with pytest.raises(ValueError, match=r"\(B, T, N\)"):
        tops.diag_scan(torch.zeros(3), torch.zeros(4, 3))
