"""The scan kernels' time-chunked decomposition, held against the JAX package.

``ref.diag_scan_lanes_chunked_ref`` and ``ref.diag_scan_lanes_bwd_chunked_ref``
run, step by step in PyTorch, what the CUDA scan kernels run on the card:
reduce each chunk from a zero carry, compose the carries (``a ** L`` for a
static ``a``, the conjugated products in reverse time for the gradient),
rescan.  Here they meet the JAX kernel wrapper (its Pallas body in interpret
mode, as ``tests/test_torch_kernels.py`` runs it), the JAX chunked scan and
the JAX kernel's VJP, at small sizes on the CPU.  Tolerances: float64 1e-12
(the same arithmetic, summed in another order), float32 2e-5.  The CUDA
kernels are held against the same plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scan as jscan
from repro.kernels import ops as jops
from repro_torch.kernels.diag_scan import (SCAN_MIN_CHUNK,
                                          SCAN_TARGET_THREADS, scan_chunks)
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref

T = 37                                  # a multiple of neither 2 nor 7
CHUNKS = [1, 2, 7, T, T + 3]
KINDS = ["static", "time", "full"]
TOL = {np.float64: 1e-12, np.float32: 2e-5}
BLOCKS = dict(block_b=2, block_t=16, block_n=16)


@functools.lru_cache(maxsize=None)
def _case(a_kind, cplx, with_h0, dtype=np.float64, seed=0):
    """numpy (a, x, h0) of one case, (B, T, N) = (3, 37, 6)."""
    rng = np.random.default_rng(seed)
    b, n = 3, 6
    a_shape = {"static": (n,), "time": (T, n), "full": (b, T, n)}[a_kind]
    a = rng.uniform(0.3, 0.97, size=a_shape)
    x = rng.normal(size=(b, T, n))
    h0 = rng.normal(size=(b, n)) if with_h0 else None
    if cplx:
        a = a * np.exp(1j * rng.uniform(0, np.pi, size=a_shape))
        x = x + 1j * rng.normal(size=(b, T, n))
        if h0 is not None:
            h0 = h0 + 1j * rng.normal(size=(b, n))
    if dtype == np.float32:
        cast = np.complex64 if cplx else np.float32
        a, x = a.astype(cast), x.astype(cast)
        h0 = None if h0 is None else h0.astype(cast)
    return a, x, h0


def _lanes(v, cplx):
    if v is None:
        return None, None
    if cplx:
        return torch.tensor(v.real.copy()), torch.tensor(v.imag.copy())
    return torch.tensor(v), None


def _j(v):
    return None if v is None else jnp.asarray(v)


@functools.lru_cache(maxsize=None)
def _jax_forward(a_kind, cplx, with_h0, dtype=np.float64):
    a, x, h0 = _case(a_kind, cplx, with_h0, dtype)
    return np.asarray(jops.diag_scan(_j(a), _j(x), _j(h0), **BLOCKS))


def _assert_lanes(got, want, cplx, tol):
    np.testing.assert_allclose(got[0].numpy(), want.real, rtol=tol, atol=tol)
    if cplx:
        np.testing.assert_allclose(got[1].numpy(), want.imag, rtol=tol,
                                   atol=tol)
    else:
        assert got[1] is None


@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("with_h0", [False, True], ids=["no-h0", "h0"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("a_kind", KINDS)
def test_chunked_scan_matches_jax_kernel(a_kind, cplx, with_h0, chunks):
    a, x, h0 = _case(a_kind, cplx, with_h0)
    got = ref.diag_scan_lanes_chunked_ref(
        *_lanes(a, cplx), *_lanes(x, cplx), *_lanes(h0, cplx), chunks=chunks)
    _assert_lanes(got, _jax_forward(a_kind, cplx, with_h0), cplx,
                  TOL[np.float64])


@pytest.mark.parametrize("chunks", [2, 7, T + 3])
@pytest.mark.parametrize("with_h0", [False, True], ids=["no-h0", "h0"])
@pytest.mark.parametrize("a_kind", KINDS)
def test_chunked_scan_matches_jax_chunked_scan(a_kind, with_h0, chunks):
    """The JAX package's own chunked scan (chunk length L, as the kernel's
    ``chunk_layout`` cuts T)."""
    a, x, h0 = _case(a_kind, True, with_h0)
    _, size = ref.chunk_layout(T, chunks)
    want = np.asarray(jscan.diag_scan_chunked(_j(a), _j(x), _j(h0),
                                              chunk=size))
    got = ref.diag_scan_lanes_chunked_ref(
        *_lanes(a, True), *_lanes(x, True), *_lanes(h0, True), chunks=chunks)
    _assert_lanes(got, want, True, TOL[np.float64])


@pytest.mark.parametrize("chunks", [1, 7, T + 3])
@pytest.mark.parametrize("a_kind", KINDS)
def test_chunked_scan_float32_matches_jax_kernel(a_kind, chunks):
    a, x, h0 = _case(a_kind, True, True, np.float32)
    got = ref.diag_scan_lanes_chunked_ref(
        *_lanes(a, True), *_lanes(x, True), *_lanes(h0, True), chunks=chunks)
    _assert_lanes(got, _jax_forward(a_kind, True, True, np.float32), True,
                  TOL[np.float32])


@functools.lru_cache(maxsize=None)
def _jax_grads(a_kind, cplx, with_h0, dtype=np.float64):
    """The weights (w_re, w_im) of a real loss sum(re(h) w_re + im(h) w_im)
    and its gradients through the JAX kernel's VJP, conjugated: JAX returns
    the conjugate of PyTorch's convention for complex inputs (as
    ``test_diag_scan_grads_match_jax_vjp`` conjugates them)."""
    a, x, h0 = _case(a_kind, cplx, with_h0, dtype)
    rng = np.random.default_rng(5)
    w_re, w_im = (rng.normal(size=x.shape).astype(x.real.dtype)
                  for _ in range(2))
    inputs = [_j(v) for v in (a, x, h0) if v is not None]

    def loss(*args):
        h = jops.diag_scan(*args, **BLOCKS)
        return jnp.sum(h.real * w_re + h.imag * w_im)
    grads = jax.grad(loss, argnums=tuple(range(len(inputs))))(*inputs)
    return w_re, w_im, [np.conj(np.asarray(g)) for g in grads]


def _bwd_args(a_kind, cplx, with_h0, dtype=np.float64):
    """The backward's operands: a and h0 as given to the forward, the
    forward's output h (the JAX kernel's), the loss's gradient of h."""
    a, x, h0 = _case(a_kind, cplx, with_h0, dtype)
    h = _jax_forward(a_kind, cplx, with_h0, dtype)
    w_re, w_im, want = _jax_grads(a_kind, cplx, with_h0, dtype)
    g = (torch.tensor(w_re), torch.tensor(w_im) if cplx else None)
    return (*_lanes(a, cplx), *_lanes(h, cplx), *g, *_lanes(h0, cplx)), want


def _assert_grads(got, want, cplx, with_h0, tol):
    da_re, da_im, dx_re, dx_im, dh0_re, dh0_im = got
    pairs = [(da_re, da_im), (dx_re, dx_im)] + (
        [(dh0_re, dh0_im)] if with_h0 else [])
    assert len(pairs) == len(want)
    for (re, im), w in zip(pairs, want):
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(re.numpy(), w.real, rtol=0,
                                   atol=tol * scale)
        if cplx:
            np.testing.assert_allclose(im.numpy(), w.imag, rtol=0,
                                       atol=tol * scale)
        else:
            assert im is None
    if not with_h0:
        assert dh0_re is None and dh0_im is None


@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("with_h0", [False, True], ids=["no-h0", "h0"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("a_kind", KINDS)
def test_chunked_scan_bwd_matches_jax_vjp(a_kind, cplx, with_h0, chunks):
    args, want = _bwd_args(a_kind, cplx, with_h0)
    got = ref.diag_scan_lanes_bwd_chunked_ref(*args, chunks=chunks)
    _assert_grads(got, want, cplx, with_h0, TOL[np.float64])


@pytest.mark.parametrize("chunks", [1, 7, T + 3])
@pytest.mark.parametrize("a_kind", KINDS)
def test_chunked_scan_bwd_float32_matches_jax_vjp(a_kind, chunks):
    args, want = _bwd_args(a_kind, True, True, np.float32)
    got = ref.diag_scan_lanes_bwd_chunked_ref(*args, chunks=chunks)
    _assert_grads(got, want, True, True, TOL[np.float32])


@pytest.mark.parametrize("t,chunks,expect", [
    (37, 1, (1, 37)), (37, 2, (2, 19)), (37, 7, (7, 6)), (37, 37, (37, 1)),
    (37, 40, (37, 1)), (2000, 64, (63, 32)), (1024, 16, (16, 64)),
    (1, 8, (1, 1)), (0, 4, (0, 1))])
def test_chunk_layout(t, chunks, expect):
    n_chunks, size = ref.chunk_layout(t, chunks)
    assert (n_chunks, size) == expect
    assert n_chunks * size >= t and (n_chunks - 1) * size < max(t, 1)


def test_chunk_layout_rejects_no_chunks():
    with pytest.raises(ValueError, match="chunks must be >= 1"):
        ref.chunk_layout(10, 0)


@pytest.mark.parametrize("shape,expect", [
    ((8, 1024, 1024), 16),              # linear-esn training, complex64
    ((8, 1024, 525), 32),               # the serving wave, complex128
    ((1, 2000, 525), 64),               # the fit, complex128
    ((4, 1, 1024), 1),                  # linear-esn LM decode: T = 1
    ((256, 1024, 1024), 1),             # B x N alone fills the card
    ((1, 20, 525), 1),                  # too short to cut
], ids=["train", "wave", "fit", "lm-decode", "wide", "short"])
def test_scan_chunk_rule(shape, expect):
    b, t, n = shape
    c = scan_chunks(b, t, n)
    assert c == expect
    # A power of two, with chunks of at least SCAN_MIN_CHUNK steps, that
    # reaches the thread target unless doubling it would break that floor.
    assert c & (c - 1) == 0 and (c == 1 or t >= c * SCAN_MIN_CHUNK)
    assert (c * b * n >= SCAN_TARGET_THREADS
            or t < 2 * c * SCAN_MIN_CHUNK)


@pytest.mark.parametrize("mode", ["no_grad", "no-operand-requires-grad",
                                  "grad"])
def test_lanes_skip_autograd_without_grad_and_count(monkeypatch, mode):
    """Without grad mode or an operand that requires grad,
    ``ops.diag_scan_lanes`` runs the kernel without the autograd Function
    (no ``grad_fn``) and still counts the launch.  The card's route is
    stood in for by the plain version here (``_route`` says "cuda")."""
    monkeypatch.setattr(tops, "_route", lambda *args: "cuda")
    monkeypatch.setattr(tops, "diag_scan_lanes_cuda",
                        ref.diag_scan_lanes_ref)
    a, x, h0 = _case("static", True, True)
    args = [*_lanes(a, True), *_lanes(x, True), *_lanes(h0, True)]
    if mode == "grad":
        args[2].requires_grad_()
    before = tops.diag_scan.launches
    if mode == "no_grad":
        args[2].requires_grad_()
        with torch.no_grad():
            h_re, h_im = tops.diag_scan_lanes(*args)
    else:
        h_re, h_im = tops.diag_scan_lanes(*args)
    assert tops.diag_scan.launches == before + 1
    has_fn = h_re.grad_fn is not None and h_im.grad_fn is not None
    assert has_fn == (mode == "grad")
    want = ref.diag_scan_lanes_ref(*[v.detach() for v in args])
    torch.testing.assert_close(h_re.detach(), want[0], rtol=0, atol=0)
