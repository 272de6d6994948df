"""Port parity: every scan method against ``repro.core.scan``.

Same numpy inputs through both packages.  The port's associative scan uses
a different (doubling) tree than ``lax.associative_scan`` and its chunked
powers come from ``torch.pow``, so sums differ in the last bits: float64
tolerance 1e-12 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scan as jscan
from repro_torch.core import scan as tscan

METHODS = ["sequential", "associative", "chunked"]
TOL = dict(rtol=1e-12, atol=1e-12)


def _coeffs(rng, shape, dtype):
    if dtype == np.complex128:
        mag = rng.uniform(0.3, 0.98, size=shape)
        return mag * np.exp(1j * rng.uniform(0, np.pi, size=shape))
    return rng.uniform(-0.98, 0.98, size=shape)


def _data(rng, shape, dtype):
    x = rng.normal(size=shape)
    if dtype == np.complex128:
        x = x + 1j * rng.normal(size=shape)
    return x


def _both(fn_j, fn_t, *arrays, **kw):
    j = fn_j(*[None if a is None else jnp.asarray(a) for a in arrays], **kw)
    t = fn_t(*[None if a is None else torch.as_tensor(a) for a in arrays],
             **kw)
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("shape", [(17, 8), (3, 33, 5), (2, 300, 16)])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_matches_jax(method, dtype, shape, reverse):
    rng = np.random.default_rng(0)
    a = _coeffs(rng, shape[-1:], dtype)
    x = _data(rng, shape, dtype)
    h0 = _data(rng, shape[:-2] + shape[-1:], dtype)
    j, t = _both(jscan.diag_scan, tscan.diag_scan, a, x, h0, method=method,
                 chunk=32, reverse=reverse)
    np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("a_shape", ["time", "full"])
def test_scan_per_timestep_coefficients(method, a_shape):
    rng = np.random.default_rng(1)
    x = _data(rng, (3, 70, 6), np.complex128)
    a = _coeffs(rng, (70, 6) if a_shape == "time" else (3, 70, 6),
                np.complex128)
    for reverse in (False, True):
        j, t = _both(jscan.diag_scan, tscan.diag_scan, a, x, method=method,
                     chunk=16, reverse=reverse)
        np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("method", METHODS)
def test_scan_time_axis(method):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(45, 3, 7))               # time on axis 0
    a = rng.uniform(-0.9, 0.9, size=7)
    j, t = _both(jscan.diag_scan, tscan.diag_scan, a, x, method=method,
                 chunk=8, time_axis=0)
    np.testing.assert_allclose(t, j, **TOL)


def test_q_layout_helpers_match():
    rng = np.random.default_rng(3)
    nr, npairs = 5, 6
    lam_r = rng.uniform(-0.9, 0.9, nr)
    lam_c = 0.8 * np.exp(1j * rng.uniform(0, np.pi, npairs))
    lq_j = jscan.pack_lambda_q(jnp.asarray(lam_r), jnp.asarray(lam_c))
    lq_t = tscan.pack_lambda_q(lam_r, lam_c)
    np.testing.assert_array_equal(lq_t.numpy(), np.asarray(lq_j))
    h = rng.normal(size=(4, nr + 2 * npairs))
    np.testing.assert_array_equal(
        tscan.realified_multiply(torch.as_tensor(h), lq_t, nr).numpy(),
        np.asarray(jscan.realified_multiply(jnp.asarray(h), lq_j, nr)))
    vr_t, vc_t = tscan.q_split(torch.as_tensor(h), nr)
    vr_j, vc_j = jscan.q_split(jnp.asarray(h), nr)
    np.testing.assert_array_equal(vc_t.numpy(), np.asarray(vc_j))
    np.testing.assert_array_equal(
        tscan.q_merge(vr_t, vc_t, torch.float64).numpy(), h)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("with_h0", [False, True])
def test_diag_scan_q_matches_jax(method, with_h0):
    rng = np.random.default_rng(4)
    nr, npairs, t = 3, 7, 150
    n = nr + 2 * npairs
    lam_r = rng.uniform(-0.95, 0.95, nr)
    lam_c = rng.uniform(0.5, 0.95, npairs) * np.exp(
        1j * rng.uniform(0, np.pi, npairs))
    lq = np.array(jscan.pack_lambda_q(jnp.asarray(lam_r),
                                      jnp.asarray(lam_c)))
    x = rng.normal(size=(2, t, n))
    h0 = rng.normal(size=(2, n)) if with_h0 else None
    j = jscan.diag_scan_q(jnp.asarray(lq), jnp.asarray(x), nr,
                          None if h0 is None else jnp.asarray(h0),
                          method=method, chunk=32)
    tt = tscan.diag_scan_q(torch.as_tensor(lq), torch.as_tensor(x), nr,
                           None if h0 is None else torch.as_tensor(h0),
                           method=method, chunk=32)
    np.testing.assert_allclose(tt.numpy(), np.asarray(j), **TOL)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown scan method"):
        tscan.diag_scan(torch.ones(2), torch.ones(3, 2), method="pallas")
