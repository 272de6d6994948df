"""Ridge regression solvers for readout training (paper Eq. 9 / 14 / 29).

Standard ESN readout:      W_out = (X^T X + alpha I)^-1 X^T Y
EET (eigenbasis) readout:  [W_out]_B = ([X]_B^T [X]_B + alpha M)^-1 [X]_B^T Y
with the metric M = blockdiag(I, B^T B) for basis B (P complex or Q real).
Both are expressed over the sufficient statistics ``G = X^T X`` and
``C = X^T Y``, which :func:`gram_streaming` accumulates over time chunks.
Multi-alpha solving (the paper's grid searches sweep 12 alphas) takes one
eigendecomposition of G (generalized to the metric M by Cholesky
whitening), after which every alpha costs two small matmuls.
"""
from __future__ import annotations

import torch

__all__ = ["gram", "gram_streaming", "ridge_solve", "ridge_solve_multi",
           "ridge_solve_general", "ridge_solve_general_multi"]


def gram(x, y):
    """(G, C) = (X^T X, X^T Y).  x: (T, N'), y: (T, D_out).  Complex-safe
    (plain transpose, as the paper's Eq. 14 — NOT conjugate transpose)."""
    xt = x.transpose(-1, -2)
    return xt @ x, xt @ y


def gram_streaming(x, y, chunk: int = 4096):
    """(G, C) accumulated over time chunks of ``chunk`` rows, so the peak
    memory is O(chunk * N') — the shape a sharded data pipeline feeds."""
    t, n, d = x.shape[0], x.shape[1], y.shape[1]
    dtype = torch.promote_types(x.dtype, y.dtype)
    g = x.new_zeros((n, n), dtype=dtype)
    c = x.new_zeros((n, d), dtype=dtype)
    for lo in range(0, t, chunk):
        xi, yi = x[lo:lo + chunk], y[lo:lo + chunk]
        g = g + xi.T @ xi
        c = c + xi.T @ yi
    return g, c


def _spd_solve(a, c):
    """Cholesky for a real SPD system, LU for complex."""
    if a.is_complex():
        return torch.linalg.solve(a, c)
    return torch.cholesky_solve(c, torch.linalg.cholesky(a))


def ridge_solve(g, c, alpha: float):
    """W = (G + alpha I)^-1 C."""
    eye = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    return _spd_solve(g + alpha * eye, c)


def _solve_alphas(u, uc, s, alphas):
    """``u diag(1 / (s + alpha)) uc`` for every alpha: (A, N', D)."""
    alphas = torch.as_tensor(alphas, dtype=s.dtype, device=s.device)
    scaled = uc[None] / (s[None, :, None] + alphas[:, None, None])
    return torch.einsum("ij,ajd->aid", u, scaled)


def ridge_solve_multi(g, c, alphas):
    """Solve for every alpha with ONE eigh of G: G = U diag(s) U^T, so
    W(alpha) = U diag(1 / (s + alpha)) U^T C.  Returns (n_alphas, N', D)."""
    s, u = torch.linalg.eigh(g)
    return _solve_alphas(u, u.T @ c, s, alphas)


def ridge_solve_general(g, c, m, alpha: float):
    """W = (G + alpha M)^-1 C for SPD metric M (EET regularizer, Eq. 14/29)."""
    return _spd_solve(g + alpha * m, c)


def ridge_solve_general_multi(g, c, m, alphas):
    """Multi-alpha generalized ridge via Cholesky whitening of the metric:
    M = L L^T, so (G + alpha M)^-1 = L^-T (G' + alpha I)^-1 L^-1 with
    G' = L^-1 G L^-T, and one eigh of G' serves every alpha.  Real only
    (the Q basis keeps training real).  Returns (n_alphas, N', D)."""
    l = torch.linalg.cholesky(m)
    gl = torch.linalg.solve_triangular(l, g, upper=False)
    gp = torch.linalg.solve_triangular(l, gl.T, upper=False).T
    gp = 0.5 * (gp + gp.T)
    cl = torch.linalg.solve_triangular(l, c, upper=False)
    s, u = torch.linalg.eigh(gp)
    w_white = _solve_alphas(u, u.T @ cl, s, alphas)
    return torch.linalg.solve_triangular(l.T, w_white, upper=True)
