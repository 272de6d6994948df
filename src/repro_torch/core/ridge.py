"""Ridge regression solvers for readout training (paper Eq. 9 / 14 / 29).

Standard ESN readout:      W_out = (X^T X + alpha I)^-1 X^T Y
EET (eigenbasis) readout:  [W_out]_B = ([X]_B^T [X]_B + alpha M)^-1 [X]_B^T Y
with the metric M = blockdiag(I, B^T B) for basis B (P complex or Q real).
Both are expressed over the sufficient statistics ``G = X^T X`` and
``C = X^T Y``.
"""
from __future__ import annotations

import torch

__all__ = ["gram", "ridge_solve", "ridge_solve_general"]


def gram(x, y):
    """(G, C) = (X^T X, X^T Y).  x: (T, N'), y: (T, D_out).  Complex-safe
    (plain transpose, as the paper's Eq. 14 — NOT conjugate transpose)."""
    xt = x.transpose(-1, -2)
    return xt @ x, xt @ y


def _spd_solve(a, c):
    """Cholesky for a real SPD system, LU for complex."""
    if a.is_complex():
        return torch.linalg.solve(a, c)
    return torch.cholesky_solve(c, torch.linalg.cholesky(a))


def ridge_solve(g, c, alpha: float):
    """W = (G + alpha I)^-1 C."""
    eye = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    return _spd_solve(g + alpha * eye, c)


def ridge_solve_general(g, c, m, alpha: float):
    """W = (G + alpha M)^-1 C for SPD metric M (EET regularizer, Eq. 14/29)."""
    return _spd_solve(g + alpha * m, c)
