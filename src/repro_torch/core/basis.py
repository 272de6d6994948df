"""Change-of-basis machinery (paper Theorem 1, Corollary 2, Appendix A).

Row-vector convention as in the paper: states are row vectors, matrices act on the
right — ``r(t) = r(t-1) W + u(t) W_in``.  Transformations into a basis P:

    [W]_P    = P^-1 W P          (diagonal = diag(Lambda) when P eigenbasis)
    [r]_P    = r P
    [W_in]_P = W_in P
    [W_out,res]_P = P^-1 W_out,res

Appendix A real representation ("memory view trick"): with the canonical spectrum
layout (reals, cpx, conj(cpx)) define

    Q = [u_1..u_nr, Re v_1, Im v_1, ..., Re v_ni, Im v_ni]   (real, invertible)

In the Q basis the state is real; a Q-basis state vector's layout is
``[real-eigen slots (n_r) | (re, im) interleaved pairs (2 n_i)]`` and the recurrence
is an element-wise complex multiply applied on the *paired view*.  Kernels keep the
"view" as two real lanes and the complex multiply as an explicit 2x2 rotation
(see ``core.scan.realified_multiply``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .spectral import Spectrum

__all__ = ["EigenBasis", "from_dpg"]


def _pair_eigensystem(lam: np.ndarray, vec: np.ndarray, tol: float = 1e-8):
    """Reorder an arbitrary (eigvals, eigvecs) into the canonical paired layout."""
    scale = max(float(np.max(np.abs(lam))), 1.0)
    is_real = np.abs(lam.imag) <= tol * scale
    idx_real = np.flatnonzero(is_real)
    idx_up = np.flatnonzero(~is_real & (lam.imag > 0))
    idx_dn = np.flatnonzero(~is_real & (lam.imag < 0))
    # Match each upper eigenvalue with its conjugate partner.
    used = np.zeros(len(idx_dn), dtype=bool)
    order_dn = []
    lam_dn = lam[idx_dn]
    for i in idx_up:
        d = np.abs(lam_dn - np.conj(lam[i]))
        d = np.where(used, np.inf, d)
        j = int(np.argmin(d))
        used[j] = True
        order_dn.append(idx_dn[j])
    order = np.concatenate(
        [idx_real, idx_up, np.asarray(order_dn, dtype=int)]
        if len(idx_up)
        else [idx_real]
    ).astype(int)
    lam_o = lam[order]
    vec_o = vec[:, order]
    n_real = len(idx_real)
    n_cpx = len(idx_up)
    # Force exactness of the real/conjugate structure (numpy eig gives conjugate
    # pairs only up to roundoff; exact pairing keeps W = P D P^-1 exactly real).
    lam_real = lam_o[:n_real].real
    lam_cpx = lam_o[n_real : n_real + n_cpx]
    vec_o[:, :n_real] = vec_o[:, :n_real].real
    vec_o[:, n_real + n_cpx :] = np.conj(vec_o[:, n_real : n_real + n_cpx])
    return Spectrum(lam_real, lam_cpx), vec_o


@dataclasses.dataclass(frozen=True)
class EigenBasis:
    """Eigen-decomposition of a (possibly implicit) real reservoir matrix.

    Holds both the complex P-basis and the real Q-basis (Appendix A).
    """

    spectrum: Spectrum
    p: np.ndarray          # (N, N) complex128, canonical column layout
    p_inv: np.ndarray      # (N, N) complex128

    # ---- construction -----------------------------------------------------
    @staticmethod
    def from_matrix(w: np.ndarray, tol: float = 1e-8) -> "EigenBasis":
        lam, vec = np.linalg.eig(w)
        spec, p = _pair_eigensystem(lam, vec, tol)
        return EigenBasis(spec, p, np.linalg.inv(p))

    @staticmethod
    def from_spectral(spec: Spectrum, p: np.ndarray) -> "EigenBasis":
        return EigenBasis(spec, p, np.linalg.inv(p))

    # ---- basic properties --------------------------------------------------
    @property
    def n(self) -> int:
        return self.spectrum.n

    @property
    def n_real(self) -> int:
        return self.spectrum.n_real

    @property
    def n_cpx(self) -> int:
        return self.spectrum.n_cpx

    def lam_full(self) -> np.ndarray:
        return self.spectrum.full()

    def reconstruct_w(self) -> np.ndarray:
        """W = P diag(Lambda) P^-1 — real up to roundoff by construction."""
        w = (self.p * self.lam_full()[None, :]) @ self.p_inv
        return w.real

    # ---- P-basis transforms (Theorem 1) -------------------------------------
    def win_to_p(self, w_in: np.ndarray) -> np.ndarray:
        """[W_in]_P = W_in P   (D_in, N) -> complex (D_in, N)."""
        return w_in @ self.p

    def state_to_p(self, r: np.ndarray) -> np.ndarray:
        """[r]_P = r P, r has trailing dim N."""
        return r @ self.p

    def state_from_p(self, r_p: np.ndarray) -> np.ndarray:
        return (r_p @ self.p_inv).real

    def wout_res_to_p(self, w_out_res: np.ndarray) -> np.ndarray:
        """EWT on the reservoir block of the readout: P^-1 W_out,res."""
        return self.p_inv @ w_out_res

    # ---- Q-basis (Appendix A) ------------------------------------------------
    def q(self) -> np.ndarray:
        """Real basis Q = [reals | Re v_k, Im v_k interleaved]. (N, N) float64."""
        n, nr, ni = self.n, self.n_real, self.n_cpx
        q = np.zeros((n, n), dtype=np.float64)
        q[:, :nr] = self.p[:, :nr].real
        v = self.p[:, nr : nr + ni]
        q[:, nr : nr + 2 * ni : 2] = v.real
        q[:, nr + 1 : nr + 2 * ni : 2] = v.imag
        return q

    def q_inv(self) -> np.ndarray:
        """Q^-1 computed from P^-1 analytically: Q = P Z, Z = blockdiag(I, Z2...),
        Z2 = 0.5 [[1, 1], [-i, i]]  =>  Q^-1 = Z^-1 P^-1 with
        Z2^-1 = [[1, i], [1, -i]].  Rows of Q^-1: real rows stay; pair rows are
        (row_up + row_dn, i(row_up - row_dn)) = (2 Re row_up, -2 Im row_up)."""
        nr, ni = self.n_real, self.n_cpx
        qi = np.zeros((self.n, self.n), dtype=np.float64)
        qi[:nr] = self.p_inv[:nr].real
        up = self.p_inv[nr : nr + ni]
        qi[nr : nr + 2 * ni : 2] = 2.0 * up.real
        qi[nr + 1 : nr + 2 * ni : 2] = -2.0 * up.imag
        return qi

    def win_to_q(self, w_in: np.ndarray) -> np.ndarray:
        """[W_in]_Q = W_in Q — real (D_in, N)."""
        return w_in @ self.q()

    def state_to_q(self, r: np.ndarray) -> np.ndarray:
        return r @ self.q()

    def state_from_q(self, r_q: np.ndarray) -> np.ndarray:
        return r_q @ self.q_inv()

    def wout_res_to_q(self, w_out_res: np.ndarray) -> np.ndarray:
        """EWT into the Q basis: Q^-1 W_out,res — real."""
        return self.q_inv() @ w_out_res

    def p_state_to_q(self, r_p: np.ndarray) -> np.ndarray:
        """[r]_Q from [r]_P: reals pass through; pairs -> (Re, Im) slots.

        ([r]_Q = [r]_P Z with Z = blockdiag(I, [[.5, .5],[-.5i, .5i]]) per pair,
        i.e. slots (Re z, Im z) for the upper representative z.)
        """
        nr, ni = self.n_real, self.n_cpx
        out_shape = r_p.shape[:-1] + (self.n,)
        out = np.zeros(out_shape, dtype=np.float64)
        out[..., :nr] = r_p[..., :nr].real
        z = r_p[..., nr : nr + ni]
        out[..., nr : nr + 2 * ni : 2] = z.real
        out[..., nr + 1 : nr + 2 * ni : 2] = z.imag
        return out

    # ---- regularizer metrics (EET, Eq. 14 / Eq. 29) ---------------------------
    def ptp(self) -> np.ndarray:
        """P^T P (plain transpose, as in Eq. 14) — complex (N, N)."""
        return self.p.T @ self.p

    def qtq(self) -> np.ndarray:
        """Q^T Q — real SPD (N, N), the EET regularizer metric in the Q basis."""
        q = self.q()
        return q.T @ q


def from_dpg(spec: Spectrum, p: np.ndarray) -> EigenBasis:
    """Build an EigenBasis from DPG-sampled (Spectrum, P)."""
    return EigenBasis.from_spectral(spec, p)
