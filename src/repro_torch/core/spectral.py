"""Spectral parameter generation for Direct Parameter Generation (DPG).

Implements the paper's Algorithms 1-3 plus the "Sim" distribution:

* Algorithm 1  ``uniform_eigenvalues``   — N_real ~ sqrt(2N/pi) real eigenvalues
  uniform on (-sr, sr); complex pairs with radius sr*sqrt(U) (uniform on the disk)
  and angle uniform on [0, pi).
* Algorithm 2  ``random_eigenvectors``   — unit gaussian eigenvectors; complex
  conjugate pairs share a conjugated vector so that W = P diag(L) P^-1 is real.
* Algorithm 3  ``golden_eigenvalues``    — deterministic phyllotaxis spiral via the
  golden angle (3 - sqrt(5)), radius sqrt(k / (2 n_cpx)) for constant areal density,
  optional complex gaussian noise (``sigma``) => "Noisy Golden".
* ``sim_eigenvalues``                    — eigenvalues extracted from an actual
  random reservoir matrix W (the paper's "Sim Dist."), used with random eigenvectors.

Everything here is one-time host-side preprocessing (the paper's "Generation step"),
so plain numpy with an explicit ``np.random.Generator`` is used; outputs are float64 /
complex128 numpy arrays which callers cast as needed.

Canonical spectrum layout used throughout the codebase (matches Algorithms 1-2):

    Lambda = concat(L_real (n_r,), L_cpx (n_i,), conj(L_cpx) (n_i,))
    P      = [real eigenvectors | complex eigenvectors | their conjugates]
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "Spectrum",
    "n_real_expected",
    "uniform_eigenvalues",
    "golden_eigenvalues",
    "sim_eigenvalues",
    "random_eigenvectors",
    "generate_reservoir_matrix",
    "dpg",
]


@dataclasses.dataclass(frozen=True)
class Spectrum:
    """Canonical (reals, upper complex) representation of a real-matrix spectrum."""

    lam_real: np.ndarray  # (n_r,) float64
    lam_cpx: np.ndarray   # (n_i,) complex128, Im > 0 representatives

    @property
    def n_real(self) -> int:
        return int(self.lam_real.shape[0])

    @property
    def n_cpx(self) -> int:
        return int(self.lam_cpx.shape[0])

    @property
    def n(self) -> int:
        return self.n_real + 2 * self.n_cpx

    def full(self) -> np.ndarray:
        """(N,) complex128 in canonical layout (reals, cpx, conj(cpx))."""
        return np.concatenate(
            [self.lam_real.astype(np.complex128), self.lam_cpx, np.conj(self.lam_cpx)]
        )

    def spectral_radius(self) -> float:
        cands = [0.0]
        if self.n_real:
            cands.append(float(np.max(np.abs(self.lam_real))))
        if self.n_cpx:
            cands.append(float(np.max(np.abs(self.lam_cpx))))
        return max(cands)


def n_real_expected(n: int) -> int:
    """Expected number of real eigenvalues of an NxN iid gaussian matrix.

    E[N_real] ~ sqrt(2N/pi)  (Edelman & Kostlan, 1995); parity-corrected so that
    N - N_real is even (complex eigenvalues must pair up for a real matrix).
    """
    n_real = int(math.ceil(math.sqrt(2.0 * n / math.pi)))
    if n_real > n:
        n_real = n
    if (n - n_real) % 2 != 0:
        n_real += 1 if n_real < n else -1
    return n_real


def uniform_eigenvalues(n: int, sr: float, rng: np.random.Generator) -> Spectrum:
    """Algorithm 1 — random spectrum with uniform-on-disk complex pairs."""
    n_real = n_real_expected(n)
    n_cpx = (n - n_real) // 2
    lam_real = rng.uniform(-sr, sr, size=n_real)
    u = rng.uniform(0.0, 1.0, size=n_cpx)
    theta = rng.uniform(0.0, math.pi, size=n_cpx)
    lam_cpx = sr * np.sqrt(u) * np.exp(1j * theta)
    return Spectrum(lam_real, lam_cpx)


def golden_eigenvalues(
    n: int,
    sr: float,
    rng: np.random.Generator,
    sigma: float = 0.0,
) -> Spectrum:
    """Algorithm 3 — deterministic golden-angle phyllotaxis spiral spectrum.

    The golden-angle walk ``v_k = (v_0 + k (3 - sqrt(5))) mod 2`` visits [0, 2);
    only points with v < 1 (upper half-plane angles pi*v in [0, pi)) are accepted.
    Radius grows as sqrt(k / (2 n_cpx)) so accepted points tile the half-disk with
    constant density.  The whole spectrum is then rescaled to spectral radius ``sr``
    and, if ``sigma > 0``, complex gaussian noise is added to the complex pairs
    ("Noisy Golden", paper uses sigma = 0.2).
    """
    n_real = n_real_expected(n)
    n_cpx = (n - n_real) // 2
    lam_real = rng.uniform(-1.0, 1.0, size=n_real)

    if n_cpx > 0:
        v0 = rng.uniform(0.0, 2.0)
        step = 3.0 - math.sqrt(5.0)
        # Acceptance rate is 1/2 on average; over-generate deterministically.
        budget = 4 * n_cpx + 64
        while True:
            k = np.arange(1, budget + 1, dtype=np.float64)
            v = (v0 + k * step) % 2.0
            accept = v < 1.0
            if int(accept.sum()) >= n_cpx:
                break
            budget *= 2
        k_acc = k[accept][:n_cpx]
        v_acc = v[accept][:n_cpx]
        lam_cpx = np.sqrt(k_acc / (2.0 * n_cpx)) * np.exp(1j * math.pi * v_acc)
    else:
        lam_cpx = np.zeros((0,), dtype=np.complex128)

    # Rescale the whole spectrum to the requested spectral radius.
    m = max(
        float(np.max(np.abs(lam_real))) if n_real else 0.0,
        float(np.max(np.abs(lam_cpx))) if n_cpx else 0.0,
    )
    if m > 0:
        scale = sr / m
        lam_real = lam_real * scale
        lam_cpx = lam_cpx * scale

    if sigma > 0.0 and n_cpx > 0:
        noise = rng.normal(0.0, sigma, size=n_cpx) + 1j * rng.normal(
            0.0, sigma, size=n_cpx
        )
        lam_cpx = lam_cpx + noise
        # Keep representatives in the upper half-plane (conjugate symmetry of the
        # full spectrum is preserved either way; this is just canonicalization).
        flip = lam_cpx.imag < 0
        lam_cpx = np.where(flip, np.conj(lam_cpx), lam_cpx)

    return Spectrum(lam_real, lam_cpx)


def generate_reservoir_matrix(
    n: int,
    sr: float,
    rng: np.random.Generator,
    connectivity: float = 1.0,
    distribution: str = "normal",
) -> np.ndarray:
    """Standard ESN reservoir matrix: sparse-random entries rescaled to radius sr.

    Dense storage with a Bernoulli(connectivity) mask — sparsity only affects the
    *generation distribution*, which is all the paper's experiments rely on.
    """
    if distribution == "normal":
        w = rng.normal(0.0, 1.0, size=(n, n))
    elif distribution == "uniform":
        w = rng.uniform(-1.0, 1.0, size=(n, n))
    else:  # pragma: no cover - config validation
        raise ValueError(f"unknown distribution {distribution!r}")
    if connectivity < 1.0:
        w *= rng.uniform(0.0, 1.0, size=(n, n)) < connectivity
    eig = np.linalg.eigvals(w)
    radius = float(np.max(np.abs(eig))) if n else 0.0
    if radius > 0:
        w *= sr / radius
    return w


def sim_eigenvalues(
    n: int,
    sr: float,
    rng: np.random.Generator,
    connectivity: float = 1.0,
) -> Spectrum:
    """"Sim" distribution — true eigenvalues of an actual random reservoir W."""
    w = generate_reservoir_matrix(n, sr, rng, connectivity)
    lam = np.linalg.eigvals(w)
    return canonicalize_spectrum(lam)


def canonicalize_spectrum(lam: np.ndarray, tol: float = 1e-9) -> Spectrum:
    """Sort an eigenvalue list into the canonical (reals, upper-cpx) layout."""
    scale = max(float(np.max(np.abs(lam))), 1.0) if lam.size else 1.0
    is_real = np.abs(lam.imag) <= tol * scale
    lam_real = np.sort(lam[is_real].real)
    upper = lam[~is_real & (lam.imag > 0)]
    # Stable order for reproducibility.
    order = np.lexsort((upper.imag, upper.real))
    return Spectrum(lam_real.astype(np.float64), upper[order])


def random_eigenvectors(n: int, n_real: int, rng: np.random.Generator) -> np.ndarray:
    """Algorithm 2 — random unit eigenvectors with conjugate-pair structure.

    Column layout matches the canonical spectrum: [reals | cpx | conj(cpx)].
    """
    n_cpx = (n - n_real) // 2
    assert n_real + 2 * n_cpx == n, "n - n_real must be even"
    p = np.zeros((n, n), dtype=np.complex128)
    for i in range(n_real):
        v = rng.normal(0.0, 1.0, size=n)
        p[:, i] = v / np.linalg.norm(v)
    for k in range(n_cpx):
        vr = rng.normal(0.0, 1.0, size=n)
        vi = rng.normal(0.0, 1.0, size=n)
        v = vr + 1j * vi
        v = v / np.linalg.norm(v)
        p[:, n_real + k] = v
        p[:, n_real + n_cpx + k] = np.conj(v)
    return p


def dpg(
    n: int,
    sr: float,
    seed: int,
    distribution: str = "noisy_golden",
    sigma: float = 0.2,
    connectivity: float = 1.0,
):
    """Direct Parameter Generation: (Spectrum, P) without ever building W.

    distribution in {"uniform", "golden", "noisy_golden", "sim"}.
    """
    rng = np.random.default_rng(seed)
    if distribution == "uniform":
        spec = uniform_eigenvalues(n, sr, rng)
    elif distribution == "golden":
        spec = golden_eigenvalues(n, sr, rng, sigma=0.0)
    elif distribution == "noisy_golden":
        spec = golden_eigenvalues(n, sr, rng, sigma=sigma)
    elif distribution == "sim":
        spec = sim_eigenvalues(n, sr, rng, connectivity)
    else:  # pragma: no cover - config validation
        raise ValueError(f"unknown DPG distribution {distribution!r}")
    p = random_eigenvectors(n, spec.n_real, rng)
    return spec, p
