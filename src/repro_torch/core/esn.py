"""Linear Echo State Networks — standard and diagonalized (the paper's §2/§4).

The model is a *param struct* (``core.params``) plus *pure functions over it*:

* Builders return immutable structs: ``standard_params(cfg)`` (dense W,
  O(N^2) step), ``diag_params(cfg)`` (eigendecomposed, O(N) step),
  ``dpg_params(cfg, distribution)`` (sampled directly — no W is built).
  Weights are generated on the host with numpy from ``cfg.seed`` exactly as
  the JAX package does, then placed on ``device`` (the GPU by default).
* ``run(params, u)`` collects states; ``fit(params, u, y)`` ridge-trains and
  returns a :class:`Readout`; ``predict(params, readout, u)`` evaluates it.

The diagonal model runs in the real Q basis (Appendix A): states are real
vectors ``[real slots | (re, im) pairs]``, the recurrence is
``dispatch.run_scan_q`` and readout training uses the generalized ridge with
metric ``blockdiag(I, Q^T Q)`` (Eq. 29).

Row-vector convention throughout (as the paper): r (T, N), W_in (D_in, N),
W (N, N) acting on the right, W_out (N', D_out).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from . import dispatch as dispatch_mod
from . import ridge as ridge_mod
from . import scan as scan_mod
from .basis import EigenBasis
from .params import DiagParams, ESNConfig, Readout, StandardParams
from .spectral import dpg as dpg_gen, generate_reservoir_matrix

__all__ = [
    "ESNConfig",
    "standard_params",
    "diag_params",
    "dpg_params",
    "ewt_readout",
    "drive",
    "step_states",
    "scan_states",
    "run",
    "assemble_features",
    "features",
    "eet_metric",
    "fit",
    "predict",
]


# --------------------------------------------------------------------- build
def _gen_input_matrix(rng, d, n, scale, connectivity):
    w = rng.uniform(-1.0, 1.0, size=(d, n)) * scale
    if connectivity < 1.0:
        w *= rng.uniform(0.0, 1.0, size=(d, n)) < connectivity
    return w


def _gen_weights(cfg: ESNConfig):
    """Host-side raw (W, W_in, W_fb) generation shared by every builder."""
    rng = np.random.default_rng(cfg.seed)
    w = generate_reservoir_matrix(cfg.n, cfg.spectral_radius, rng,
                                  cfg.connectivity)
    w_in = _gen_input_matrix(rng, cfg.d_in, cfg.n, cfg.input_scaling,
                             cfg.input_connectivity)
    w_fb = (_gen_input_matrix(rng, cfg.d_out, cfg.n, cfg.feedback_scaling, 1.0)
            if cfg.use_feedback else None)
    return w, w_in, w_fb


def _tensor(v, device):
    return None if v is None else torch.as_tensor(v, device=device)


def standard_params(cfg: ESNConfig, *, device=None) -> StandardParams:
    """Dense-W params (the paper's baseline), leak folded in (Eq. 4)."""
    dev = resolve_device(device)
    w, w_in, w_fb = _gen_weights(cfg)
    lr = cfg.leak
    return StandardParams(
        w=_tensor(lr * w + (1.0 - lr) * np.eye(cfg.n), dev),
        w_in=_tensor(lr * w_in, dev),
        w_fb=None if w_fb is None else _tensor(lr * w_fb, dev),
        cfg=cfg)


def _diag_from_basis(cfg: ESNConfig, basis: EigenBasis, w_in_raw, w_fb_raw,
                     device) -> DiagParams:
    lr = cfg.leak
    # Leak acts in the eigendomain: eig(lr W + (1-lr) I) = lr L + (1-lr),
    # same eigenvectors — no re-decomposition needed.
    lam_real = lr * basis.spectrum.lam_real + (1.0 - lr)
    lam_cpx = lr * basis.spectrum.lam_cpx + (1.0 - lr)
    return DiagParams(
        lam_q=scan_mod.pack_lambda_q(lam_real, lam_cpx).to(device),
        win_q=_tensor(basis.win_to_q(lr * w_in_raw), device),
        wfb_q=(_tensor(basis.win_to_q(lr * w_fb_raw), device)
               if w_fb_raw is not None else None),
        qtq=_tensor(basis.qtq(), device),
        cfg=cfg, n_real=basis.n_real)


def diag_params(cfg: ESNConfig, *, device=None) -> DiagParams:
    """Generate a standard W, then diagonalize (EWT/EET path, paper §4.2-4.3)."""
    dev = resolve_device(device)
    w, w_in, w_fb = _gen_weights(cfg)
    return _diag_from_basis(cfg, EigenBasis.from_matrix(w), w_in, w_fb, dev)


def dpg_params(cfg: ESNConfig, distribution: str = "noisy_golden",
               sigma: float = 0.2, *, device=None) -> DiagParams:
    """Direct Parameter Generation (paper §4.4) — no W is ever built."""
    dev = resolve_device(device)
    spec, p = dpg_gen(cfg.n, cfg.spectral_radius, cfg.seed, distribution,
                      sigma=sigma, connectivity=cfg.connectivity)
    rng = np.random.default_rng(cfg.seed + 1)
    w_in = _gen_input_matrix(rng, cfg.d_in, cfg.n, cfg.input_scaling,
                             cfg.input_connectivity)
    w_fb = (_gen_input_matrix(rng, cfg.d_out, cfg.n, cfg.feedback_scaling, 1.0)
            if cfg.use_feedback else None)
    return _diag_from_basis(cfg, EigenBasis.from_spectral(spec, p), w_in,
                            w_fb, dev)


def ewt_readout(basis: EigenBasis, cfg: ESNConfig, trained: Readout) -> Readout:
    """EWT (paper §4.2): transplant a standard-trained readout into the Q
    basis (the models must share the same underlying W / W_in)."""
    w_out = trained.w_out.detach().cpu().numpy()
    n_extra = w_out.shape[0] - cfg.n
    res = basis.wout_res_to_q(w_out[n_extra:])  # Q^-1 W_out,res (real)
    return Readout(torch.as_tensor(np.concatenate([w_out[:n_extra], res], 0),
                                   device=trained.w_out.device))


# ----------------------------------------------------------------------- run
def _on(params, v):
    """``v`` as a tensor on the params' device, promoted with their dtype."""
    v = torch.as_tensor(v, device=params.device)
    return v.to(torch.promote_types(v.dtype, params.dtype))


def drive(params, u, y_prev=None):
    """Input drive into the recurrence: ``u @ W_in (+ y_prev @ W_fb)``, in
    the model's native basis."""
    if params.mode == "diag":
        d = u @ params.win_q.to(u.dtype)
        if params.cfg.use_feedback:
            d = d + y_prev @ params.wfb_q.to(y_prev.dtype)
    else:
        d = u @ params.w_in.to(u.dtype)
        if params.cfg.use_feedback:
            d = d + y_prev @ params.w_fb.to(y_prev.dtype)
    return d


def step_states(params, states, d):
    """One recurrence application in the native basis: O(N) element-wise
    (diag) or dense O(N^2) (standard)."""
    if params.mode == "diag":
        return scan_mod.realified_multiply(states, params.lam_q,
                                           params.n_real) + d
    return states @ params.w + d


def scan_states(params, d, h0=None, *, method: str = "auto",
                chunk: int = 128):
    """Run the recurrence over a precomputed drive (..., T, N) from state
    ``h0`` (native basis; zeros when None).  Time is axis -2; leading axes
    are batch."""
    if params.mode == "diag":
        return dispatch_mod.run_scan_q(params.lam_q, d, params.n_real, h0,
                                       method=method, chunk=chunk,
                                       time_axis=-2)
    r = (torch.zeros(d.shape[:-2] + (params.cfg.n,), dtype=d.dtype,
                     device=d.device) if h0 is None else h0)
    states = []
    for i in range(d.shape[-2]):
        r = step_states(params, r, d[..., i, :])
        states.append(r)
    return torch.stack(states, -2)


def _shift_teacher(cfg: ESNConfig, y_teacher):
    """Teacher outputs aligned as feedback: y_prev(t) = y(t-1), y_prev(0)=0."""
    return torch.cat([y_teacher.new_zeros((1, cfg.d_out)), y_teacher[:-1]])


def run(params, u, y_teacher=None, *, method: str = "auto", chunk: int = 128):
    """Collect reservoir states for input u (T, D_in).  Returns (T, N) — raw
    states (standard mode) or Q-basis states (diag mode)."""
    u = _on(params, u)
    cfg = params.cfg
    y_prev = None
    if cfg.use_feedback:
        if y_teacher is None:
            raise ValueError("feedback ESN needs teacher outputs to collect "
                             "states")
        y_prev = _shift_teacher(cfg, _on(params, y_teacher).to(u.dtype))
    return scan_states(params, drive(params, u, y_prev), method=method,
                       chunk=chunk)


def assemble_features(params, states, y_prev=None):
    """X = [1 | y_prev | r] from an already-aligned feedback column."""
    cfg = params.cfg
    cols = []
    if cfg.use_bias:
        cols.append(states.new_ones(states.shape[:-1] + (1,)))
    if cfg.use_feedback:
        cols.append(y_prev)
    cols.append(states)
    return torch.cat(cols, -1)


def features(params, states, y_teacher=None):
    """X(t) = [1 | y(t-1) | r(t)] (paper Eq. 7) from collected states."""
    y_prev = None
    if params.cfg.use_feedback:
        y_prev = _shift_teacher(params.cfg,
                                _on(params, y_teacher).to(states.dtype))
    return assemble_features(params, states, y_prev)


def eet_metric(params: DiagParams):
    """EET regularizer metric blockdiag(I, Q^T Q) (Eq. 29)."""
    cfg = params.cfg
    n_extra = cfg.n_features - cfg.n
    m = params.qtq.new_zeros((cfg.n_features, cfg.n_features))
    m[:n_extra, :n_extra] = torch.eye(n_extra, dtype=m.dtype, device=m.device)
    m[n_extra:, n_extra:] = params.qtq
    return m


# ----------------------------------------------------------------------- fit
def fit(params, u, y, washout: int = 0, alpha: Optional[float] = None,
        method: str = "auto") -> Readout:
    """Ridge-train a readout; returns a fresh immutable :class:`Readout`.
    Standard mode: Eq. 9.  Diag mode: EET (Eq. 29, generalized metric)."""
    y = _on(params, y)
    alpha = params.cfg.ridge_alpha if alpha is None else alpha
    states = run(params, u, y_teacher=y if params.cfg.use_feedback else None,
                 method=method)
    x = features(params, states, y_teacher=y)[washout:]
    g, c = ridge_mod.gram(x, y[washout:].to(x.dtype))
    if params.mode == "standard":
        return Readout(ridge_mod.ridge_solve(g, c, alpha))
    return Readout(ridge_mod.ridge_solve_general(g, c, eet_metric(params),
                                                 alpha))


def predict(params, readout: Readout, u, y_teacher=None, method: str = "auto"):
    """Readout predictions over a teacher-forced run: X @ W_out."""
    states = run(params, u, y_teacher=y_teacher, method=method)
    x = features(params, states, y_teacher=y_teacher)
    return x @ readout.w_out.to(x.dtype)
