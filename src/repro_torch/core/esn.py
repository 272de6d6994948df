"""Linear Echo State Networks — standard and diagonalized (the paper's §2/§4).

The model is a *param struct* (``core.params``) plus *pure functions over it*:

* Builders return immutable structs: ``standard_params(cfg)`` (dense W,
  O(N^2) step), ``diag_params(cfg)`` (eigendecomposed, O(N) step),
  ``dpg_params(cfg, distribution)`` (sampled directly — no W is built).
  Weights are generated on the host with numpy from ``cfg.seed`` exactly as
  the JAX package does, then placed on ``device`` (the GPU by default).
* ``run(params, u)`` collects states; ``fit(params, u, y)`` ridge-trains and
  returns a :class:`Readout`; ``predict(params, readout, u)`` and
  ``generate(params, readout, n_steps, ...)`` evaluate it.
* :class:`LinearESN` is a thin stateful facade over (params, readout,
  basis) for interactive use, as in the JAX package: ``.fit`` stores the
  readout on the instance.

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
    "generate",
    "LinearESN",
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


def _standard_struct(cfg: ESNConfig, w, w_in, w_fb, device) -> StandardParams:
    """The one leak-fold (Eq. 4) -> StandardParams construction."""
    lr = cfg.leak
    return StandardParams(
        w=_tensor(lr * w + (1.0 - lr) * np.eye(cfg.n), device),
        w_in=_tensor(lr * w_in, device),
        w_fb=None if w_fb is None else _tensor(lr * w_fb, device),
        cfg=cfg)


def standard_params(cfg: ESNConfig, *, device=None) -> StandardParams:
    """Dense-W params (the paper's baseline), leak folded in (Eq. 4)."""
    return _standard_struct(cfg, *_gen_weights(cfg), resolve_device(device))


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


def _diag_parts(cfg: ESNConfig):
    """Host-side (basis, w_raw, w_in_raw, w_fb_raw) for the eigendecomposed
    path — one copy shared by the pure builder and the facade."""
    w, w_in, w_fb = _gen_weights(cfg)
    return EigenBasis.from_matrix(w), w, w_in, w_fb


def diag_params(cfg: ESNConfig, *, device=None) -> DiagParams:
    """Generate a standard W, then diagonalize (EWT/EET path, paper §4.2-4.3)."""
    basis, _, w_in, w_fb = _diag_parts(cfg)
    return _diag_from_basis(cfg, basis, w_in, w_fb, resolve_device(device))


def _dpg_parts(cfg: ESNConfig, distribution: str, sigma: float):
    """Host-side (basis, w_in_raw, w_fb_raw) for the DPG path — one copy
    shared by the pure builder and the facade (incl. the seed+1 offset)."""
    spec, p = dpg_gen(cfg.n, cfg.spectral_radius, cfg.seed, distribution,
                      sigma=sigma, connectivity=cfg.connectivity)
    rng = np.random.default_rng(cfg.seed + 1)
    w_in = _gen_input_matrix(rng, cfg.d_in, cfg.n, cfg.input_scaling,
                             cfg.input_connectivity)
    w_fb = (_gen_input_matrix(rng, cfg.d_out, cfg.n, cfg.feedback_scaling, 1.0)
            if cfg.use_feedback else None)
    return EigenBasis.from_spectral(spec, p), w_in, w_fb


def dpg_params(cfg: ESNConfig, distribution: str = "noisy_golden",
               sigma: float = 0.2, *, device=None) -> DiagParams:
    """Direct Parameter Generation (paper §4.4) — no W is ever built."""
    basis, w_in, w_fb = _dpg_parts(cfg, distribution, sigma)
    return _diag_from_basis(cfg, basis, w_in, w_fb, resolve_device(device))


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
    (diag) or dense O(N^2) (standard).  A param batch (``lam_q`` (B, N) /
    ``w`` (B, N, N)) steps row b of ``states`` with reservoir b."""
    if params.mode == "diag":
        return scan_mod.realified_multiply(states, params.lam_q,
                                           params.n_real) + d
    if params.w.ndim == 3:
        return (states.unsqueeze(-2) @ params.w).squeeze(-2) + d
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


# ------------------------------------------------------------------ generate
def generate(params, readout: Readout, n_steps: int, u_warm, y_warm):
    """Closed-loop generation: feed the predicted y back as the next input
    (output-as-input autonomy, D_in == D_out).

    A teacher-forced warm-up scan, then a loop one step at a time (the JAX
    package's ``lax.scan``).  The loop is seeded with the teacher's last
    output for feedback models, with the last warm-up prediction otherwise.
    Returns (n_steps, D_out)."""
    cfg = params.cfg
    if cfg.d_in != cfg.d_out:
        raise ValueError("closed loop requires d_in == d_out")
    y_warm = _on(params, y_warm)
    states = run(params, u_warm,
                 y_teacher=y_warm if cfg.use_feedback else None)
    h = states[-1]
    w_out = readout.w_out.to(h.dtype)
    fb = cfg.use_feedback
    if fb:
        y = y_warm[-1].to(h.dtype)
    else:
        y = (assemble_features(params, states[-1:], None) @ w_out)[0]
    ys = []
    for _ in range(int(n_steps)):
        h = step_states(params, h, drive(params, y, y if fb else None))
        y = assemble_features(params, h[None], y[None] if fb else None)[0] \
            @ w_out
        ys.append(y)
    return torch.stack(ys) if ys else h.new_zeros((0, cfg.d_out))


# ------------------------------------------------------------------- facade
class LinearESN:
    """Thin facade over ``(params, readout, basis)`` for interactive use.

    Builders (``standard`` / ``diagonalized`` / ``dpg``) freeze the model
    into an immutable param struct on ``device`` (the GPU by default); the
    instance carries that struct, the trained :class:`Readout`, and the
    host-side basis and raw matrices for analysis (EWT transplants,
    Theorem 5).  ``.fit`` stores the readout on the instance, as the JAX
    package's facade does; the module-level functions are the pure API.
    """

    def __init__(self, cfg: ESNConfig, mode: str, params=None, readout=None,
                 basis: Optional[EigenBasis] = None, w_raw=None,
                 w_in_raw=None, w_fb_raw=None):
        self.cfg = cfg
        self.mode = mode
        self.params = params
        self.readout: Optional[Readout] = readout
        self.basis = basis
        self.w_raw = w_raw
        self.w_in_raw = w_in_raw
        self.w_fb_raw = w_fb_raw

    # ------------------------------------------------------------ builders
    @staticmethod
    def standard(cfg: ESNConfig, *, device=None) -> "LinearESN":
        w, w_in, w_fb = _gen_weights(cfg)
        return LinearESN(cfg, "standard",
                         params=_standard_struct(cfg, w, w_in, w_fb,
                                                 resolve_device(device)),
                         w_raw=w, w_in_raw=w_in, w_fb_raw=w_fb)

    @staticmethod
    def diagonalized(cfg: ESNConfig, *, device=None) -> "LinearESN":
        basis, w, w_in, w_fb = _diag_parts(cfg)
        return LinearESN(cfg, "diag",
                         params=_diag_from_basis(cfg, basis, w_in, w_fb,
                                                 resolve_device(device)),
                         basis=basis, w_raw=w, w_in_raw=w_in, w_fb_raw=w_fb)

    @staticmethod
    def dpg(cfg: ESNConfig, distribution: str = "noisy_golden",
            sigma: float = 0.2, *, device=None) -> "LinearESN":
        basis, w_in, w_fb = _dpg_parts(cfg, distribution, sigma)
        return LinearESN(cfg, "diag",
                         params=_diag_from_basis(cfg, basis, w_in, w_fb,
                                                 resolve_device(device)),
                         basis=basis, w_in_raw=w_in, w_fb_raw=w_fb)

    # ------------------------------------------- param-struct passthroughs
    @property
    def device(self) -> torch.device:
        return self.params.device

    @property
    def w(self):
        return self.params.w

    @property
    def w_in(self):
        return self.params.w_in

    @property
    def w_fb(self):
        return self.params.w_fb

    @property
    def lam_q(self):
        return self.params.lam_q

    @property
    def win_q(self):
        return self.params.win_q

    @property
    def wfb_q(self):
        return self.params.wfb_q

    @property
    def qtq(self):
        return self.params.qtq

    @property
    def n_real(self):
        return self.params.n_real

    @property
    def w_out(self):
        return None if self.readout is None else self.readout.w_out

    @w_out.setter
    def w_out(self, value):
        # Assigning w_out wraps it in a fresh immutable Readout on the
        # model's device.
        if value is not None and not isinstance(value, torch.Tensor):
            value = torch.tensor(np.asarray(value))
        self.readout = (None if value is None else
                        Readout(value.to(self.device)))

    # ------------------------------------------------------------- methods
    def ewt_from(self, trained_standard: "LinearESN") -> "LinearESN":
        """EWT (paper §4.2): transplant a trained standard readout into this
        diagonal model (must share the same underlying W/W_in)."""
        if self.mode != "diag" or trained_standard.readout is None:
            raise ValueError("ewt_from transplants a trained standard "
                             "readout into a diagonal model")
        ro = ewt_readout(self.basis, self.cfg, trained_standard.readout)
        self.readout = Readout(ro.w_out.to(self.device))
        return self

    def drive(self, u, y_prev=None):
        return drive(self.params, u, y_prev)

    def step_states(self, states, d):
        return step_states(self.params, states, d)

    def scan_states(self, d, h0=None, *, method: str = "auto",
                    chunk: int = 128):
        return scan_states(self.params, d, h0, method=method, chunk=chunk)

    def run(self, u, y_teacher=None, *, method: str = "auto",
            chunk: int = 128):
        return run(self.params, u, y_teacher, method=method, chunk=chunk)

    def assemble_features(self, states, y_prev=None):
        return assemble_features(self.params, states, y_prev)

    def features(self, states, y_teacher=None):
        return features(self.params, states, y_teacher)

    def _metric(self):
        return eet_metric(self.params)

    def fit(self, u, y, washout: int = 0, alpha: Optional[float] = None,
            method: str = "auto") -> "LinearESN":
        self.readout = fit(self.params, u, y, washout=washout, alpha=alpha,
                           method=method)
        return self

    def _readout(self) -> Readout:
        if self.readout is None:
            raise ValueError("fit() first: the model has no readout")
        return self.readout

    def predict(self, u, y_teacher=None, method: str = "auto"):
        return predict(self.params, self._readout(), u, y_teacher=y_teacher,
                       method=method)

    def generate(self, n_steps: int, u_warm, y_warm):
        """Closed-loop generation through the pure :func:`generate` with the
        current readout."""
        return generate(self.params, self._readout(), int(n_steps), u_warm,
                        y_warm)

    # ----------------------------------------------- Theorem 5 (W_in-free R)
    def collect_r_states(self, u, *, method: str = "sequential"):
        """R(t) per §3.3 (diag mode): states independent of W_in.
        Returns (T, D_in, N) in Q layout."""
        if self.mode != "diag":
            raise ValueError("collect_r_states needs a diagonal model")
        u = _on(self.params, u)
        nr, n = self.n_real, self.cfg.n
        # Input term in Q layout: u_d added to every real slot and to the Re
        # lane of every pair slot (a real scalar added to a complex
        # coordinate).
        mask = torch.zeros(n, dtype=u.dtype, device=u.device)
        mask[:nr] = 1.0
        mask[nr::2] = 1.0
        x = u[:, :, None] * mask
        # x is (T, D_in, N): time is axis 0 here (D_in is a batch axis).
        return scan_mod.diag_scan_q(self.lam_q, x, nr, method=method,
                                    time_axis=0)

    def states_from_r(self, r_states, w_in_raw=None):
        """Theorem 5: r(t) = sum_d row_d(W_in) (.) row_d(R(t)) — W_in applied
        *after* the recurrence.  ``w_in_raw`` (D_in, N) real, un-leaked."""
        w_in = self.cfg.leak * np.asarray(
            self.w_in_raw if w_in_raw is None else w_in_raw)
        # Each W_in row packs like a coefficient vector: [W_in]_P = W_in P,
        # whose Q packing is exactly W_in Q.
        win_q = _on(self.params, w_in @ self.basis.q())       # (D_in, N)
        return scan_mod.realified_multiply(r_states, win_q,
                                           self.n_real).sum(1)
