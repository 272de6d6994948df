"""Immutable reservoir parameter structs holding torch tensors.

A linear ESN is fully described by a small bundle of arrays:

* ``StandardParams`` — dense ``(W, W_in, W_fb)``: the O(N^2) baseline.
* ``DiagParams``     — the diagonalized model in the real Q basis (Appendix A):
  packed eigenvalues ``lam_q``, Q-transformed input/feedback maps, and the EET
  regularizer metric ``Q^T Q``.
* ``Readout``        — the trained readout ``W_out``, kept separate from the
  reservoir so (re)fitting never touches the recurrence parameters.

``cfg`` (an :class:`ESNConfig`) and the ``n_real`` layout split are plain
static fields.  All structs are frozen: evolve them with
``dataclasses.replace``.  :func:`params_from_numpy` / :func:`readout_from_numpy`
carry weights over from the JAX package's structs (their leaves as numpy
arrays), so both packages can be run on the same model.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from .. import resolve_device

__all__ = [
    "ESNConfig",
    "Readout",
    "StandardParams",
    "DiagParams",
    "stack_params",
    "params_to",
    "params_from_numpy",
    "readout_from_numpy",
]


@dataclasses.dataclass(frozen=True)
class ESNConfig:
    """Hyperparameters of a linear ESN."""
    n: int
    d_in: int = 1
    d_out: int = 1
    spectral_radius: float = 0.9
    leak: float = 1.0
    input_scaling: float = 1.0
    connectivity: float = 1.0
    input_connectivity: float = 1.0
    use_bias: bool = True
    use_feedback: bool = False
    feedback_scaling: float = 1.0
    ridge_alpha: float = 1e-8
    seed: int = 0

    @property
    def n_features(self) -> int:
        return self.n + int(self.use_bias) + (self.d_out if self.use_feedback else 0)


@dataclasses.dataclass(frozen=True)
class Readout:
    """Trained readout W_out (N', D_out).  N' = cfg.n_features."""
    w_out: torch.Tensor


@dataclasses.dataclass(frozen=True)
class StandardParams:
    """Dense-W reservoir (leak already folded in: W = lr W_raw + (1-lr) I)."""
    w: torch.Tensor                    # (N, N)
    w_in: torch.Tensor                 # (D_in, N), pre-scaled by leak
    w_fb: Optional[torch.Tensor]       # (D_out, N) or None
    cfg: ESNConfig

    @property
    def mode(self) -> str:
        return "standard"

    @property
    def dtype(self) -> torch.dtype:
        return self.w.dtype

    @property
    def device(self) -> torch.device:
        return self.w.device


@dataclasses.dataclass(frozen=True)
class DiagParams:
    """Diagonalized reservoir in the real Q basis (paper Appendix A).

    ``lam_q``: (N,) packed eigenvalues ``[reals | (re, im) pairs]`` (see
    ``core.scan.pack_lambda_q``); ``win_q``/``wfb_q``: input/feedback maps
    transformed into Q; ``qtq``: the EET metric Q^T Q (Eq. 29); ``n_real``:
    where the real slots end and the (re, im) pairs begin.
    """
    lam_q: torch.Tensor                # (N,)
    win_q: torch.Tensor                # (D_in, N)
    wfb_q: Optional[torch.Tensor]      # (D_out, N) or None
    qtq: torch.Tensor                  # (N, N)
    cfg: ESNConfig
    n_real: int = 0

    @property
    def mode(self) -> str:
        return "diag"

    @property
    def dtype(self) -> torch.dtype:
        return self.lam_q.dtype

    @property
    def device(self) -> torch.device:
        return self.lam_q.device


_LEAVES = {"standard": ("w", "w_in", "w_fb"),
           "diag": ("lam_q", "win_q", "wfb_q", "qtq")}


def _leaf_names(params):
    return _LEAVES[params.mode]


def params_to(params, device):
    """The same struct with every tensor leaf on ``device``."""
    moved = {k: (None if getattr(params, k) is None
                 else getattr(params, k).to(device))
             for k in _leaf_names(params)}
    return dataclasses.replace(params, **moved)


def stack_params(params_seq):
    """Stack same-config structs along a new leading axis (only ``cfg.seed``
    may differ; the stacked struct carries the head's cfg)."""
    params_seq = list(params_seq)
    if not params_seq:
        raise ValueError("stack_params needs at least one struct")
    head = params_seq[0]
    for p in params_seq[1:]:
        if dataclasses.replace(p.cfg, seed=head.cfg.seed) != head.cfg:
            raise ValueError(
                "stack_params: mismatched configs across the batch — only "
                "cfg.seed may differ between stacked reservoirs "
                f"({p.cfg} vs {head.cfg})")
        if (type(p) is not type(head)
                or getattr(p, "n_real", 0) != getattr(head, "n_real", 0)
                or any((getattr(p, k) is None) != (getattr(head, k) is None)
                       for k in _leaf_names(head))):
            raise ValueError(
                "stack_params: mismatched static aux (n_real / feedback "
                "presence) across the batch")
    stacked = {k: (None if getattr(head, k) is None else
                   torch.stack([getattr(p, k) for p in params_seq]))
               for k in _leaf_names(head)}
    return dataclasses.replace(head, **stacked)


def _config(cfg) -> ESNConfig:
    return cfg if isinstance(cfg, ESNConfig) else ESNConfig(**dict(cfg))


def params_from_numpy(kind: str, arrays: Mapping[str, Optional[np.ndarray]],
                      cfg, *, n_real: Optional[int] = None, device=None):
    """Build a port param struct from another framework's leaves.

    ``kind``: ``"standard"`` or ``"diag"``; ``arrays``: leaf name -> numpy
    array (or None for an absent feedback map) — ``w, w_in, w_fb`` or
    ``lam_q, win_q, wfb_q, qtq``; ``cfg``: an :class:`ESNConfig` or a dict
    of its fields; ``n_real``: the diag layout split (required for diag).
    Values and dtypes are kept exactly (the arrays are copied)."""
    if kind not in _LEAVES:
        raise ValueError(f"kind must be 'standard' or 'diag', got {kind!r}")
    dev = resolve_device(device)
    cfg = _config(cfg)
    leaves = {}
    for name in _LEAVES[kind]:
        v = arrays.get(name)
        leaves[name] = (None if v is None else
                        torch.tensor(np.asarray(v), device=dev))
    if kind == "standard":
        return StandardParams(cfg=cfg, **leaves)
    if n_real is None:
        raise ValueError("diag params need n_real (the [reals | pairs] split)")
    return DiagParams(cfg=cfg, n_real=int(n_real), **leaves)


def readout_from_numpy(w_out, device=None) -> Readout:
    """A :class:`Readout` from a numpy ``(N', D_out)`` array, values kept."""
    return Readout(torch.tensor(np.asarray(w_out),
                                device=resolve_device(device)))
