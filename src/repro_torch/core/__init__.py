"""Reservoir math of the port: spectra and bases (numpy), param structs,
scans, ridge solves, the model functions and the backend dispatch — the
JAX package's ``core`` namespace, name for name."""
from . import basis, dispatch, esn, params, ridge, scan, spectral
from .basis import EigenBasis
from .dispatch import resolve_method, run_scan_q
from .esn import (LinearESN, diag_params, dpg_params, ewt_readout, fit,
                  generate, predict, run, standard_params)
from .params import DiagParams, ESNConfig, Readout, StandardParams, stack_params
from .spectral import Spectrum, dpg

__all__ = [
    "basis", "dispatch", "esn", "params", "ridge", "scan", "spectral",
    "EigenBasis", "ESNConfig", "LinearESN", "Spectrum", "dpg",
    "StandardParams", "DiagParams", "Readout", "stack_params",
    "standard_params", "diag_params", "dpg_params", "ewt_readout",
    "run", "fit", "predict", "generate",
    "resolve_method", "run_scan_q",
]
