"""The port's package namespaces re-export what the JAX package's do,
name for name, and every name resolves to the port's own object (a
constant, to the JAX one's value)."""
import importlib
import types

import numpy as np
import pytest
import torch

NAMESPACES = ["core", "serve", "kernels", "models", "data", "train"]


@pytest.mark.parametrize("ns", NAMESPACES)
def test_namespace_exports_the_jax_names(ns):
    jax_ns = importlib.import_module(f"repro.{ns}")
    port_ns = importlib.import_module(f"repro_torch.{ns}")
    assert port_ns.__all__ == jax_ns.__all__
    for name in port_ns.__all__:
        obj = getattr(port_ns, name)
        if isinstance(obj, types.ModuleType):
            assert obj.__name__.startswith("repro_torch."), name
        elif hasattr(obj, "__module__"):
            assert obj.__module__.startswith("repro_torch."), (name, obj)
        else:
            np.testing.assert_array_equal(obj, getattr(jax_ns, name))


def test_serve_namespace_carries_the_frontend():
    from repro_torch import serve
    from repro_torch.serve import frontend
    assert serve.OpenLoopServer is frontend.OpenLoopServer
    assert serve.AdmissionFull is frontend.AdmissionFull


def test_kernels_names_are_the_wrappers_as_in_jax():
    """``kernels.diag_scan`` / ``flash_attention`` are the callable
    wrappers, as JAX's are, and stay so after the launcher modules of the
    same names are imported by their full path."""
    import sys

    from repro import kernels as jkernels
    from repro_torch import kernels
    from repro_torch.kernels.diag_scan import scan_chunks
    from repro_torch.kernels.flash_attention import flash_attention_fwd_cuda
    for name in ("diag_scan", "flash_attention"):
        assert callable(getattr(jkernels, name))
        assert getattr(kernels, name) is getattr(kernels.ops, name)
        assert sys.modules[f"repro_torch.kernels.{name}"].__name__ == (
            f"repro_torch.kernels.{name}")
    assert callable(scan_chunks) and callable(flash_attention_fwd_cuda)
    a = torch.full((3,), 0.5, dtype=torch.complex128)
    x = torch.ones((1, 4, 3), dtype=torch.complex128)
    torch.testing.assert_close(kernels.diag_scan(a, x),
                               kernels.ops.diag_scan(a, x))
