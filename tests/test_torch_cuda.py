"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one; this file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float64 ``1e-9 * max(1, max|ref|)`` (the kernels contract
multiply-adds into FMAs and sum the readout in a tree); float32 2e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import dispatch
from repro_torch.core import esn
from repro_torch.core.params import ESNConfig
from repro_torch.data.signals import mso_series
from repro_torch.kernels import ops, ref
from repro_torch.serve.engine import ReservoirEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _close(got, want, dtype=torch.float64):
    got, want = got.detach().cpu(), want.detach().cpu()
    if dtype in (torch.float32, torch.complex64):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4)
        return
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    assert float((got - want).abs().max()) <= 1e-9 * scale


SCAN_CASES = {
    "wave-static": ((8, 1024, 525), "static", True, False, torch.float64),
    "fit-static": ((1, 2000, 525), "static", True, False, torch.float64),
    "time-a": ((3, 77, 130), "time", True, False, torch.float64),
    "full-a-h0": ((2, 50, 20), "full", False, True, torch.float64),
    "ragged-h0": ((5, 333, 257), "static", True, True, torch.float64),
    "real": ((4, 100, 129), "static", False, False, torch.float64),
    "f32": ((4, 256, 300), "static", True, True, torch.float32),
}


def scan_inputs(shape, a_kind, cplx, with_h0, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    b, t, n = shape
    a_shape = {"static": (n,), "time": (t, n), "full": (b, t, n)}[a_kind]
    a = torch.rand(a_shape, generator=g, dtype=torch.float64) * 0.6 + 0.35
    x = torch.randn((b, t, n), generator=g, dtype=torch.float64)
    h0 = torch.randn((b, n), generator=g, dtype=torch.float64) if with_h0 \
        else None
    if cplx:
        a = torch.polar(a, torch.rand(a_shape, generator=g,
                                      dtype=torch.float64) * np.pi)
        x = torch.complex(x, torch.randn((b, t, n), generator=g,
                                         dtype=torch.float64))
        if h0 is not None:
            h0 = torch.complex(h0, torch.randn((b, n), generator=g,
                                               dtype=torch.float64))
    if dtype == torch.float32:
        a, x = a.to(torch.complex64 if cplx else dtype), x.to(
            torch.complex64 if cplx else dtype)
        h0 = None if h0 is None else h0.to(a.dtype)
    move = (lambda v: None if v is None else v.to(device))
    return move(a), move(x), move(h0)


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_diag_scan_kernel_matches_plain(dev, name):
    shape, a_kind, cplx, with_h0, dtype = SCAN_CASES[name]
    a, x, h0 = scan_inputs(shape, a_kind, cplx, with_h0, dtype, dev)
    before = ops.diag_scan.launches
    got = ops.diag_scan(a, x, h0)
    assert ops.diag_scan.launches == before + 1
    torch.cuda.synchronize()
    _close(got, ref.diag_scan_ref(a, x, h0), dtype)


@pytest.mark.parametrize("name", ["wave-static", "time-a", "full-a-h0",
                                  "real", "f32"])
def test_diag_scan_lanes_kernel_matches_plain(dev, name):
    shape, a_kind, cplx, with_h0, dtype = SCAN_CASES[name]
    a, x, h0 = scan_inputs(shape, a_kind, cplx, with_h0, dtype, dev)

    def split(v):
        if v is None:
            return None, None
        return (v.real.contiguous(), v.imag.contiguous()) if cplx else (v, None)
    before = ops.diag_scan.launches
    got_re, got_im = ops.diag_scan_lanes(*split(a), *split(x), *split(h0))
    assert ops.diag_scan.launches == before + 1
    torch.cuda.synchronize()
    want_re, want_im = split(ref.diag_scan_ref(a, x, h0))
    _close(got_re, want_re, dtype)
    if cplx:
        _close(got_im, want_im, dtype)
    else:
        assert got_im is None


def test_empty_scan_counts_no_launch(dev):
    a = torch.ones(5, dtype=torch.float64, device=dev)
    x = torch.zeros((2, 0, 5), dtype=torch.float64, device=dev)
    before = ops.diag_scan.launches
    assert ops.diag_scan(a, x).shape == (2, 0, 5)
    assert ops.diag_scan.launches == before


def test_diag_scan_kernel_refuses_grad(dev):
    a, x, _ = scan_inputs((1, 8, 4), "static", False, False, torch.float64,
                          dev)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.diag_scan(a.requires_grad_(), x)


def decode_inputs(b, nc, d, batched, device, seed=1):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, s=1.0):
        return (s * torch.randn(shape, generator=g,
                                dtype=torch.float64)).to(device)
    lead = (b,) if batched else ()
    mag = torch.rand(nc, generator=g, dtype=torch.float64) * 0.45 + 0.5
    ph = torch.rand(nc, generator=g, dtype=torch.float64) * np.pi
    return [(mag * torch.cos(ph)).to(device), (mag * torch.sin(ph)).to(device),
            r(b, nc), r(b, nc), r(b, d), r(*lead, d, nc, s=0.3),
            r(*lead, d, nc, s=0.3), r(*lead, d, d, s=0.2), r(*lead, d, s=0.1),
            # readout weights ~1/NC keep the closed loop's gain below one
            r(*lead, nc, d, s=0.5 / nc), r(*lead, nc, d, s=0.5 / nc)]


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "3d"])
@pytest.mark.parametrize("ensemble", ["off", "mean"])
@pytest.mark.parametrize("b,nc,d", [(8, 525, 1), (3, 40, 2), (1, 700, 1)])
def test_decode_fused_kernel_matches_plain(dev, batched, ensemble, b, nc, d):
    args = decode_inputs(b, nc, d, batched, dev)
    mask = torch.arange(b, device=dev) != 1           # partial mask
    before = ops.decode_fused.launches
    got = ops.decode_fused(*args, mask, k=128, ensemble=ensemble)
    assert ops.decode_fused.launches == before + 1
    torch.cuda.synchronize()
    want = ref.decode_fused_ref(*args, mask, k=128, ensemble=ensemble)
    for g_, w_ in zip(got, want):
        _close(g_, w_)


def test_kernel_scan_route_matches_chunked(dev):
    cfg = ESNConfig(n=96, spectral_radius=0.95, leak=0.9, seed=2)
    p = esn.dpg_params(cfg, sigma=0.1, device=dev)
    d = torch.randn((3, 600, 96), dtype=torch.float64, device=dev)
    h0 = torch.randn((3, 96), dtype=torch.float64, device=dev)
    assert dispatch.resolve_method(600, device=dev) == "kernel"
    got = dispatch.run_scan_q(p.lam_q, d, p.n_real, h0)
    want = dispatch.run_scan_q(p.lam_q, d, p.n_real, h0, method="chunked")
    _close(got, want)


def test_engine_on_card_matches_cpu_engine(dev):
    cfg = ESNConfig(n=96, spectral_radius=0.95, leak=0.9, input_scaling=0.5,
                    seed=0)
    sig = mso_series(3, 2001)
    # One readout for both engines: the ridge solve's conditioning would
    # amplify last-bit differences between two fits.
    p = esn.dpg_params(cfg, sigma=0.1, device="cpu")
    ro = esn.fit(p, sig[:-1, None], sig[1:, None], washout=100)
    outs = {}
    for device in (dev, torch.device("cpu")):
        eng = ReservoirEngine(p, 4, readout=ro, device=device, chunk_max=512)
        for i, t in enumerate((20, 100, 700, 1024, 300)):
            eng.submit(i, sig[i:i + t, None])
        got = {}
        while eng.active_sessions or len(eng.pending):
            eng.flush()
            ys = eng.decode_closed_loop(16)
            for sid in list(eng.ready_sessions):
                state, y = eng.release(sid)
                got[sid] = (ys[sid].cpu(), state.cpu(), y.cpu())
        outs[device.type] = got
    for sid, (ys, state, y) in outs["cuda"].items():
        ys_c, state_c, y_c = outs["cpu"][sid]
        _close(ys, ys_c)
        _close(state, state_c)
        _close(y, y_c)
