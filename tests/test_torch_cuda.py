"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one; this file imports no JAX, so it runs where only PyTorch is installed
(``--noconftest`` skips ``tests/conftest.py``, which configures JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float64 ``1e-9 * max(1, max|ref|)`` (the kernels contract
multiply-adds into FMAs and sum the readout in a tree); float32 2e-4 (the
JAX package's kernel tests), scaled by ``max(1, max|ref|)`` for gradients,
whose ``da`` sums thousands of terms in another order; flash attention in
bfloat16 5e-2 (the JAX package's bf16 kernel test); the LM on the card
against the CPU 1e-4 relative (float32, TF32 off).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import dispatch
from repro_torch.core import esn
from repro_torch.core.params import ESNConfig
from repro_torch.data.signals import mso_series
from repro_torch.configs import smoke_config
from repro_torch.kernels import diag_scan as dsk
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import lm
from repro_torch.serve.engine import ReservoirEngine
from repro_torch.train.trainer import loss_and_grads
from repro_torch.tree import flatten, tree_map

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


def _close_scaled(got, want, dtype):
    """max|d| <= tol * max(1, max|ref|): 2e-4 in float32, 1e-9 in float64."""
    got, want = got.detach().cpu(), want.detach().cpu()
    tol = 2e-4 if dtype == torch.float32 else 1e-9
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= tol * scale, (err, tol * scale)


def _split(v, cplx):
    if v is None:
        return None, None
    return (v.real.contiguous(), v.imag.contiguous()) if cplx else (v, None)


BWD_CASES = {
    # the training shape of linear-esn: B=8, T=1024, d_rnn=1024, static a
    "train-f32": ((8, 1024, 1024), "static", True, False, torch.float32),
    "train-f64": ((8, 1024, 1024), "static", True, False, torch.float64),
    "time-a": ((3, 77, 130), "time", True, False, torch.float64),
    "full-a-h0": ((2, 50, 20), "full", False, True, torch.float64),
    "ragged-h0": ((5, 333, 257), "static", True, True, torch.float64),
    "real": ((4, 100, 129), "static", False, False, torch.float64),
}


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_diag_scan_bwd_kernel_matches_plain(dev, name):
    shape, a_kind, cplx, with_h0, dtype = BWD_CASES[name]
    a, x, h0 = scan_inputs(shape, a_kind, cplx, with_h0, dtype, dev)
    (a_re, a_im), (h0_re, h0_im) = _split(a, cplx), _split(h0, cplx)
    h_re, h_im = ops.diag_scan_lanes(a_re, a_im, *_split(x, cplx), h0_re,
                                     h0_im)
    g = torch.Generator().manual_seed(7)
    g_re = torch.randn(shape, generator=g, dtype=dtype).to(dev)
    g_im = torch.randn(shape, generator=g, dtype=dtype).to(dev) if cplx \
        else None
    args = (a_re, a_im, h_re, h_im, g_re, g_im, h0_re, h0_im)
    before = ops.diag_scan_bwd.launches
    got = ops.diag_scan_bwd(*args)
    assert ops.diag_scan_bwd.launches == before + 1
    torch.cuda.synchronize()
    want = ref.diag_scan_lanes_bwd_ref(*args)
    for name_, g_, w_ in zip(("da_re", "da_im", "dx_re", "dx_im", "dh0_re",
                              "dh0_im"), got, want):
        if w_ is None:
            assert g_ is None, name_
            continue
        assert g_.shape == w_.shape, name_
        _close_scaled(g_, w_, dtype)


# Ragged shapes for the chunk sweep: T a multiple of no chunk count swept,
# N of no 128-lane tile.
CHUNK_CASES = {
    "static-h0": ((5, 333, 257), "static", True, True, torch.float64),
    "time-a": ((3, 77, 130), "time", True, False, torch.float64),
    "full-a-real-h0": ((2, 50, 20), "full", False, True, torch.float64),
    "f32-static-h0": ((4, 256, 300), "static", True, True, torch.float32),
    "f32-time-real": ((3, 100, 129), "time", False, False, torch.float32),
}
CHUNK_SWEEP = [1, 2, 7, 64, 1000]


@pytest.mark.parametrize("chunks", CHUNK_SWEEP)
@pytest.mark.parametrize("name", list(CHUNK_CASES))
def test_diag_scan_chunks_match_both_plain_versions(dev, name, chunks):
    """The forward kernels at a forced chunk count against the sequential
    plain version and the chunked one at the same count."""
    shape, a_kind, cplx, with_h0, dtype = CHUNK_CASES[name]
    a, x, h0 = scan_inputs(shape, a_kind, cplx, with_h0, dtype, dev)
    lanes = (*_split(a, cplx), *_split(x, cplx), *_split(h0, cplx))
    got = dsk.diag_scan_lanes_cuda(*lanes, chunks=chunks)
    torch.cuda.synchronize()
    for want in (ref.diag_scan_lanes_ref(*lanes),
                 ref.diag_scan_lanes_chunked_ref(*lanes, chunks=chunks)):
        for g_, w_ in zip(got, want):
            assert (g_ is None) == (w_ is None)
            if w_ is not None:
                _close(g_, w_, dtype)


@pytest.mark.parametrize("chunks", CHUNK_SWEEP)
@pytest.mark.parametrize("name", list(CHUNK_CASES))
def test_diag_scan_bwd_chunks_match_both_plain_versions(dev, name, chunks):
    """The backward kernels at a forced chunk count against the sequential
    reverse-time plain version and the chunked one at the same count."""
    shape, a_kind, cplx, with_h0, dtype = CHUNK_CASES[name]
    a, x, h0 = scan_inputs(shape, a_kind, cplx, with_h0, dtype, dev)
    (a_re, a_im), (h0_re, h0_im) = _split(a, cplx), _split(h0, cplx)
    h_re, h_im = dsk.diag_scan_lanes_cuda(a_re, a_im, *_split(x, cplx),
                                          h0_re, h0_im, chunks=chunks)
    g = torch.Generator().manual_seed(7)
    g_re = torch.randn(shape, generator=g, dtype=dtype).to(dev)
    g_im = torch.randn(shape, generator=g, dtype=dtype).to(dev) if cplx \
        else None
    args = (a_re, a_im, h_re, h_im, g_re, g_im, h0_re, h0_im)
    got = dsk.diag_scan_lanes_bwd_cuda(*args, chunks=chunks)
    torch.cuda.synchronize()
    for want in (ref.diag_scan_lanes_bwd_ref(*args),
                 ref.diag_scan_lanes_bwd_chunked_ref(*args, chunks=chunks)):
        for g_, w_ in zip(got, want):
            assert (g_ is None) == (w_ is None)
            if w_ is not None:
                assert g_.shape == w_.shape
                _close_scaled(g_, w_, dtype)


def test_diag_scan_autograd_runs_both_kernels(dev):
    """``ops.diag_scan``'s gradient on the card equals the CPU's, and the
    backward went through the backward kernel."""
    a, x, h0 = scan_inputs((3, 200, 70), "static", True, True,
                           torch.float64, dev)
    grads = {}
    for device in (dev, torch.device("cpu")):
        leaves = [v.detach().to(device).requires_grad_() for v in (a, x, h0)]
        fwd, bwd = ops.diag_scan.launches, ops.diag_scan_bwd.launches
        h = ops.diag_scan(*leaves)
        (h.real * h.imag).sum().backward()
        launched = (ops.diag_scan.launches - fwd,
                    ops.diag_scan_bwd.launches - bwd)
        assert launched == ((1, 1) if device.type == "cuda" else (0, 0))
        grads[device.type] = [v.grad for v in leaves]
    for g_, w_ in zip(grads["cuda"], grads["cpu"]):
        _close_scaled(g_, w_, torch.float64)


def test_lm_train_step_card_matches_cpu(dev):
    """One loss-and-gradient step of a 2-layer reservoir LM from the same
    weights: the card (kernels forward and backward) against the CPU (their
    plain versions), float32 with TF32 off."""
    cfg = dataclasses.replace(smoke_config("linear-esn"), n_layers=2)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 64)))
    out = {}
    for device in (dev, torch.device("cpu")):
        fwd, bwd = ops.diag_scan.launches, ops.diag_scan_bwd.launches
        p = tree_map(lambda v: v.to(device), params)
        loss, _, grads = loss_and_grads(cfg, p, {"tokens": toks.to(device)})
        if device.type == "cuda":
            assert (ops.diag_scan.launches - fwd,
                    ops.diag_scan_bwd.launches - bwd) == (2, 2)
        out[device.type] = (float(loss), flatten(grads))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    for k, w_ in g_cpu.items():
        d = float((g_gpu[k].cpu() - w_).abs().max())
        assert d <= 1e-4 * float(w_.abs().max()), k


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


def packed_inputs(b, nr, npairs, d, batched, device, *, bias=True, fb=True,
                  seed=2):
    """Packed Q operands of ``ops.decode_fused_packed``: ``(lam_q, n_real,
    w_drive, w_out, states, y_prev)``, N = nr + 2 npairs."""
    rng = np.random.default_rng(seed)
    n = nr + 2 * npairs
    lead = (b,) if batched else ()
    mag = rng.uniform(0.5, 0.95, lead + (npairs,))
    ph = rng.uniform(0, np.pi, lead + (npairs,))
    pairs = np.stack([mag * np.cos(ph), mag * np.sin(ph)], -1).reshape(
        lead + (2 * npairs,))
    lam = np.concatenate([rng.uniform(-0.95, 0.95, lead + (nr,)), pairs], -1)
    f = n + int(bias) + (d if fb else 0)
    w_out = rng.normal(size=lead + (f, d)) * 0.1
    w_out[..., f - n:, :] *= 5.0 / n    # keep the closed loop's gain below 1

    def t(v):
        return torch.tensor(v, dtype=torch.float64, device=device)
    return (t(lam), nr, t(0.3 * rng.normal(size=lead + (d, n))), t(w_out),
            t(rng.normal(size=(b, n))), t(rng.normal(size=(b, d))))


# (B, NC, D): the main path's shape, small ones, the 16-slot arena, the
# served model at n = 2048 (1043 lanes), 4096 lanes and eight outputs.
DECODE_SHAPES = [(8, 525, 1), (3, 40, 2), (1, 700, 1), (16, 525, 1),
                 (8, 1043, 1), (4, 4096, 1), (4, 525, 8)]


def _decode_or_limit(ensemble, b, nc, d, batched, call):
    """``call()``, or — where the one-block ``mean`` route cannot hold the
    shape — the ValueError that names the limit, before any launch."""
    try:
        dsk.decode_layout(b, nc, d, 8, ensemble=ensemble, batched=batched)
    except ValueError:
        assert ensemble == "mean", "the off route takes every test shape"
        before = ops.decode_fused.launches
        with pytest.raises(ValueError, match="ensemble='mean' runs every "
                                             "row in one block"):
            call()
        assert ops.decode_fused.launches == before
        return None
    return call()


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "3d"])
@pytest.mark.parametrize("ensemble", ["off", "mean"])
@pytest.mark.parametrize("b,nc,d", DECODE_SHAPES)
def test_decode_fused_kernel_matches_plain(dev, batched, ensemble, b, nc, d):
    args = decode_inputs(b, nc, d, batched, dev)
    mask = torch.arange(b, device=dev) != 1           # partial mask
    before = ops.decode_fused.launches
    got = _decode_or_limit(ensemble, b, nc, d, batched, lambda: ops.decode_fused(
        *args, mask, k=128, ensemble=ensemble))
    if got is None:
        return
    assert ops.decode_fused.launches == before + 1
    torch.cuda.synchronize()
    want = ref.decode_fused_ref(*args, mask, k=128, ensemble=ensemble)
    for g_, w_ in zip(got, want):
        _close(g_, w_)


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "3d"])
@pytest.mark.parametrize("ensemble", ["off", "mean"])
@pytest.mark.parametrize("b,nc,d", DECODE_SHAPES)
def test_decode_fused_packed_kernel_matches_plain(dev, batched, ensemble, b,
                                                  nc, d):
    """The packed entry (what the engine calls) against its plain version:
    the lanes split, ``decode_fused_ref``, the state packed back."""
    nr = nc // 7                       # some real slots, the rest pairs
    args = packed_inputs(b, nr, nc - nr, d, batched, dev)
    mask = torch.arange(b, device=dev) != 1
    kw = dict(k=128, use_bias=True, use_feedback=True, ensemble=ensemble)
    before = ops.decode_fused.launches
    got = _decode_or_limit(ensemble, b, nc, d, batched, lambda: (
        ops.decode_fused_packed(*args, mask, **kw)))
    if got is None:
        return
    assert ops.decode_fused.launches == before + 1
    torch.cuda.synchronize()
    want = ref.decode_fused_packed_ref(*args, mask, **kw)
    for g_, w_ in zip(got, want):
        _close(g_, w_)


@pytest.mark.parametrize("use_bias,use_feedback",
                         [(False, False), (True, False), (False, True)])
def test_decode_fused_packed_readout_rows(dev, use_bias, use_feedback):
    """``w_out`` without its bias or feedback rows: the row offsets."""
    args = packed_inputs(5, 9, 60, 2, False, dev, bias=use_bias,
                         fb=use_feedback)
    mask = torch.tensor([True, True, False, True, True], device=dev)
    kw = dict(k=17, use_bias=use_bias, use_feedback=use_feedback)
    got = ops.decode_fused_packed(*args, mask, **kw)
    want = ref.decode_fused_packed_ref(*args, mask, **kw)
    for g_, w_ in zip(got, want):
        _close(g_, w_)


@pytest.mark.parametrize("warps", [1, 2, 4, 8, 16, 32])
def test_decode_fused_every_fitting_warp_count(dev, warps):
    """The sweep's forced W (chip_smoke.py phase 4) at the main path's
    shape: every W that fits matches the plain version; one that does not
    (W = 1: 17 lanes a thread; W = 32: more threads than the one-lane
    instantiation's registers allow) is refused before launch."""
    args = decode_inputs(8, 525, 1, False, dev)
    mask = torch.ones(8, dtype=torch.bool, device=dev)
    try:
        dsk.decode_layout(8, 525, 1, 8, warps=warps)
    except ValueError:
        assert warps in (1, 32)
        with pytest.raises(ValueError, match=f"warps={warps} does not fit"):
            dsk.decode_fused_cuda(*args, mask, k=128, warps=warps)
        return
    got = dsk.decode_fused_cuda(*args, mask, k=128, warps=warps)
    want = ref.decode_fused_ref(*args, mask, k=128)
    for g_, w_ in zip(got, want):
        _close(g_, w_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_decode_fused_row_bits_independent_of_arena(dev, dtype):
    """ensemble="off": a row's bits are the same at B = 1 and B = 16, and
    whatever the other rows hold; two runs are bit-identical."""
    args = [v.to(dtype) for v in packed_inputs(16, 75, 450, 1, False, dev)
            if torch.is_tensor(v)]
    lam, w_drive, w_out, states, y_prev = args
    mask = torch.ones(16, dtype=torch.bool, device=dev)
    kw = dict(k=128, use_bias=True, use_feedback=True)
    full = ops.decode_fused_packed(lam, 75, w_drive, w_out, states, y_prev,
                                   mask, **kw)
    again = ops.decode_fused_packed(lam, 75, w_drive, w_out, states, y_prev,
                                    mask, **kw)
    for a_, b_ in zip(full, again):
        assert torch.equal(a_, b_)
    one = ops.decode_fused_packed(lam, 75, w_drive, w_out, states[5:6],
                                  y_prev[5:6], mask[5:6], **kw)
    other = states.clone()
    other[:5] = torch.randn_like(other[:5])
    other[6:] *= -3.0
    moved = ops.decode_fused_packed(lam, 75, w_drive, w_out, other, y_prev,
                                    mask, **kw)
    for got in (one, moved):
        row = 0 if got is one else 5
        assert torch.equal(got[0][row], full[0][5])
        assert torch.equal(got[1][row], full[1][5])
        assert torch.equal(got[2][:, row], full[2][:, 5])


@pytest.mark.parametrize("ensemble", ["off", "mean"])
def test_decode_fused_split_runs_repeat_bitwise(dev, ensemble):
    args = decode_inputs(8, 525, 1, True, dev)
    mask = torch.arange(8, device=dev) != 3
    first = ops.decode_fused(*args, mask, k=128, ensemble=ensemble)
    second = ops.decode_fused(*args, mask, k=128, ensemble=ensemble)
    for a_, b_ in zip(first, second):
        assert torch.equal(a_, b_)


def test_run_decode_fused_is_one_launch(dev):
    """The engine's decode call at the serving shape makes exactly one CUDA
    kernel launch: no lane copies around the kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = ESNConfig(n=1024, spectral_radius=0.95, leak=0.9, seed=0)
    p = esn.dpg_params(cfg, "noisy_golden", sigma=0.1, device=dev)
    w_drive = p.win_q + p.wfb_q if cfg.use_feedback else p.win_q
    n = p.lam_q.shape[-1]
    w_out = torch.randn((1 + n, 1), dtype=torch.float64, device=dev) / n
    states = torch.randn((8, n), dtype=torch.float64, device=dev)
    y_prev = torch.randn((8, 1), dtype=torch.float64, device=dev)
    mask = torch.ones(8, dtype=torch.bool, device=dev)

    def call():
        return dispatch.run_decode_fused(p.lam_q, p.n_real, w_drive, w_out,
                                         states, y_prev, mask, 128,
                                         use_bias=True, use_feedback=False)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "decode_fused_kernel" in kernels[0], kernels


def test_serve_16_slots_full_width_matches_cpu(dev):
    """The 16-slot arena at n = 1024 (the JAX benchmark's mixed-traffic
    arena) through the kernel, against the CPU engine."""
    cfg = ESNConfig(n=1024, spectral_radius=0.95, leak=0.9, input_scaling=0.5,
                    ridge_alpha=1e-8, seed=0)
    sig = mso_series(3, 2001)
    p = esn.dpg_params(cfg, "noisy_golden", sigma=0.1, device="cpu")
    ro = esn.fit(p, sig[:-1, None], sig[1:, None], washout=100)
    starts = np.random.default_rng(0).integers(0, 2000 - 256, size=16)
    outs = {}
    for device in (dev, torch.device("cpu")):
        eng = ReservoirEngine(p, 16, readout=ro, device=device)
        for sid, lo in enumerate(starts):
            eng.submit(sid, sig[lo:lo + 256, None])
        eng.flush()
        before = ops.decode_fused.launches
        ys = eng.decode_closed_loop(32)
        launched = ops.decode_fused.launches - before
        outs[device.type] = ({s: (ys[s].cpu(), *(v.cpu() for v in
                                                 eng.release(s)))
                              for s in range(16)}, launched)
    assert outs["cuda"][1] == 1 and outs["cpu"][1] == 0
    for sid in range(16):
        for g_, w_ in zip(outs["cuda"][0][sid], outs["cpu"][0][sid]):
            assert bool(torch.isfinite(g_).all())
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


# --------------------------------------------------------------------------- #
# Param batches: B1 with one row of coefficients a reservoir, B2's mean route  #
# --------------------------------------------------------------------------- #
# (B, T, NC) of a scan whose `a` is static in time with one row per batch
# row — (B, 1, NC) lanes read with a time stride of 0 — and the chunk counts
# forced on it (None: the launcher's rule).
ROW_A_SHAPES = [(8, 1024, 525), (3, 77, 130), (5, 333, 257), (2, 1, 40),
                (16, 64, 525), (1, 2000, 525)]


@pytest.mark.parametrize("chunks", [None, 1, 3, 16])
@pytest.mark.parametrize("shape", ROW_A_SHAPES)
def test_diag_scan_per_row_static_a_matches_plain(dev, shape, chunks):
    b, t, nc = shape
    g = torch.Generator().manual_seed(b * t + nc)
    a = torch.polar(torch.rand((b, 1, nc), generator=g,
                               dtype=torch.float64) * 0.6 + 0.35,
                    torch.rand((b, 1, nc), generator=g,
                               dtype=torch.float64) * np.pi)
    x = torch.complex(torch.randn((b, t, nc), generator=g,
                                  dtype=torch.float64),
                      torch.randn((b, t, nc), generator=g,
                                  dtype=torch.float64))
    h0 = torch.complex(torch.randn((b, nc), generator=g, dtype=torch.float64),
                       torch.randn((b, nc), generator=g, dtype=torch.float64))
    lanes = [v.to(dev).contiguous() for z in (a, x, h0)
             for v in (z.real, z.imag)]
    got = dsk.diag_scan_lanes_cuda(*lanes, chunks=chunks)
    want = ref.diag_scan_ref(a, x, h0)
    _close(got[0], want.real)
    _close(got[1], want.imag)
    # Each row really runs its own coefficients: row b alone, shared `a`.
    row = ref.diag_scan_ref(a[-1, 0], x[-1:], h0[-1:])
    _close(got[0][-1:], row.real)


@pytest.mark.parametrize("t", [20, 600])
def test_batched_scan_route_is_one_launch_and_matches_plain(dev, t):
    """``run_scan_q`` with a (B, N) ``lam_q`` (a param-batched wave): one
    kernel launch for the wave, equal to the plain scans with per-row
    coefficients and to each reservoir's own scan."""
    cfg = ESNConfig(n=96, spectral_radius=0.95, leak=0.9, seed=2)
    ps = [esn.dpg_params(dataclasses.replace(cfg, seed=s), sigma=0.1,
                         device=dev) for s in range(3)]
    nr = {p.n_real for p in ps}
    if len(nr) != 1:
        pytest.skip("the seeds gave reservoirs of different layouts")
    lam = torch.stack([p.lam_q for p in ps])
    d = torch.randn((3, t, 96), dtype=torch.float64, device=dev)
    h0 = torch.randn((3, 96), dtype=torch.float64, device=dev)
    before = ops.diag_scan.launches
    got = dispatch.run_scan_q(lam, d, nr.pop(), h0, method="kernel")
    assert ops.diag_scan.launches - before == 1
    for method in ("sequential", "chunked"):
        _close(got, dispatch.run_scan_q(lam, d, ps[0].n_real, h0,
                                        method=method))
    for i, p in enumerate(ps):
        _close(got[i], dispatch.run_scan_q(p.lam_q, d[i:i + 1], p.n_real,
                                           h0[i:i + 1], method="kernel")[0])


def _ensemble(slots, n):
    """``slots`` dpg reservoirs at width ``n``, stacked, with readouts
    fitted on the CPU (one readout stack for every device)."""
    from repro_torch.core.params import Readout, stack_params
    cfg = ESNConfig(n=n, spectral_radius=0.95, leak=0.9, input_scaling=0.5,
                    ridge_alpha=1e-8, seed=0)
    sig = mso_series(3, 2001)
    ps = [esn.dpg_params(dataclasses.replace(cfg, seed=i), "noisy_golden",
                         sigma=0.1, device="cpu") for i in range(slots)]
    w = torch.stack([esn.fit(p, sig[:-1, None], sig[1:, None],
                             washout=100).w_out for p in ps])
    return stack_params(ps), Readout(w), sig


@pytest.mark.parametrize("ensemble", ["off", "mean", "weighted"])
def test_ensemble_engine_on_card_matches_cpu(dev, ensemble):
    """The param-batched engine at the serving width (n = 1024, 8
    reservoirs): prefill through B1 with per-row coefficients, closed loop
    through B2 (``mean``: its ensemble route; ``weighted``: the
    step-at-a-time path), open-loop steps and ``observe``, against the CPU
    engine."""
    params, ro, sig = _ensemble(8, 1024)
    outs = {}
    for device in (dev, torch.device("cpu")):
        eng = ReservoirEngine.from_param_batch(params, ro, ensemble=ensemble,
                                               device=device)
        if ensemble == "weighted":
            eng.set_ensemble_weights(np.linspace(0.5, 2.0, 8))
        for i in range(8):
            eng.submit(i, sig[16 * i:16 * i + 512, None])
        counts = (ops.diag_scan.launches, ops.decode_fused.launches)
        eng.flush()
        steps = [eng.decode_step({i: sig[600 + i, None] for i in range(8)})]
        eng.observe(2, [0.5])
        ys = eng.decode_closed_loop(64)
        launched = (ops.diag_scan.launches - counts[0],
                    ops.decode_fused.launches - counts[1])
        outs[device.type] = ([torch.as_tensor(steps[0][i]) for i in range(8)]
                             + [ys[i].cpu() for i in range(8)]
                             + [eng.states.cpu(), eng.y_prev.cpu()], launched)
    assert outs["cuda"][1][0] == 1
    assert outs["cuda"][1][1] == (0 if ensemble == "weighted" else 1)
    for g_, w_ in zip(outs["cuda"][0], outs["cpu"][0]):
        assert bool(torch.isfinite(g_).all())
        _close(g_, w_)


def test_mean_ensemble_of_16_slots_at_n1024_raises_the_limit(dev):
    """B2's mean route holds every row in one block: 16 per-slot rows of
    525 float64 lanes exceed it, and the engine raises B2's ValueError
    rather than serve on another path."""
    params, ro, sig = _ensemble(16, 1024)
    eng = ReservoirEngine.from_param_batch(params, ro, ensemble="mean",
                                           device=dev)
    for i in range(16):
        eng.submit(i, sig[:256, None])
    eng.flush()
    before = ops.decode_fused.launches
    with pytest.raises(ValueError, match="ensemble='mean' runs every row in "
                                         "one block"):
        eng.decode_closed_loop(8)
    assert ops.decode_fused.launches == before


# --------------------------------------------------------------------------- #
# B3: flash attention                                                          #
# --------------------------------------------------------------------------- #
# (b, hq, hkv, sq, skv, d, causal, window, q_offset, kv_len)
FLASH_CASES = {
    "mha-causal": (1, 2, 2, 64, 64, 32, True, None, 0, None),
    "gqa": (2, 4, 2, 64, 64, 16, True, None, 0, None),
    "mqa-ragged": (1, 3, 1, 40, 40, 8, True, None, 0, None),
    "window": (1, 2, 2, 64, 64, 32, True, 16, 0, None),
    "decode": (1, 2, 1, 1, 96, 16, True, None, 95, None),
    "cross-ragged": (1, 2, 2, 48, 80, 16, False, None, 0, None),
    "kv_len": (2, 6, 3, 100, 150, 64, False, None, 0, 77),
    "hd128-window": (1, 4, 2, 130, 200, 128, True, 40, 70, None),
    "no-visible-key": (1, 2, 1, 20, 30, 24, True, None, -5, None),
    # smollm-135m's training chunks at batch 1 (heads and widths published)
    "smollm-chunk0": (1, 9, 3, 1024, 1024, 64, True, None, 0, None),
    "smollm-chunk1": (1, 9, 3, 1024, 2048, 64, True, None, 1024, None),
}


def flash_inputs(case, dtype, device, seed=0):
    b, hq, hkv, sq, skv, d = case[:6]
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, hq, sq, d), generator=g)
    k = torch.randn((b, hkv, skv, d), generator=g)
    # v in the (B, S, H, D) storage an einsum may return: read by strides
    v = torch.randn((b, skv, hkv, d), generator=g).permute(0, 2, 1, 3)
    return [t.to(device=device, dtype=dtype) for t in (q, k, v)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(dev, name, dtype):
    case = FLASH_CASES[name]
    causal, window, q_offset, kv_len = case[6:]
    q, k, v = flash_inputs(case, dtype, dev)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    before = ops.flash_attention_fwd.launches
    out, lse = ops.flash_attention_fwd(q, k, v, **kw)
    assert ops.flash_attention_fwd.launches == before + 1
    torch.cuda.synchronize()
    want, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
    assert out.dtype == dtype and lse.dtype == torch.float32
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


# The tensor-core kernel's tiling: 64-row query tiles of gb heads, 64-key
# (32 at head_dim 128) tiles staged by 16-byte copies or, for rows that are
# not 16-byte aligned, by scalar loads.  (case, layout, q scale)
FLASH_TILING_CASES = {
    "hd96-gqa3-ragged": ((1, 6, 2, 100, 170, 96, True, None, 70, None),
                         "contiguous", 1.0),
    "hd128-mha": ((2, 2, 2, 77, 77, 128, True, None, 0, None),
                  "contiguous", 1.0),
    "gqa8-ragged": ((1, 8, 1, 65, 129, 64, True, None, 64, None),
                    "contiguous", 1.0),
    "kv_len-inside-tile": ((1, 3, 1, 50, 200, 64, False, None, 0, 100),
                           "contiguous", 1.0),
    "window-across-tiles": ((1, 4, 2, 150, 150, 64, True, 70, 0, None),
                            "contiguous", 1.0),
    "window-offset-hd32": ((1, 3, 3, 70, 260, 32, True, 100, 190, None),
                           "contiguous", 1.0),
    "permuted-bshd": ((2, 9, 3, 90, 90, 64, True, None, 0, None),
                      "permuted", 1.0),
    "slice-unaligned-rows": ((1, 4, 2, 60, 60, 18, True, None, 0, None),
                             "slice", 1.0),
    "offset-storage": ((1, 3, 1, 70, 70, 64, True, None, 0, None),
                       "offset", 1.0),
    # q scaled so the scores reach magnitude ~30: the 3xTF32 split has to
    # keep float32 accuracy where one TF32 pass would not
    "scores-30": ((2, 9, 3, 128, 256, 64, True, None, 128, None),
                  "contiguous", 30.0),
}


def tiled_inputs(case, layout, q_scale, dtype, device, seed=0):
    """q, k, v of ``case`` in a storage layout: contiguous; ``permuted``
    (each a (B, S, H, D) tensor viewed as (B, H, S, D)); ``slice`` (rows
    1.. of a longer sequence: with head_dim 18 no row is 16-byte aligned);
    ``offset`` (storage starting one element in: no row is aligned)."""
    b, hq, hkv, sq, skv, d = case[:6]
    g = torch.Generator().manual_seed(seed)
    out = []
    for i, (h, s) in enumerate(((hq, sq), (hkv, skv), (hkv, skv))):
        scale = q_scale if i == 0 else 1.0
        shape = {"permuted": (b, s, h, d), "slice": (b, h, s + 1, d)}.get(
            layout, (b, h, s, d))
        t = (torch.randn(shape, generator=g) * scale).to(device=device,
                                                         dtype=dtype)
        if layout == "permuted":
            t = t.permute(0, 2, 1, 3)
        elif layout == "slice":
            t = t[:, :, 1:]
        elif layout == "offset":
            flat = torch.empty(t.numel() + 1, device=device, dtype=dtype)
            flat[1:] = t.reshape(-1)
            t = flat[1:].view(t.shape)
        out.append(t)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(FLASH_TILING_CASES))
def test_flash_attention_tiling_matches_plain(dev, name, dtype):
    case, layout, q_scale = FLASH_TILING_CASES[name]
    causal, window, q_offset, kv_len = case[6:]
    q, k, v = tiled_inputs(case, layout, q_scale, dtype, dev)
    row_bytes = q.shape[-1] * q.element_size()
    assert {"contiguous": q.is_contiguous(),
            "permuted": not q.is_contiguous(),
            "slice": not q.is_contiguous() and row_bytes % 16 != 0,
            "offset": q.data_ptr() % 16 != 0}[layout]
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    before = ops.flash_attention_fwd.launches
    out, lse = ops.flash_attention_fwd(q, k, v, **kw)
    assert ops.flash_attention_fwd.launches == before + 1
    torch.cuda.synchronize()
    want, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_flash_attention_counts_only_kernel_launches(dev):
    q, k, v = flash_inputs(FLASH_CASES["gqa"], torch.float32, dev)
    before = ops.flash_attention_fwd.launches
    ops.flash_attention_fwd(q.cpu(), k.cpu(), v.cpu())      # plain version
    ops.flash_attention_fwd(q[:, :, :0], k, v)              # empty grid
    assert ops.flash_attention_fwd.launches == before
    out = ops.flash_attention(q, k, v, True, None, 0)
    assert ops.flash_attention_fwd.launches == before + 1
    _close(out, ref.attention_ref(q, k, v), torch.float32)


def test_flash_attention_refuses_what_it_cannot_run(dev):
    q, k, v = flash_inputs(FLASH_CASES["gqa"], torch.float32, dev)
    with pytest.raises(ValueError, match="share one device"):
        ops.flash_attention_fwd(q, k.cpu(), v)
    meta = torch.zeros((1, 1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device type"):
        ops.flash_attention_fwd(meta, meta, meta)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention_fwd(q.double(), k.double(), v.double())
    wide = torch.zeros((1, 1, 4, 160), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention_fwd(wide, wide, wide)
    with pytest.raises(ValueError, match="GQA"):
        ops.flash_attention_fwd(q[:, :3], k, v)
    strided = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="unit-stride head dimension"):
        ops.flash_attention_fwd(strided, k, v)


def test_jnp_flash_grads_card_match_cpu(dev):
    """The model's flash attention (kernel forward, chunked backward) on the
    card against the CPU (plain forward), forward and gradients."""
    q, k, v = flash_inputs((2, 6, 2, 96, 160, 64), torch.float32, "cpu")
    cot = torch.randn(q.shape, generator=torch.Generator().manual_seed(3))
    out = {}
    for device in (dev, torch.device("cpu")):
        leaves = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        before = ops.flash_attention_fwd.launches
        o = attn_mod.jnp_flash(*leaves, True, None, 64, 32, 150)
        o.backward(cot.to(device))
        assert ops.flash_attention_fwd.launches - before == (
            1 if device.type == "cuda" else 0)
        out[device.type] = [o] + [t.grad for t in leaves]
    for g_, w_ in zip(out["cuda"], out["cpu"]):
        _close_scaled(g_, w_, torch.float32)


def test_smollm_train_step_card_matches_cpu(dev):
    """One loss-and-gradient step of a 2-layer smoke-size smollm-135m at
    2048 tokens from the same weights: the card (two banded flash launches
    a layer) against the CPU (plain versions), float32 with TF32 off."""
    cfg = dataclasses.replace(smoke_config("smollm-135m"), n_layers=2)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(1, 2048)))
    out = {}
    for device in (dev, torch.device("cpu")):
        before = ops.flash_attention_fwd.launches
        p = tree_map(lambda v: v.to(device), params)
        loss, _, grads = loss_and_grads(cfg, p, {"tokens": toks.to(device)})
        launched = ops.flash_attention_fwd.launches - before
        assert launched == (2 * cfg.n_layers if device.type == "cuda" else 0)
        out[device.type] = (float(loss), flatten(grads))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    for k, w_ in g_cpu.items():
        d = float((g_gpu[k].cpu() - w_).abs().max())
        assert d <= 1e-4 * float(w_.abs().max()), k
