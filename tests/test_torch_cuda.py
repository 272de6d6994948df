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
from repro_torch.kernels.diag_scan import (decode_fused_cuda, decode_layout,
                                          decode_grid_check,
                                          diag_scan_lanes_bwd_cuda,
                                          diag_scan_lanes_cuda)
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks, lm
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
    got = diag_scan_lanes_cuda(*lanes, chunks=chunks)
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
    h_re, h_im = diag_scan_lanes_cuda(a_re, a_im, *_split(x, cplx),
                                          h0_re, h0_im, chunks=chunks)
    g = torch.Generator().manual_seed(7)
    g_re = torch.randn(shape, generator=g, dtype=dtype).to(dev)
    g_im = torch.randn(shape, generator=g, dtype=dtype).to(dev) if cplx \
        else None
    args = (a_re, a_im, h_re, h_im, g_re, g_im, h0_re, h0_im)
    got = diag_scan_lanes_bwd_cuda(*args, chunks=chunks)
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
            r(*lead, d, nc, s=0.3),
            # past 8 outputs the feedback y . wy shrinks as 1 / D, so its
            # gain (~ scale x 2 sqrt(D)) stays below one
            r(*lead, d, d, s=0.2 if d <= 8 else 0.5 / d), r(*lead, d, s=0.1),
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
    if fb and d > 8:
        w_out[..., f - n - d:f - n, :] *= 8.0 / d   # and the feedback's

    def t(v):
        return torch.tensor(v, dtype=torch.float64, device=device)
    return (t(lam), nr, t(0.3 * rng.normal(size=lead + (d, n))), t(w_out),
            t(rng.normal(size=(b, n))), t(rng.normal(size=(b, d))))


# (B, NC, D): the main path's shape, small ones, the 16-slot arena, the
# served model at n = 2048 (1043 lanes), 4096 lanes and eight outputs.
DECODE_SHAPES = [(8, 525, 1), (3, 40, 2), (1, 700, 1), (16, 525, 1),
                 (8, 1043, 1), (4, 4096, 1), (4, 525, 8)]


def _decode_or_limit(ensemble, b, nc, d, batched, call):
    """``call()``, whose one launch is B2's streamed route exactly where
    ``decode_layout`` has no layout for the shape (it used to raise there,
    before any launch)."""
    streams = ops.decode_stream.launches
    try:
        decode_layout(b, nc, d, 8, ensemble=ensemble, batched=batched)
        streamed = 0
    except ValueError:
        streamed = 1
    out = call()
    assert ops.decode_stream.launches == streams + streamed
    return out


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
        decode_layout(8, 525, 1, 8, warps=warps)
    except ValueError:
        assert warps in (1, 32)
        with pytest.raises(ValueError, match=f"warps={warps} does not fit"):
            decode_fused_cuda(*args, mask, k=128, warps=warps)
        return
    got = decode_fused_cuda(*args, mask, k=128, warps=warps)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("batched", [False, True], ids=["shared", "per_slot"])
@pytest.mark.parametrize("b", [1, 3, 8, 16, 17, 32])
def test_decode_mean_cluster_matches_plain(dev, b, batched, d, dtype):
    """B2's ``mean`` route on its thread-block cluster (one block a row up
    to 16 rows, two from 17) against the plain version at 525 lanes, K =
    128, with row 1 frozen: one launch, the B2 tolerance (2e-4 in float32,
    1e-9 max(|ref|, 1) in float64), the frozen row's state and output
    kept, and every live row fed back the same y, bit for bit."""
    args = [v.to(dtype) for v in decode_inputs(b, 525, d, batched, dev)]
    mask = torch.arange(b, device=dev) != 1
    lay = decode_layout(b, 525, d, args[0].element_size(), ensemble="mean",
                        batched=batched)
    assert lay.cluster == -(-b // lay.rows) <= 16
    before = ops.decode_fused.launches
    got = ops.decode_fused(*args, mask, k=128, ensemble="mean")
    assert ops.decode_fused.launches == before + 1
    torch.cuda.synchronize()
    want = ref.decode_fused_ref(*args, mask, k=128, ensemble="mean")
    for g_, w_ in zip(got, want):
        assert bool(torch.isfinite(g_).all())
        _close_scaled(g_, w_, dtype)
    live = mask.nonzero()[:, 0]
    assert torch.equal(got[3][:, live], got[3][:, live[:1]].expand(
        -1, len(live), -1))
    assert torch.equal(got[2][live], got[2][live[:1]].expand(len(live), -1))
    if b > 1:
        assert torch.equal(got[0][1], args[2][1])
        assert torch.equal(got[3][:, 1], args[4][1].expand(128, d))


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "per_slot"])
@pytest.mark.parametrize("b", [64, 128])
def test_decode_mean_cluster_at_the_limit(dev, b, batched):
    """The rule's largest one-cluster ``mean`` layouts at n = 1024 (525
    float64 lanes): 64 rows at 4 a block and 128 at 8 a block (W = 2; 221
    KB of shared memory a block with per-slot operands), 16 blocks a
    cluster — the card holds the cluster (the launcher raises if it does
    not) and the kernel matches the plain version; 129 rows take a grid of
    nine clusters (one launch), and past the grid's limit (1056 rows) the
    shape takes B2's streamed route, still one launch."""
    args = decode_inputs(b, 525, 1, batched, dev)
    mask = torch.arange(b, device=dev) % 7 != 1
    lay = decode_layout(b, 525, 1, 8, ensemble="mean", batched=batched)
    assert (lay.cluster, lay.rows, lay.grid) == (16, b // 16, 1)
    got = ops.decode_fused(*args, mask, k=128, ensemble="mean")
    torch.cuda.synchronize()
    want = ref.decode_fused_ref(*args, mask, k=128, ensemble="mean")
    for g_, w_ in zip(got, want):
        _close(g_, w_)
    live = mask.nonzero()[:, 0]
    assert torch.equal(got[3][:, live], got[3][:, live[:1]].expand(
        -1, len(live), -1))
    more = decode_inputs(129, 525, 1, batched, dev)
    live = torch.ones(129, dtype=torch.bool, device=dev)
    assert decode_layout(129, 525, 1, 8, ensemble="mean",
                         batched=batched).grid == 9
    before = ops.decode_fused.launches
    got = ops.decode_fused(*more, live, k=8, ensemble="mean")
    assert ops.decode_fused.launches == before + 1
    want = ref.decode_fused_ref(*more, live, k=8, ensemble="mean")
    for g_, w_ in zip(got, want):
        _close(g_, w_)
    most = decode_inputs(1057, 525, 1, batched, dev)
    with pytest.raises(ValueError, match="B <= 1056 fits"):
        decode_layout(1057, 525, 1, 8, ensemble="mean", batched=batched)
    streams = ops.decode_stream.launches
    live = torch.ones(1057, dtype=torch.bool, device=dev)
    got = ops.decode_fused(*most, live, k=8, ensemble="mean")
    assert ops.decode_fused.launches == before + 2
    assert ops.decode_stream.launches == streams + 1
    want = ref.decode_fused_ref(*most, live, k=8, ensemble="mean")
    for g_, w_ in zip(got, want):
        _close(g_, w_)


# (B, NC, D) of the mean route past one cluster, float64 at n = 1024, 4096,
# 8192 (D = 2), 16384: a grid of G clusters that meet once a step (32 rows
# of 2074 lanes still fit one cluster).
GRID_SHAPES = [(129, 525, 1), (160, 525, 1), (256, 525, 1), (512, 525, 1),
               (17, 4133, 1), (9, 8244, 1), (32, 2074, 1), (32, 4133, 2),
               (32, 8244, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("batched", [False, True], ids=["shared", "per_slot"])
@pytest.mark.parametrize("b,nc,d", GRID_SHAPES)
def test_decode_mean_grid_matches_plain(dev, b, nc, d, batched, dtype):
    """B2's ``mean`` route on a grid of thread-block clusters, through both
    entries (split lanes, packed Q with its seeded mean), against the plain
    version at K = 128 with row 1 frozen: one launch a call, 2e-4 (float32)
    or 1e-9 (float64) of max(|ref|, 1), the frozen row's state and outputs
    kept, and every live row of every cluster fed back the same y, bit for
    bit; then no grid launch waited past its bound."""
    from repro_torch.kernels.diag_scan import decode_grid_check
    args = [v.to(dtype) for v in decode_inputs(b, nc, d, batched, dev)]
    nr = nc // 7
    packed = [v.to(dtype) if torch.is_tensor(v) else v
              for v in packed_inputs(b, nr, nc - nr, d, batched, dev)]
    lay = decode_layout(b, nc, d, args[0].element_size(), ensemble="mean",
                        batched=batched)
    assert lay.grid > 1 or (b, nc) == (32, 2074)
    mask = torch.arange(b, device=dev) != 1
    kw = dict(k=128, ensemble="mean")
    pkw = dict(kw, use_bias=True, use_feedback=True)
    before = ops.decode_fused.launches
    got = ops.decode_fused(*args, mask, **kw)
    pgot = ops.decode_fused_packed(*packed, mask, **pkw)
    assert ops.decode_fused.launches == before + 2
    torch.cuda.synchronize()
    decode_grid_check()
    want = ref.decode_fused_ref(*args, mask, **kw)
    pwant = ref.decode_fused_packed_ref(*packed, mask, **pkw)
    for g_, w_ in zip(got + pgot, want + pwant):
        assert bool(torch.isfinite(g_).all())
        _close_scaled(g_, w_, dtype)
    assert torch.equal(got[0][1], args[2][1])
    assert torch.equal(got[3][:, 1], args[4][1].expand(128, d))
    assert torch.equal(pgot[0][1], packed[4][1])
    live = mask.nonzero()[:, 0]
    for ys, y in ((got[3], got[2]), (pgot[2], pgot[1])):
        assert torch.equal(ys[:, live], ys[:, live[:1]].expand(
            -1, len(live), -1))
        assert torch.equal(y[live], y[live[:1]].expand(len(live), -1))


def test_decode_mean_grid_is_one_kernel_a_call(dev):
    """A grid call at 256 per-slot rows makes one kernel launch (beside a
    4-byte memset of its arrival counter), repeats bit for bit, and a grid
    whose clusters the card cannot hold at once is refused at launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import importlib
    dsk = importlib.import_module("repro_torch.kernels.diag_scan")
    args = decode_inputs(256, 525, 1, True, dev)
    mask = torch.ones(256, dtype=torch.bool, device=dev)
    first = ops.decode_fused(*args, mask, k=128, ensemble="mean")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = ops.decode_fused(*args, mask, k=128, ensemble="mean")
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [n for n in names if "decode_fused_kernel" in n]
    assert len(kernels) == 1, names
    assert all("decode_fused_kernel" in n or "emset" in n for n in names)
    for a_, b_ in zip(first, again):
        assert torch.equal(a_, b_)
    # 8 clusters of 16 blocks: one more than the card holds at once.
    lay = decode_layout(128, 525, 1, 8, ensemble="mean",
                        batched=True)._replace(grid=8)
    big = decode_inputs(1024, 525, 1, True, dev)
    with pytest.raises(RuntimeError, match="cannot hold this decode_fused "
                                           "grid"):
        dsk._decode_launch(torch.float64, lay, big[0].device,
                           *_fields(big, 1024, 525, 1, 128))
    dsk.decode_grid_check()


def _fields(args, b, nc, d, k):
    """``DecodeCall``'s fields up to ``seed_mean`` for split-lane operands
    (shared ``a``, per-slot weights), as ``decode_fused_cuda`` packs them
    at W = 2, 9 lanes a thread, every row live; the mask and outputs
    allocated here and kept alive in ``_fields.keep``."""
    a_re, a_im, h_re, h_im, y0, wd_re, wd_im, wy, b_out, wh_re, wh_im = args
    m = torch.ones(b, dtype=torch.bool, device=y0.device)
    out = [torch.empty_like(h_re), torch.empty_like(h_re),
           torch.empty_like(y0), y0.new_empty((k, b, d))]
    _fields.keep = (m, out)

    def p(v):
        return v.data_ptr()
    return (p(a_re), p(a_im), 0, p(h_re), p(h_im), nc, p(y0),
            p(wd_re), p(wd_im), wd_re[0].numel(), nc, p(wy), wy[0].numel(),
            p(b_out), b_out[0].numel(), p(wh_re), p(wh_im), wh_re[0].numel(),
            p(m), *(p(v) for v in out), b, nc, 0, 0, d, k, 2, 9, 1, 0)


# (B, NC, D) past one block: a row's lanes split over S blocks of one
# thread-block cluster (float64: S = 2, 2, 11 and 2; the served model at
# n = 16384 has 8244 lanes).
SPLIT_SHAPES = [(3, 4609, 1), (8, 8244, 1), (2, 8244, 8), (4, 2561, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("batched", [False, True], ids=["shared", "per_slot"])
@pytest.mark.parametrize("ensemble", ["off", "mean"])
@pytest.mark.parametrize("b,nc,d", SPLIT_SHAPES)
def test_decode_split_rows_match_plain(dev, b, nc, d, ensemble, batched,
                                       dtype):
    """B2 with a row's lanes split over a cluster, through both entries
    (split lanes, packed Q), against the plain version with row 1 frozen:
    one launch a call, 2e-4 (float32) or 1e-9 (float64) of max(|ref|, 1),
    the frozen row's state and outputs kept, and with ``mean`` every live
    row fed back the same y, bit for bit.  A ``mean`` shape whose B x S
    passes 16 blocks is refused before any launch."""
    args = [v.to(dtype) for v in decode_inputs(b, nc, d, batched, dev)]
    nr = nc // 7
    packed = [v.to(dtype) if torch.is_tensor(v) else v
              for v in packed_inputs(b, nr, nc - nr, d, batched, dev)]
    mask = torch.arange(b, device=dev) != 1
    kw = dict(k=128, ensemble=ensemble)
    pkw = dict(kw, use_bias=True, use_feedback=True)
    try:
        decode_layout(b, nc, d, args[0].element_size(), ensemble=ensemble,
                      batched=batched)
    except ValueError:
        assert ensemble == "mean"
        before = ops.decode_fused.launches
        with pytest.raises(ValueError, match="B x S <= 16"):
            ops.decode_fused(*args, mask, **kw)
        with pytest.raises(ValueError, match="B x S <= 16"):
            ops.decode_fused_packed(*packed, mask, **pkw)
        assert ops.decode_fused.launches == before
        return
    before = ops.decode_fused.launches
    got = ops.decode_fused(*args, mask, **kw)
    pgot = ops.decode_fused_packed(*packed, mask, **pkw)
    assert ops.decode_fused.launches == before + 2
    torch.cuda.synchronize()
    want = ref.decode_fused_ref(*args, mask, **kw)
    pwant = ref.decode_fused_packed_ref(*packed, mask, **pkw)
    for g_, w_ in zip(got + pgot, want + pwant):
        assert bool(torch.isfinite(g_).all())
        _close_scaled(g_, w_, dtype)
    assert torch.equal(got[0][1], args[2][1])
    assert torch.equal(got[3][:, 1], args[4][1].expand(128, d))
    assert torch.equal(pgot[0][1], packed[4][1])
    if ensemble == "mean":
        live = mask.nonzero()[:, 0]
        for ys in (got[3], pgot[2]):
            assert torch.equal(ys[:, live], ys[:, live[:1]].expand(
                -1, len(live), -1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_decode_split_row_bits_independent_of_arena(dev, dtype):
    """ensemble="off" with a row split over two blocks (8244 lanes): a
    row's bits are the same alone and among 8 rows, whatever the other
    rows hold; two runs are bit-identical."""
    lam, nr, w_drive, w_out, states, y_prev = [
        v.to(dtype) if torch.is_tensor(v) else v
        for v in packed_inputs(8, 1177, 7067, 1, False, dev)]
    assert decode_layout(8, 8244, 1, lam.element_size()).segs > 1 or \
        dtype == torch.float32
    mask = torch.ones(8, dtype=torch.bool, device=dev)
    kw = dict(k=128, use_bias=True, use_feedback=True)
    full = ops.decode_fused_packed(lam, nr, w_drive, w_out, states, y_prev,
                                   mask, **kw)
    again = ops.decode_fused_packed(lam, nr, w_drive, w_out, states, y_prev,
                                    mask, **kw)
    for a_, b_ in zip(full, again):
        assert torch.equal(a_, b_)
    one = ops.decode_fused_packed(lam, nr, w_drive, w_out, states[5:6],
                                  y_prev[5:6], mask[5:6], **kw)
    other = states.clone()
    other[:5] = torch.randn_like(other[:5])
    other[6:] *= -3.0
    moved = ops.decode_fused_packed(lam, nr, w_drive, w_out, other, y_prev,
                                    mask, **kw)
    for got in (one, moved):
        row = 0 if got is one else 5
        assert torch.equal(got[0][row], full[0][5])
        assert torch.equal(got[1][row], full[1][5])
        assert torch.equal(got[2][:, row], full[2][:, 5])


@pytest.mark.parametrize("segs", [2, 4, 12])
@pytest.mark.parametrize("ensemble", ["off", "mean"])
def test_decode_split_blocks_feed_back_one_y(dev, ensemble, segs):
    """Every block of a split row drives its lanes with the same y: the
    row's S segments hold copies of one segment's lanes (a, wd, h), so
    with one y fed back in every block they end bit-equal, though each
    block sums the exchanged partials itself."""
    nc = 8244                           # 2 x 4122, 4 x 2061, 12 x 687
    args = decode_inputs(2, nc, 1, False, dev)
    seg = nc // segs
    for i in (0, 1, 2, 3, 5, 6):
        v = args[i]
        for s_ in range(1, segs):
            v[..., s_ * seg:(s_ + 1) * seg] = v[..., :seg]
    mask = torch.ones(2, dtype=torch.bool, device=dev)
    if ensemble == "mean" and 2 * segs > 16:
        with pytest.raises(ValueError, match=f"segs={segs} does not fit"):
            decode_fused_cuda(*args, mask, k=128, ensemble=ensemble,
                              segs=segs)
        return
    assert decode_layout(2, nc, 1, 8, ensemble=ensemble,
                         segs=segs).cluster == (2 * segs if ensemble == "mean"
                                                else segs)
    got = decode_fused_cuda(*args, mask, k=128, ensemble=ensemble, segs=segs)
    torch.cuda.synchronize()
    for s_ in range(1, segs):
        assert torch.equal(got[0][:, s_ * seg:(s_ + 1) * seg],
                           got[0][:, :seg])
        assert torch.equal(got[1][:, s_ * seg:(s_ + 1) * seg],
                           got[1][:, :seg])
    want = ref.decode_fused_ref(*args, mask, k=128, ensemble=ensemble)
    for g_, w_ in zip(got, want):
        _close(g_, w_)


# (B, NC, D, ensemble) past 8 outputs, through the wide family: n = 1024
# (525 lanes) at D = 16, 64 and 128, n = 8192 (4133 lanes) and n = 2048
# (1037 lanes) off; 16 members at n = 1024 and 8 at n = 4096 (2074 lanes)
# mean, each row split over a cluster of a grid.
WIDE_SHAPES = [(8, 525, 16, "off"), (8, 525, 64, "off"), (8, 525, 128, "off"),
               (8, 4133, 16, "off"), (8, 1037, 64, "off"),
               (16, 525, 64, "mean"), (8, 2074, 16, "mean")]


def _cuda_kernels(fn, windows=5, kernel="decode_fused_kernel"):
    """The names of the CUDA kernels one call of ``fn`` launches: the
    fullest of up to ``windows`` profiler windows (the tracer can drop a
    window's events, never add any: ``chip_smoke.py::device_kernels``),
    taken until one holds ``kernel`` (B2's by default)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    best = []
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if len(names) > len(best):
            best = names
        if any(kernel in n for n in best):
            break
    return best


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("batched", [False, True], ids=["shared", "per_slot"])
@pytest.mark.parametrize("b,nc,d,ensemble", WIDE_SHAPES)
def test_decode_wide_d_matches_plain(dev, b, nc, d, ensemble, batched,
                                     dtype):
    """B2 past 8 outputs (the wide family), through both entries, against
    the plain version with row 1 frozen: one kernel a call (beside a grid's
    4-byte memset), 2e-4 (float32) or 1e-9 (float64) of max(|ref|, 1), the
    frozen row's state and outputs kept, and with ``mean`` every live row
    fed back the same y, bit for bit."""
    args = [v.to(dtype) for v in decode_inputs(b, nc, d, batched, dev)]
    nr = nc // 7
    packed = [v.to(dtype) if torch.is_tensor(v) else v
              for v in packed_inputs(b, nr, nc - nr, d, batched, dev)]
    lay = decode_layout(b, nc, d, args[0].element_size(), ensemble=ensemble,
                        batched=batched)
    assert lay.wide
    mask = torch.arange(b, device=dev) != 1
    kw = dict(k=128, ensemble=ensemble)
    pkw = dict(kw, use_bias=True, use_feedback=True)
    before = ops.decode_fused.launches
    got = ops.decode_fused(*args, mask, **kw)
    pgot = ops.decode_fused_packed(*packed, mask, **pkw)
    assert ops.decode_fused.launches == before + 2
    torch.cuda.synchronize()
    decode_grid_check()
    for fn in (lambda: ops.decode_fused(*args, mask, **kw),
               lambda: ops.decode_fused_packed(*packed, mask, **pkw)):
        names = _cuda_kernels(fn)
        assert [n for n in names if "decode_fused_kernel" in n] == \
            [n for n in names if "emset" not in n], names
        assert sum("decode_fused_kernel" in n for n in names) == 1, names
    want = ref.decode_fused_ref(*args, mask, **kw)
    pwant = ref.decode_fused_packed_ref(*packed, mask, **pkw)
    for g_, w_ in zip(got + pgot, want + pwant):
        assert bool(torch.isfinite(g_).all())
        _close_scaled(g_, w_, dtype)
    assert torch.equal(got[0][1], args[2][1])
    assert torch.equal(got[3][:, 1], args[4][1].expand(128, d))
    assert torch.equal(pgot[0][1], packed[4][1])
    assert torch.equal(pgot[2][:, 1], packed[5][1].expand(128, d))
    if ensemble == "mean":
        live = mask.nonzero()[:, 0]
        for ys in (got[3], pgot[2]):
            assert torch.equal(ys[:, live], ys[:, live[:1]].expand(
                -1, len(live), -1))


@pytest.mark.parametrize("d", [16, 64])
def test_decode_wide_row_bits_independent_of_arena(dev, d):
    """``off`` past 8 outputs (a row split over a cluster): a row's bits
    are the same alone and among 8 rows, whatever the other rows hold; two
    runs are bit-identical."""
    lam, nr, w_drive, w_out, states, y_prev = packed_inputs(
        8, 75, 450, d, False, dev)                      # 525 lanes
    assert decode_layout(8, 525, d, 8).segs > 1
    mask = torch.ones(8, dtype=torch.bool, device=dev)
    kw = dict(k=128, use_bias=True, use_feedback=True)
    full = ops.decode_fused_packed(lam, nr, w_drive, w_out, states, y_prev,
                                   mask, **kw)
    again = ops.decode_fused_packed(lam, nr, w_drive, w_out, states, y_prev,
                                    mask, **kw)
    for a_, b_ in zip(full, again):
        assert torch.equal(a_, b_)
    one = ops.decode_fused_packed(lam, nr, w_drive, w_out, states[5:6],
                                  y_prev[5:6], mask[5:6], **kw)
    other = states.clone()
    other[:5] = torch.randn_like(other[:5])
    other[6:] *= -3.0
    moved = ops.decode_fused_packed(lam, nr, w_drive, w_out, other, y_prev,
                                    mask, **kw)
    for got, row in ((one, 0), (moved, 5)):
        assert torch.equal(got[0][row], full[0][5])
        assert torch.equal(got[1][row], full[1][5])
        assert torch.equal(got[2][:, row], full[2][:, 5])


@pytest.mark.parametrize("ensemble", ["off", "mean"])
def test_decode_wide_family_at_two_outputs(dev, ensemble):
    """The wide family forced at D = 2 (``wide=True``; the rule keeps the
    DM = 8 family there) agrees with the plain version and with the DM = 8
    family at 1e-9 of max(|ref|, 1)."""
    args = decode_inputs(8, 2074, 2, False, dev)
    mask = torch.arange(8, device=dev) != 1
    kw = dict(k=128, ensemble=ensemble)
    assert decode_layout(8, 2074, 2, 8, ensemble=ensemble, wide=True).wide
    assert not decode_layout(8, 2074, 2, 8, ensemble=ensemble).wide
    got = decode_fused_cuda(*args, mask, wide=True, **kw)
    narrow = decode_fused_cuda(*args, mask, **kw)
    want = ref.decode_fused_ref(*args, mask, **kw)
    for g_, n_, w_ in zip(got, narrow, want):
        _close_scaled(g_, w_, torch.float64)
        _close_scaled(g_, n_, torch.float64)


def test_decode_past_the_wide_limits_raises_before_a_launch(dev):
    """Past the wide family's limits ``decode_layout`` raises, naming them,
    before a launch (D = 129, and ``off`` rows too wide for a cluster);
    the call then runs B2's streamed route (it used to raise there): one
    launch, against the plain version."""
    for b, nc, d, match in ((2, 64, 129, "1 <= D <= 128"),
                            (2, 4133, 64, "NC <= ")):
        with pytest.raises(ValueError, match=match):
            decode_layout(b, nc, d, 8)
        args = decode_inputs(b, nc, d, False, dev)
        mask = torch.ones(b, dtype=torch.bool, device=dev)
        before = (ops.decode_fused.launches, ops.decode_stream.launches)
        got = ops.decode_fused(*args, mask, k=4)
        assert (ops.decode_fused.launches, ops.decode_stream.launches) == (
            before[0] + 1, before[1] + 1)
        for g_, w_ in zip(got, ref.decode_fused_ref(*args, mask, k=4)):
            _close_scaled(g_, w_, torch.float64)


# (B, NC, D, ensemble, per-slot, dtype) of B2's streamed route
# (``csrc/decode_stream.cu``): main path 23 (n = 5000, 2562 lanes, D = 64;
# float32 fits a wide-family layout, so the route is forced there), a
# 16-member mean arena of it, D = 256, 80000 lanes, and 1100 mean members
# (past the grid's 1056).
STREAM_SHAPES = [(8, 2562, 64, "off", False, torch.float64),
                 (8, 2562, 64, "off", True, torch.float64),
                 (8, 2562, 64, "off", False, torch.float32),
                 (8, 2562, 64, "off", True, torch.float32),
                 (16, 2562, 64, "mean", True, torch.float64),
                 (8, 525, 256, "off", False, torch.float64),
                 (2, 80000, 1, "off", False, torch.float64),
                 (1100, 525, 1, "mean", True, torch.float64)]


def _stream_ids(case):
    b, nc, d, ensemble, batched, dtype = case
    return (f"{ensemble}-{'per_slot' if batched else 'shared'}-B{b}-NC{nc}-"
            f"D{d}-{'f64' if dtype == torch.float64 else 'f32'}")


@pytest.mark.parametrize("case", STREAM_SHAPES, ids=_stream_ids)
def test_decode_stream_matches_plain(dev, case):
    """B2's streamed route through both entries, one launch a call, against
    the plain version with row 1 frozen (its state and outputs kept): 1e-9
    (float64) or 2e-4 (float32) of max(|ref|, 1); with ``mean`` every live
    row fed back the same y, bit for bit.  Where ``decode_layout`` has no
    layout, ``ops.decode_fused`` takes the route by itself."""
    b, nc, d, ensemble, batched, dtype = case
    import importlib
    dsk = importlib.import_module("repro_torch.kernels.diag_scan")
    args = [v.to(dtype) for v in decode_inputs(b, nc, d, batched, dev)]
    nr = nc // 7
    packed = [v.to(dtype) if torch.is_tensor(v) else v
              for v in packed_inputs(b, nr, nc - nr, d, batched, dev)]
    itemsize = args[0].element_size()
    assert dsk.decode_plan(b, nc, d, itemsize, ensemble=ensemble,
                           batched=batched).streamed == (dtype == torch.float64)
    mask = torch.arange(b, device=dev) != 1
    kw = dict(k=128, ensemble=ensemble)
    pkw = dict(kw, use_bias=True, use_feedback=True)
    before = (ops.decode_fused.launches, ops.decode_stream.launches)
    got = ops.decode_stream(*args, mask, **kw)
    pgot = dsk.decode_fused_packed_cuda(*packed, mask, **pkw, stream=True)
    assert (ops.decode_fused.launches, ops.decode_stream.launches) == (
        before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    decode_grid_check()
    if dtype == torch.float64:
        again = ops.decode_fused(*args, mask, **kw)
        assert ops.decode_stream.launches == before[1] + 2
        for a_, b_ in zip(got, again):
            assert torch.equal(a_, b_)
    names = _cuda_kernels(lambda: ops.decode_stream(*args, mask, **kw),
                          kernel="decode_stream_kernel")
    assert sum("decode_stream_kernel" in n for n in names) == 1, names
    assert all("decode_stream_kernel" in n or "emset" in n for n in names)
    want = ref.decode_fused_ref(*args, mask, **kw)
    pwant = ref.decode_fused_packed_ref(*packed, mask, **pkw)
    for g_, w_ in zip(got + pgot, want + pwant):
        assert bool(torch.isfinite(g_).all())
        _close_scaled(g_, w_, dtype)
    assert torch.equal(got[0][1], args[2][1])
    assert torch.equal(got[1][1], args[3][1])
    assert torch.equal(got[3][:, 1], args[4][1].expand(128, d))
    assert torch.equal(pgot[0][1], packed[4][1])
    assert torch.equal(pgot[2][:, 1], packed[5][1].expand(128, d))
    if ensemble == "mean":
        live = mask.nonzero()[:, 0]
        for ys in (got[3], pgot[2]):
            assert torch.equal(ys[:, live], ys[:, live[:1]].expand(
                -1, len(live), -1))


@pytest.mark.parametrize("ensemble", ["off", "mean"])
@pytest.mark.parametrize("k", [0, 1])
def test_decode_stream_short_waves(dev, ensemble, k):
    """K = 0 (the state and y copied through; the packed mean entry's y the
    seed) and K = 1 on the streamed route, both entries, against the plain
    version; repeats bit for bit."""
    import importlib
    dsk = importlib.import_module("repro_torch.kernels.diag_scan")
    b, nc, d = 8, 2562, 64
    args = decode_inputs(b, nc, d, ensemble == "mean", dev)
    packed = packed_inputs(b, nc // 7, nc - nc // 7, d, False, dev)
    mask = torch.arange(b, device=dev) % 3 != 1
    kw = dict(k=k, ensemble=ensemble)
    pkw = dict(kw, use_bias=True, use_feedback=True)
    got = dsk.decode_fused_cuda(*args, mask, **kw, stream=True)
    pgot = dsk.decode_fused_packed_cuda(*packed, mask, **pkw, stream=True)
    assert got[3].shape == (k, b, d) and pgot[2].shape == (k, b, d)
    for g_, w_ in zip(got + pgot, ref.decode_fused_ref(*args, mask, **kw)
                      + ref.decode_fused_packed_ref(*packed, mask, **pkw)):
        _close_scaled(g_, w_, torch.float64)
    for a_, b_ in zip(got, dsk.decode_fused_cuda(*args, mask, **kw,
                                                  stream=True)):
        assert torch.equal(a_, b_)
    if k == 0:
        assert torch.equal(got[0], args[2]) and torch.equal(got[2], args[4])


def test_decode_stream_past_the_card_raises(dev):
    """A streamed grid of more blocks than the card holds at once is
    refused at launch (code 10001), without hanging; the next launch
    runs."""
    import importlib
    dsk = importlib.import_module("repro_torch.kernels.diag_scan")
    args = decode_inputs(2, 80000, 1, False, dev)
    mask = torch.ones(2, dtype=torch.bool, device=dev)
    lay = dsk.decode_stream_layout(2, 80000, 1, 8, segs=1000)
    assert lay.blocks == 1000
    with pytest.raises(RuntimeError, match="error 10001"):
        dsk.decode_fused_cuda(*args, mask, k=4, stream=lay)
    got = dsk.decode_fused_cuda(*args, mask, k=4, stream=True)
    torch.cuda.synchronize()
    decode_grid_check()
    for g_, w_ in zip(got, ref.decode_fused_ref(*args, mask, k=4)):
        _close_scaled(g_, w_, torch.float64)


# (B, NC, D, ensemble, per-slot, dtype, mode) of B2's streamed route in
# each mode, forced: path 23's shape (shared float64: resident by the
# rule, streamed forced; per-slot float64 streamed; per-slot float32
# resident), 16 per-slot mean members (streamed only), D = 256, 80000
# lanes, 1100 mean members, and smaller shapes: two row tiles of shared
# weights (1100 rows, 9 a block), a mean past 8 outputs, and 264 per-slot
# mean members of 6200 lanes, whose state does not fit a block (it rides
# in the ring); the direct mode forced at path 23's shape and at small
# ones; and the rule's layouts where the rows' y does not fit a block's
# shared memory (STREAM_GLOBAL_Y: D = 1500, 16384 mean members at D =
# 100) or not one lane's operands fit a ring tile (D = 5000, direct).
STREAM_GLOBAL_Y = [(8, 525, 1500), (16384, 64, 100), (8, 525, 5000)]
STREAM_MODE_CASES = [
    (8, 2562, 64, "off", False, torch.float64, "resident"),
    (8, 2562, 64, "off", False, torch.float64, "streamed"),
    (8, 2562, 64, "off", True, torch.float64, "streamed"),
    (8, 2562, 64, "off", True, torch.float32, "resident"),
    (8, 2562, 64, "off", True, torch.float32, "streamed"),
    (16, 2562, 64, "mean", True, torch.float64, "streamed"),
    (8, 525, 256, "off", False, torch.float64, "resident"),
    (8, 525, 256, "off", False, torch.float64, "streamed"),
    (2, 80000, 1, "off", False, torch.float64, "resident"),
    (2, 80000, 1, "off", False, torch.float64, "streamed"),
    (1100, 525, 1, "mean", True, torch.float64, "streamed"),
    (1100, 60, 2, "off", False, torch.float64, "resident"),
    (1100, 60, 2, "off", False, torch.float64, "streamed"),
    (5, 700, 12, "mean", True, torch.float64, "resident"),
    (5, 700, 12, "mean", True, torch.float32, "streamed"),
    (264, 6200, 1, "mean", True, torch.float64, "streamed"),
    (8, 2562, 64, "off", False, torch.float64, "direct"),
    (8, 2562, 64, "off", True, torch.float32, "direct"),
    (1100, 60, 2, "off", False, torch.float64, "direct"),
    (5, 700, 12, "mean", True, torch.float64, "direct"),
    (264, 6200, 1, "mean", True, torch.float64, "direct"),
    (8, 525, 1500, "off", False, torch.float64, "resident"),
    (16384, 64, 100, "mean", False, torch.float64, "streamed"),
    (8, 525, 5000, "off", False, torch.float64, "direct")]


@pytest.mark.parametrize("case", STREAM_MODE_CASES, ids=lambda c: (
    _stream_ids(c[:6]) + "-" + c[6]))
def test_decode_stream_modes(dev, case):
    """Each mode of B2's streamed route, forced, and the rule's layouts
    where the rows' y lives in the global scratch, through both entries
    against the plain version at K = 0, 1, 5 and 128 with row 1 frozen
    (its state and outputs kept); with ``mean`` every live row fed back the
    same y, bit for bit; one and two rounds of the exchange give the same
    bits; one ``decode_stream_kernel`` launch a call."""
    b, nc, d, ensemble, batched, dtype, mode = case
    import importlib
    dsk = importlib.import_module("repro_torch.kernels.diag_scan")
    args = [v.to(dtype) for v in decode_inputs(b, nc, d, batched, dev)]
    nr = nc // 7
    packed = [v.to(dtype) if torch.is_tensor(v) else v
              for v in packed_inputs(b, nr, nc - nr, d, batched, dev)]
    itemsize = args[0].element_size()
    lay = dsk.decode_stream_layout(b, nc, d, itemsize, ensemble=ensemble,
                                   batched=batched, mode=mode)
    assert lay.mode == mode
    if b == 264 and mode == "streamed":
        assert not lay.state_on_chip
    if (b, nc, d) in STREAM_GLOBAL_Y:
        assert not lay.y_on_chip
        assert lay == dsk.decode_stream_layout(b, nc, d, itemsize,
                                               ensemble=ensemble,
                                               batched=batched)
    mask = torch.arange(b, device=dev) != 1
    for k in (0, 1, 5, 128):
        kw = dict(k=k, ensemble=ensemble)
        pkw = dict(kw, use_bias=True, use_feedback=True)
        got = dsk.decode_fused_cuda(*args, mask, **kw, stream=lay)
        pgot = dsk.decode_fused_packed_cuda(*packed, mask, **pkw, stream=lay)
        for g_, w_ in zip(got + pgot, ref.decode_fused_ref(*args, mask, **kw)
                          + ref.decode_fused_packed_ref(*packed, mask, **pkw)):
            assert bool(torch.isfinite(g_).all())
            _close_scaled(g_, w_, dtype)
        assert torch.equal(got[0][1], args[2][1])
        assert torch.equal(got[2][1], args[4][1])
        assert torch.equal(got[3][:, 1], args[4][1].expand(k, d))
        assert torch.equal(pgot[0][1], packed[4][1])
        if ensemble == "mean" and k:
            live = mask.nonzero()[:, 0]
            for ys in (got[3], pgot[2]):
                assert torch.equal(ys[:, live], ys[:, live[:1]].expand(
                    -1, len(live), -1))
        if k == 5:
            other = dsk.decode_stream_layout(
                b, nc, d, itemsize, ensemble=ensemble, batched=batched,
                mode=mode, rounds=3 - lay.rounds)
            for a_, b_ in zip(got, dsk.decode_fused_cuda(*args, mask, **kw,
                                                          stream=other)):
                assert torch.equal(a_, b_)
    torch.cuda.synchronize()
    decode_grid_check()
    names = _cuda_kernels(lambda: dsk.decode_fused_cuda(
        *args, mask, k=4, ensemble=ensemble, stream=lay),
        kernel="decode_stream_kernel")
    assert sum("decode_stream_kernel" in n for n in names) == 1, names
    assert all("decode_stream_kernel" in n or "emset" in n for n in names)


def test_decode_stream_refuses_a_layout_off_its_plan(dev):
    """The entry refuses, before a launch, a layout whose shared memory is
    not its plan's or whose segments leave one empty, and a resident
    layout forced where the share does not fit raises in the rule; the
    next launch runs."""
    import importlib
    dsk = importlib.import_module("repro_torch.kernels.diag_scan")
    args = decode_inputs(8, 2562, 64, True, dev)
    mask = torch.ones(8, dtype=torch.bool, device=dev)
    lay = dsk.decode_stream_layout(8, 2562, 64, 8, batched=True)
    for bad in (lay._replace(smem=lay.smem + 8),
                lay._replace(segs=lay.segs + 1, blocks=lay.blocks + 8)):
        with pytest.raises(RuntimeError, match="error 1 "):
            dsk.decode_fused_cuda(*args, mask, k=4, stream=bad)
    with pytest.raises(ValueError, match="resident mode needs"):
        dsk.decode_stream_layout(8, 2562, 64, 8, batched=True,
                                 mode="resident")
    got = dsk.decode_fused_cuda(*args, mask, k=4, stream=lay)
    torch.cuda.synchronize()
    decode_grid_check()
    for g_, w_ in zip(got, ref.decode_fused_ref(*args, mask, k=4)):
        _close_scaled(g_, w_, torch.float64)


def test_engine_past_128_outputs_streams(dev):
    """An engine of 136 outputs fed back (past the wide family's D <= 128):
    every decode wave one launch of B2's streamed route, the streams
    within 1e-9 x max(|ref|, 1) of the CPU engine's."""
    d, n, t = 136, 48, 600
    sig = np.stack([mso_series(1 + i % 12, t + i)[i:] for i in range(d)], -1)
    cfg = ESNConfig(n=n, d_in=d, d_out=d, leak=0.9, input_scaling=0.5,
                    use_feedback=True, feedback_scaling=0.3, seed=4)
    p = esn.dpg_params(cfg, sigma=0.1, device="cpu")
    ro = esn.fit(p, sig[:-1], sig[1:], washout=100)

    def run(device):
        eng = ReservoirEngine(p, 4, readout=ro, device=device)
        for i in range(4):
            eng.submit(i, sig[37 * i:37 * i + 60],
                       y_teacher=sig[37 * i + 1:37 * i + 61])
        eng.flush()
        ys = eng.decode_closed_loop(16)
        return ([ys[s_] for s_ in sorted(ys)], eng.stats().decode_waves_by_route)
    before = ops.decode_stream.launches
    card, routes = run("cuda")
    assert ops.decode_stream.launches == before + 1
    assert routes["fused"] == 1 and routes["step"] == 0
    cpu, _ = run("cpu")
    for g_, w_ in zip(card, cpu):
        _close_scaled(torch.as_tensor(g_), torch.as_tensor(w_), torch.float64)


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
    got = diag_scan_lanes_cuda(*lanes, chunks=chunks)
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

    def readout(i, p):
        try:
            return esn.fit(p, sig[:-1, None], sig[1:, None],
                           washout=100).w_out
        except torch.linalg.LinAlgError:
            # ROADMAP C12 (seeds 53 and 109 of the first 130 at n = 1024):
            # a zero readout, so the member runs but votes 0.
            return torch.zeros((p.cfg.n_features, 1), dtype=torch.float64)
    w = torch.stack([readout(i, p) for i, p in enumerate(ps)])
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
    """B2's mean route spreads the rows over one thread-block cluster, so
    16 and 32 per-slot rows of 525 float64 lanes decode on it: the engine
    decodes each wave with ONE B2 launch, counts it under ``fused`` and
    holds against the CPU engine, elementwise at 1e-9 max(|ref|, 1); 8
    slots likewise."""
    for slots in (16, 32, 8):
        params, ro, sig = _ensemble(slots, 1024)
        outs = {}
        for device in (dev, torch.device("cpu")):
            eng = ReservoirEngine.from_param_batch(params, ro,
                                                   ensemble="mean",
                                                   device=device)
            for i in range(slots):
                eng.submit(i, sig[8 * i:8 * i + 256, None])
            eng.flush()
            before = ops.decode_fused.launches
            ys = eng.decode_closed_loop(8)
            outs[device.type] = ([ys[i].cpu() for i in range(slots)]
                                 + [eng.states.cpu(), eng.y_prev.cpu()],
                                 ops.decode_fused.launches - before,
                                 eng.stats().decode_waves_by_route)
        assert outs["cuda"][1] == 1, slots
        assert outs["cuda"][2] == {"fused": 1, "step": 0}, slots
        assert outs["cpu"][2] == {"fused": 1, "step": 0}, slots
        for g_, w_ in zip(outs["cuda"][0], outs["cpu"][0]):
            assert bool(torch.isfinite(g_).all())
            _close(g_, w_)
            g_, w_ = g_.cpu(), w_.cpu()
            assert bool(((g_ - w_).abs()
                         <= 1e-9 * w_.abs().clamp(min=1.0)).all()), slots


def test_mean_ensemble_past_one_cluster_is_one_launch_a_wave(dev):
    """130 per-slot members of 525 float64 lanes, two more than one
    thread-block cluster holds: the engine decodes each wave with ONE B2
    launch on a grid of nine clusters, counts it under ``fused`` and holds
    against the CPU engine elementwise at 1e-9 max(|ref|, 1)."""
    from repro_torch.kernels.diag_scan import decode_grid_check
    slots = 130
    params, ro, sig = _ensemble(slots, 1024)
    assert decode_layout(slots, 525, 1, 8, ensemble="mean",
                         batched=True).grid == 9
    outs = {}
    for device in (dev, torch.device("cpu")):
        eng = ReservoirEngine.from_param_batch(params, ro, ensemble="mean",
                                               device=device)
        for i in range(slots):
            eng.submit(i, sig[8 * i:8 * i + 256, None])
        eng.flush()
        before = ops.decode_fused.launches
        ys = eng.decode_closed_loop(8)
        outs[device.type] = ([ys[i].cpu() for i in range(slots)]
                             + [eng.states.cpu(), eng.y_prev.cpu()],
                             ops.decode_fused.launches - before,
                             eng.stats().decode_waves_by_route)
    decode_grid_check()
    assert outs["cuda"][1] == 1
    assert outs["cuda"][2] == {"fused": 1, "step": 0}
    for g_, w_ in zip(outs["cuda"][0], outs["cpu"][0]):
        assert bool(torch.isfinite(g_).all())
        assert bool(((g_ - w_).abs() <= 1e-9 * w_.abs().clamp(min=1.0)).all())


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
    wide = torch.zeros((1, 1, 4, 288), device=dev)
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


# ------------------------------------------------------------------ paging
def _paged_model(n=64, seed=3):
    cfg = ESNConfig(n=n, spectral_radius=0.9, leak=0.8, input_scaling=0.5,
                    ridge_alpha=1e-8, seed=seed)
    sig = mso_series(3, 1401)
    p = esn.dpg_params(cfg, "noisy_golden", sigma=0.1, device="cpu")
    return p, esn.fit(p, sig[:-1, None], sig[1:, None], washout=50), sig


def test_paging_stages_through_one_pinned_buffer(dev):
    """On a card engine the page waves' one page-locked buffer is the exec
    plane's staging rows (``max_slots`` of them); the store's pool stays
    pageable numpy.  A demote and a promote through the staging rows move
    a session's state bit for bit."""
    p, ro, sig = _paged_model()
    eng = ReservoirEngine(p, 2, readout=ro, park_host_rows=3, device=dev)
    assert all(t.is_pinned() and t.shape[0] == 2 for t in eng._exec._stage)
    assert type(eng.store.pool.states) is np.ndarray
    for i in range(2):
        eng.submit(f"s{i}", sig[40 * i:40 * i + 64, None])
    eng.flush()
    before = {s: eng.state_of(s) for s in ("s0", "s1")}
    eng.submit("s2", sig[100:164, None])
    eng.flush()
    (sid,) = eng.parked_sessions
    assert np.array_equal(eng.state_of(sid), before[sid])
    eng._exec._ensure_hot([sid])               # the decode path's promote
    assert sid not in eng.parked_sessions
    assert np.array_equal(eng.state_of(sid), before[sid])
    assert eng.stats().promote_waves == 1


def test_paged_engine_on_card_bit_equal_to_unpaged(dev):
    """A 4-slot paged engine serving 16 sessions through a 6-row pool and a
    cold dir: its decoded tokens equal the caller-managed release /
    resubmit workflow on an unpaged 4-slot engine on the card, bit for
    bit, and its parked states the ones that workflow releases."""
    import tempfile
    p, ro, sig = _paged_model()
    prompts = {f"s{i}": sig[40 + 9 * i:40 + 9 * i + 64, None]
               for i in range(16)}
    groups = [list(prompts)[i:i + 4] for i in range(0, 16, 4)]
    eng = ReservoirEngine(p, 4, readout=ro, park_host_rows=6, device=dev,
                          cold_dir=tempfile.mkdtemp(prefix="card_paged_"))
    ref = ReservoirEngine(p, 4, readout=ro, device=dev)
    for sid, u in prompts.items():
        eng.submit(sid, u)
    eng.flush()
    assert {eng.store.tier_of(s) for s in eng.store.sids} == {"host", "cold"}
    parked = {}
    for grp in groups:
        for sid in grp:
            ref.submit(sid, prompts[sid])
        ref.flush()
        for sid in grp:
            parked[sid] = tuple(ref.release(sid))
    for sid in eng.parked_sessions:
        assert np.array_equal(eng.state_of(sid), parked[sid][0].cpu().numpy())
    for _ in range(2):
        for grp in groups:
            got = eng.decode_closed_loop(8, sids=grp)
            for sid in grp:
                ref.submit(sid, h0=parked[sid][0], y0=parked[sid][1])
            ref.flush()
            want = ref.decode_closed_loop(8, sids=grp)
            for sid in grp:
                assert torch.equal(got[sid], want[sid])
                parked[sid] = tuple(ref.release(sid))
    st = eng.stats()
    assert st.promote_waves > 0 and st.demote_waves > 0


def test_overlap_demote_fast_path_on_card_bit_equal_to_sync(dev):
    """The overlap churn on the card (32 slots, 64 pool rows, a cold dir,
    16 rounds of 8 fresh prompts): the pipelined engine takes the side-
    stream fast path and its tokens and states equal the synchronous
    engine's, bit for bit."""
    import tempfile
    p, ro, sig = _paged_model()
    prompts = [sig[20 * i:20 * i + 64, None] for i in range(24)]
    outs = {}
    for depth in (2, 0):
        eng = ReservoirEngine(p, 32, readout=ro, park_host_rows=64,
                              pipeline_depth=depth, device=dev,
                              cold_dir=tempfile.mkdtemp(prefix="card_ov_"))
        toks = {}
        for r in range(16):
            for i in range(8):
                eng.submit((r, i), prompts[(r * 8 + i) % 24])
            eng.flush()
            if r % 4 == 3:
                eng.decode_closed_loop(4, sids=[(r, i) for i in range(8)])
                toks.update(eng.collect_decoded().tokens)
        states = {(r, i): eng.state_of((r, i)) for r in range(16)
                  for i in range(8)}
        outs[depth] = (toks, states, eng.stats())
    (ta, sa, st), (tb, sb, _) = outs[2], outs[0]
    assert st.overlap_demotes > 0
    assert ta.keys() == tb.keys()
    for sid in ta:
        assert torch.equal(ta[sid], tb[sid])
    for sid in sa:
        assert np.array_equal(sa[sid], sb[sid])


def test_cpu_snapshot_restores_on_card(dev):
    """An engine snapshotted on the CPU mid-workload (hot and parked
    sessions in both tiers, a queued prompt, uncollected tokens) restores
    on the card and continues to match the CPU continuation."""
    import tempfile
    p, ro, sig = _paged_model()
    cpu = ReservoirEngine(p, 3, readout=ro, park_host_rows=4, device="cpu",
                          cold_dir=tempfile.mkdtemp(prefix="card_snap_"))
    sids = [f"s{i}" for i in range(10)]
    for i, sid in enumerate(sids):
        cpu.submit(sid, sig[50 + 9 * i:66 + 9 * i, None])
    cpu.flush()
    for sid in sids[:4]:
        cpu.decode_closed_loop(2, sids=[sid])
    cpu.submit("queued", sig[300:316, None])
    path = cpu.snapshot(tempfile.mkdtemp(prefix="card_snap_") + "/engine")
    card = ReservoirEngine.restore(path, device=dev)
    assert card.states.device.type == "cuda"
    assert set(card.parked_sessions) == set(cpu.parked_sessions)
    a, b = cpu.collect_decoded(), card.collect_decoded()
    for sid in a.tokens:
        _close(b.tokens[sid], a.tokens[sid])
    for e in (cpu, card):
        e.flush()
    for sid in sids + ["queued"]:
        _close(card.decode_closed_loop(3, sids=[sid])[sid],
               cpu.decode_closed_loop(3, sids=[sid])[sid])


# --------------------------------------------------- learn-while-serving
def test_decode_fused_packed_shared_recurrence_per_slot_readout(dev):
    """The tenant pool's operand mix: shared ``lam_q`` and ``w_drive``, a
    per-slot (8, 1025, 1) ``w_out``, at the serving shape (525 lanes, K
    128, float64).  Against the plain version, and each row bit-equal to a
    launch that serves that row's readout to every row (a 2D ``w_out``)."""
    lam, nr, w_drive, _, states, y_prev = packed_inputs(8, 25, 500, 1, False,
                                                        dev)
    pool = torch.stack([packed_inputs(8, 25, 500, 1, False, dev,
                                      seed=10 + r)[3] for r in range(8)])
    mask = torch.ones(8, dtype=torch.bool, device=dev)
    kw = dict(k=128, use_bias=True, use_feedback=True)
    before = ops.decode_fused.launches
    got = ops.decode_fused_packed(lam, nr, w_drive, pool, states, y_prev,
                                  mask, **kw)
    assert ops.decode_fused.launches == before + 1
    want = ref.decode_fused_packed_ref(lam, nr, w_drive, pool, states,
                                       y_prev, mask, **kw)
    for g_, w_ in zip(got, want):
        _close(g_, w_)
    for r in range(8):
        one = ops.decode_fused_packed(lam, nr, w_drive, pool[r].contiguous(),
                                      states, y_prev, mask, **kw)
        assert torch.equal(one[0][r], got[0][r])
        assert torch.equal(one[1][r], got[1][r])
        assert torch.equal(one[2][:, r], got[2][:, r])


def _learn_twin(p, ro, sig, dev, refit_a):
    eng = ReservoirEngine(p, 4, readout=ro, learn=True, device=dev)
    for sid, tenant in (("a", "A"), ("b", "B"), ("c", "A")):
        eng.submit(sid, sig[:64, None], tenant=tenant)
    eng.flush()
    for t in range(64, 192):
        eng.decode_step({s: sig[t, None] for s in "abc"})
        for s in "abc":
            eng.observe(s, sig[t + 1, None])
    if refit_a:
        assert set(eng.refit("a")) == {"a"}
    return eng


def test_tenant_refit_isolation_bit_exact_on_card(dev):
    """A's refit on the card: B's next ``decode_step`` and its closed loop
    (one B2 launch with the per-slot pool) equal a twin that never refit,
    bit for bit; the card's closed loop matches a CPU engine serving the
    card's pool readouts (``set_readout``) to 1e-9."""
    p, ro, sig = _paged_model()
    eng = _learn_twin(p, ro, sig, dev, True)
    twin = _learn_twin(p, ro, sig, dev, False)
    assert eng._exec._slot_w is not None and twin._exec._slot_w is None
    for e in (eng, twin):
        e.collect_decoded()
    steps = [e.decode_step({"b": sig[192, None]})["b"] for e in (eng, twin)]
    assert np.array_equal(steps[0], steps[1])
    before = ops.decode_fused.launches
    loops = [e.decode_closed_loop(32) for e in (eng, twin)]
    assert ops.decode_fused.launches == before + 2
    assert torch.equal(loops[0]["b"], loops[1]["b"])
    cpu = ReservoirEngine(p, 4, readout=ro, device="cpu")
    for sid, tenant in (("a", "A"), ("b", "B"), ("c", "A")):
        cpu.submit(sid, h0=eng.state_of(sid),
                   y0=eng.arena.y_prev[eng.sessions[sid].slot].cpu(),
                   tenant=tenant, slot=eng.sessions[sid].slot)
    cpu.set_readout("A", eng.readout_for("a").cpu())
    card = eng.decode_closed_loop(16)
    want = cpu.decode_closed_loop(16)
    for sid in "abc":
        _close(card[sid], want[sid])


def test_facade_replay_on_card(dev):
    """North star criterion 3 on the card: the facade-parity workload
    through the card engine reproduces the 31 reference arrays to 1e-5."""
    from torch_facade_parity_workload import REF_PATH, compare, run_workload
    ref_arrays = np.load(REF_PATH)
    before = (ops.diag_scan.launches, ops.decode_fused.launches)
    got = run_workload(dev)
    assert ops.diag_scan.launches > before[0]
    assert ops.decode_fused.launches > before[1]
    assert compare(got, ref_arrays, atol=1e-5) <= 1e-5


# ---------------------------------------------------- recurrent LM families
# B1 with real per-timestep gates a (B, T, N), float32, as the RG-LRU and
# sLSTM recurrences give it: a small case, the RG-LRU training shape and
# xlstm-125m's sLSTM decode step (one token, the carried state as h0).
GATE_SHAPES = {"small": (3, 77, 130), "rglru": (2, 2048, 2560),
               "slstm-decode": (4, 1, 768)}


def gate_inputs(shape, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(shape, generator=g) * 0.6 + 0.39
    x = torch.randn(shape, generator=g)
    h0 = torch.randn(shape[::2], generator=g)
    return [t.to(device) for t in (a, x, h0)]


@pytest.mark.parametrize("name", list(GATE_SHAPES))
def test_diag_scan_per_timestep_gates_match_plain(dev, name):
    """Forward and backward of the real scan with a (B, T, N) and h0 on the
    card against the plain versions: outputs 2e-4, gradients (``da`` sums
    over the batch and time) 2e-4 x max(1, max|ref|)."""
    a, x, h0 = gate_inputs(GATE_SHAPES[name], dev)
    before = (ops.diag_scan.launches, ops.diag_scan_bwd.launches)
    h, _ = ops.diag_scan_lanes(a, None, x, None, h0, None)
    _close(h, ref.diag_scan_ref(a, x, h0), torch.float32)
    g = torch.randn(a.shape, generator=torch.Generator().manual_seed(1)
                    ).to(dev)
    got = ops.diag_scan_bwd(a, None, h, None, g, None, h0, None)
    want = ref.diag_scan_lanes_bwd_ref(a, None, h, None, g, None, h0, None)
    assert (ops.diag_scan.launches, ops.diag_scan_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    for g_, w_ in zip(got, want):
        assert (g_ is None) == (w_ is None)
        if w_ is not None:
            assert g_.shape == w_.shape
            _close_scaled(g_, w_, torch.float32)


# Head dims 129..256 (the tensor-core route that splits the head dim between
# two warpgroups).  recurrentgemma's local attention at seq 2048:
# _banded_attention's two 1024-row query chunks, GQA 10:1, head_dim 256,
# window 2048, float32 and chunk 1 in bfloat16; then the route's edges: odd
# head dims (rows not 16-byte aligned: scalar staging), a sequence slice of
# a larger tensor, kv_len inside a tile without the causal mask, a decode
# row, GQA 1:1 and 10:1 (two heads a block in bfloat16), an odd GQA group.
# (b, hq, hkv, sq, skv, d), causal, window, q_offset, kv_len, dtype, layout
LOCAL_CASES = {
    "chunk0": ((2, 10, 1, 1024, 1024, 256), True, 2048, 0, None,
               torch.float32, "contiguous"),
    "chunk1": ((2, 10, 1, 1024, 2048, 256), True, 2048, 1024, None,
               torch.float32, "contiguous"),
    "window-bf16": ((1, 10, 1, 100, 300, 256), True, 150, 200, None,
                    torch.bfloat16, "contiguous"),
    "chunk1-bf16": ((2, 10, 1, 1024, 2048, 256), True, 2048, 1024, None,
                    torch.bfloat16, "contiguous"),
    "hd129": ((1, 2, 2, 70, 90, 129), True, None, 20, None, torch.float32,
              "contiguous"),
    "hd192-window": ((1, 5, 1, 80, 200, 192), True, 64, 120, None,
                     torch.float32, "contiguous"),
    "hd255": ((2, 2, 1, 65, 65, 255), True, None, 0, None, torch.float32,
              "contiguous"),
    "hd255-bf16": ((1, 4, 2, 40, 90, 255), True, None, 50, None,
                   torch.bfloat16, "contiguous"),
    "seq-slice": ((1, 10, 1, 200, 400, 256), True, 300, 200, None,
                  torch.float32, "slice"),
    "seq-slice-hd200-bf16": ((1, 2, 1, 60, 120, 200), True, None, 60, None,
                             torch.bfloat16, "slice"),
    "kv_len-cross": ((2, 4, 2, 50, 160, 256), False, None, 0, 97,
                     torch.float32, "contiguous"),
    "decode": ((2, 10, 1, 1, 300, 256), True, None, 299, None,
               torch.float32, "contiguous"),
    "gqa1": ((1, 4, 4, 130, 130, 256), True, None, 0, None, torch.float32,
             "contiguous"),
    "gqa10": ((1, 10, 1, 130, 260, 256), True, 100, 130, None,
              torch.float32, "contiguous"),
    "gqa10-bf16": ((1, 10, 1, 130, 260, 256), True, 100, 130, None,
                   torch.bfloat16, "contiguous"),
    "gqa3-bf16": ((1, 3, 1, 70, 140, 256), True, None, 70, None,
                  torch.bfloat16, "contiguous"),
}


@pytest.mark.parametrize("name", list(LOCAL_CASES))
def test_flash_attention_head_dim_256_matches_plain(dev, name):
    shape, causal, window, q_offset, kv_len, dtype, layout = LOCAL_CASES[name]
    q, k, v = tiled_inputs(shape + (causal, window, q_offset, kv_len),
                           layout, 1.0, dtype, dev, seed=4)
    assert layout != "slice" or not q.is_contiguous()
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


@pytest.mark.parametrize("arch,seq,launches", [
    # 2 RG-LRU layers (B1 forward and backward) and a local layer at 1024
    # tokens (one flash chunk)
    ("recurrentgemma-2b", 1024, (2, 2, 1)),
    # one sLSTM layer: its c and n scans
    ("xlstm-125m", 128, (2, 2, 0)),
], ids=["recurrentgemma", "xlstm"])
def test_recurrent_train_step_card_matches_cpu(dev, arch, seq, launches):
    """One loss-and-gradient step of a smoke-size recurrent LM from the
    same weights: the card (B1 with per-timestep gates forward and
    backward, B3 at the local layer) against the CPU, float32, TF32 off."""
    cfg = smoke_config(arch)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, seq)))
    out = {}
    for device in (dev, torch.device("cpu")):
        before = (ops.diag_scan.launches, ops.diag_scan_bwd.launches,
                  ops.flash_attention_fwd.launches)
        p = tree_map(lambda v: v.to(device), params)
        loss, _, grads = loss_and_grads(cfg, p, {"tokens": toks.to(device)})
        if device.type == "cuda":
            assert (ops.diag_scan.launches - before[0],
                    ops.diag_scan_bwd.launches - before[1],
                    ops.flash_attention_fwd.launches - before[2]) == launches
        out[device.type] = (float(loss), flatten(grads))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    for k, w_ in g_cpu.items():
        d = float((g_gpu[k].cpu() - w_).abs().max())
        assert d <= 1e-4 * float(w_.abs().max()), k


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-125m"])
def test_recurrent_bf16_decode_card_matches_cpu(dev, arch):
    """The bfloat16 decode loop of a smoke-size recurrent LM on the card
    against the CPU from the same weights and tokens: recurrentgemma's
    float32 activations (the embed scale) to 1e-4 of the largest |logit|,
    xlstm's bfloat16 ones to 5e-2 (chip_smoke.py's BF16_LM_TOL)."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="bfloat16")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 8)))
    logits = {}
    for device in (dev, torch.device("cpu")):
        p = tree_map(lambda v: v.to(device), params)
        cache = lm.make_decode_cache(p, cfg, 2, toks.shape[1])
        steps = []
        for t in range(toks.shape[1]):
            out, cache = lm.decode_step(p, cfg, cache,
                                        toks[:, t:t + 1].to(device))
            steps.append(out.float().cpu())
        logits[device.type] = torch.stack(steps)
    tol = 1e-4 if cfg.embed_scale else 5e-2
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    assert err <= tol * float(logits["cpu"].abs().max()), err


# --------------------------------------------------------------------------- #
# Slice 12: whisper's encoder and llava's layers through B3; the MoE block     #
# --------------------------------------------------------------------------- #
#: (b, hq, hkv, sq, skv, d, causal, window, q_offset): whisper-tiny's
#: encoder self-attention at its published shape (non-causal, 1500 frames:
#: no multiple of the kernel's key tile), and llava-next-mistral-7b's
#: second 1024-row band chunk at batch 1 (GQA 32 / 8, head_dim 128, window
#: 4096).
SLICE12_FLASH = {
    "whisper-encoder": (8, 6, 6, 1500, 1500, 64, False, None, 0),
    "llava-chunk1": (1, 32, 8, 1024, 2048, 128, True, 4096, 1024),
}


@pytest.mark.parametrize("name", list(SLICE12_FLASH))
def test_flash_attention_slice12_shapes_match_plain(dev, name):
    case = SLICE12_FLASH[name]
    causal, window, q_offset = case[6:]
    q, k, v = flash_inputs(case, torch.float32, dev, seed=6)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = ops.flash_attention_fwd.launches
    out, lse = ops.flash_attention_fwd(q, k, v, **kw)
    assert ops.flash_attention_fwd.launches == before + 1
    torch.cuda.synchronize()
    want, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_whisper_encoder_attention_takes_one_unpadded_launch(dev):
    """``attention`` at 1500 non-causal keys: one kernel launch with the
    500-key backward chunks, no padding and no ``kv_len`` — the kernel
    masks its own key tail."""
    q, k, v = flash_inputs((1, 6, 6, 1500, 1500, 64), torch.float32, dev,
                           seed=7)
    before = ops.flash_attention_fwd.launches
    out = attn_mod.attention(q, k, v, causal=False)
    assert ops.flash_attention_fwd.launches == before + 1
    want = attn_mod.dense_attention(q, k, v, causal=False)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)


def test_apply_moe_card_matches_cpu(dev):
    """kimi's MoE block at smoke size with its buffers overflowing (a
    capacity factor of 0.5): the same kept assignments, outputs and aux
    losses on the card as on the CPU (float32, TF32 off)."""
    cfg = dataclasses.replace(smoke_config("kimi-k2-1t-a32b"),
                              capacity_factor=0.5)
    p = lm.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    moe = tree_map(lambda v: v[0], p["layers"]["moe"])
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    cap = int(cfg.capacity_factor * 4 * 64 * cfg.top_k / cfg.n_experts) + 1
    res = {}
    for device in (dev, torch.device("cpu")):
        m = tree_map(lambda v: v.to(device), moe)
        xd = x.to(device)
        out, aux = blocks.apply_moe(m, xd, cfg)
        route = blocks.moe_route(xd.reshape(-1, cfg.d_model), m["router"],
                                 top_k=cfg.top_k, capacity=cap,
                                 e_local=cfg.n_experts)
        res[device.type] = (out.cpu(), {k: float(v) for k, v in aux.items()},
                            route[4].cpu(), route[5].cpu())
    (o_g, a_g, s_g, k_g), (o_c, a_c, s_c, k_c) = res["cuda"], res["cpu"]
    assert bool((~k_c).any())                       # drops happen
    assert torch.equal(k_g, k_c) and torch.equal(s_g, s_c)
    np.testing.assert_allclose(o_g.numpy(), o_c.numpy(), rtol=1e-4,
                               atol=1e-4 * float(o_c.abs().max()))
    for k in a_c:
        assert abs(a_g[k] - a_c[k]) <= 1e-5 * abs(a_c[k]), k


def test_whisper_train_step_and_decode_card_match_cpu(dev):
    """whisper-tiny at smoke size: one loss-and-gradient step with the
    encoder's attention through B3 (``attn_impl="flash"``: one launch an
    encoder layer, and the decoder's causal layers through it too), then
    four decode steps, on the card against the CPU from the same weights."""
    cfg = smoke_config("whisper-tiny")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g),
             "frames": torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                   generator=g)}
    out = {}
    for device in (dev, torch.device("cpu")):
        p = tree_map(lambda v: v.to(device), params)
        b = {k: v.to(device) for k, v in batch.items()}
        before = ops.flash_attention_fwd.launches
        loss, _, grads = loss_and_grads(cfg, p, b, attn_impl="flash")
        if device.type == "cuda":
            assert ops.flash_attention_fwd.launches - before == \
                cfg.encoder_layers + cfg.n_layers
        cache = lm.make_decode_cache(p, cfg, 2, 4)
        steps = []
        for t in range(4):
            logits, cache = lm.decode_step(p, cfg, cache,
                                           b["tokens"][:, t:t + 1])
            steps.append(logits.cpu())
        out[device.type] = (float(loss), flatten(grads), torch.stack(steps))
    (l_gpu, g_gpu, d_gpu), (l_cpu, g_cpu, d_cpu) = out["cuda"], out["cpu"]
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    for k, w_ in g_cpu.items():
        d = float((g_gpu[k].cpu() - w_).abs().max())
        assert d <= 1e-4 * float(w_.abs().max()), k
    assert float((d_gpu - d_cpu).abs().max()) <= 1e-5 * float(
        d_cpu.abs().max())


# ------------------------------------------------------- the sharded arena
def _served_n1024():
    cfg = ESNConfig(n=1024, spectral_radius=0.95, leak=0.9, input_scaling=0.5,
                    ridge_alpha=1e-8, seed=0)
    sig = mso_series(3, 2001)
    p = esn.dpg_params(cfg, "noisy_golden", sigma=0.1, device="cpu")
    return p, esn.fit(p, sig[:-1, None], sig[1:, None], washout=100), sig


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_arena_on_a_logical_card_mesh_matches_unsharded(dev, shape):
    """8 sessions at n = 1024 on a logical mesh of the one card (each cell
    its own shard and launches): one scan launch a cell; one fused decode
    a data shard where the model axis is whole, the step route where it is
    split; elementwise within 1e-9 * max(|ref|, 1) of the unsharded card
    engine (the readout sums in shard order)."""
    from repro_torch.launch.mesh import make_local_mesh
    p, ro, sig = _served_n1024()
    starts = np.random.default_rng(1).integers(0, 2000 - 512, size=8)
    d, m = shape
    outs, counts = {}, {}
    for name, kw in (("plain", dict(device=dev)), ("mesh", dict(
            mesh=make_local_mesh(d, m, devices=[dev] * (d * m))))):
        eng = ReservoirEngine(p, 8, readout=ro, **kw)
        b1, b2 = ops.diag_scan.launches, ops.decode_fused.launches
        for sid, lo in enumerate(starts):
            eng.submit(sid, sig[lo:lo + 512, None])
        eng.flush()
        ys = eng.decode_closed_loop(32)
        torch.cuda.synchronize()
        counts[name] = (ops.diag_scan.launches - b1,
                        ops.decode_fused.launches - b2)
        outs[name] = [v for s in range(8)
                      for v in (ys[s], *eng.release(s))]
    assert counts["mesh"] == (d * m, d if m == 1 else 0)
    for g_, w_ in zip(outs["mesh"], outs["plain"]):
        g_, w_ = g_.cpu(), w_.cpu()
        assert bool(torch.isfinite(g_).all())
        assert float(((g_ - w_).abs() / w_.abs().clamp(min=1.0)).max()) \
            <= 1e-9


def test_serve_mesh_needs_the_cards_it_names(dev):
    """``--mesh 2x1`` on a one-card machine exits with the JAX driver's
    device-count message (a machine with more cards serves it)."""
    from repro_torch.launch import serve
    have = torch.cuda.device_count()
    argv = ["--reservoir", "--n", "32", "--slots", "2", "--sessions", "2",
            "--prompt-len", "40", "--gen", "4", "--mesh", f"{have + 1}x1"]
    with pytest.raises(SystemExit, match=f"--mesh {have + 1}x1 needs "
                                         f"{have + 1} devices, have {have}"):
        serve.main(argv)


def test_flash_attention_f32_error_at_whisper_encoder_vs_float64(dev):
    """B3's float32 output at whisper-tiny's encoder (8, 6, 1500, 64),
    non-causal, within 3e-6 of dense softmax attention in float64 (each
    key tile's P V in its own accumulator, joined to O on the CUDA
    cores); ``scripts/b3_f32_error.py``'s ``random`` inputs."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((8, 6, 1500, 64), generator=g).to(dev)
               for _ in range(3))
    out, _ = ops.flash_attention_fwd(q, k, v, causal=False)
    s = q.double() @ k.double().transpose(-1, -2) * 64 ** -0.5
    want = torch.softmax(s, dim=-1) @ v.double()
    assert float((out.double() - want).abs().max()) <= 3e-6


# --------------------------------------------------------------------------- #
# Slice 14: the sharded LM on the card (DTensor over one NCCL rank)           #
# --------------------------------------------------------------------------- #
# NCCL refuses two ranks on one card, and over gloo the functional
# all-gather that DTensor's redistribution calls did not return on CUDA
# tensors of ranks that share it (scripts/probe_process_group.py): the card
# runs the (1, 1) mesh over NCCL, through the same DTensor code as the
# multi-rank meshes of tests/test_torch_distributed.py on the CPU.
def _sharded_rank(rank, which):
    import torch

    from repro_torch import dist
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import blocks, lm
    from repro_torch.sharding.rules import make_profile
    from repro_torch.train.trainer import loss_and_grads
    from repro_torch.tree import flatten
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_lm_mesh((1, 1), device_type="cuda")
    gen = torch.Generator().manual_seed(0)
    if which == "esn":
        cfg = smoke_config("linear-esn")
        prof = make_profile(mesh, cfg)
        params = lm.init_params(gen, cfg, "cuda")
        tokens = torch.randint(0, cfg.vocab, (4, 64), generator=gen).cuda()
        l_p, _, g_p = loss_and_grads(cfg, params, {"tokens": tokens})
        ops.diag_scan.launches = ops.diag_scan_bwd.launches = 0
        l_d, _, g_d = loss_and_grads(
            cfg, lm.place_params(params, cfg, prof),
            dist.place({"tokens": tokens}, {"tokens": (prof.dp_spec, None)},
                       mesh), prof=prof)
        torch.cuda.synchronize()
        fd, fp = flatten(dist.full(g_d)), flatten(g_p)
        return {"loss_rel": abs(float(l_d) - float(l_p)) / abs(float(l_p)),
                "grad_rel": max(float((fd[k] - fp[k]).abs().max())
                                / max(float(fp[k].abs().max()), 1e-30)
                                for k in fp),
                "launches": [ops.diag_scan.launches,
                             ops.diag_scan_bwd.launches]}
    if which == "attn":
        cfg = smoke_config("smollm-135m")
        prof = make_profile(mesh, cfg)
        params = lm.init_params(gen, cfg, "cuda")
        tokens = torch.randint(0, cfg.vocab, (4, 64), generator=gen).cuda()
        ops.flash_attention_fwd.launches = 0
        l_p, _, g_p = loss_and_grads(cfg, params, {"tokens": tokens},
                                     attn_impl="flash")
        plain = ops.flash_attention_fwd.launches
        ops.flash_attention_fwd.launches = 0
        l_d, _, g_d = loss_and_grads(
            cfg, lm.place_params(params, cfg, prof),
            dist.place({"tokens": tokens}, {"tokens": (prof.dp_spec, None)},
                       mesh), prof=prof, attn_impl="flash")
        torch.cuda.synchronize()
        fd, fp = flatten(dist.full(g_d)), flatten(g_p)
        return {"loss_rel": abs(float(l_d) - float(l_p)) / abs(float(l_p)),
                "grad_rel": max(float((fd[k] - fp[k]).abs().max())
                                / max(float(fp[k].abs().max()), 1e-30)
                                for k in fp),
                "launches": [ops.flash_attention_fwd.launches, plain]}
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b"), d_model=256,
                              n_heads=4, n_kv=4, moe_ff=512, n_experts=64,
                              dtype="float32")
    prof = make_profile(mesh, cfg)
    pm = {k: v.cuda() for k, v in blocks.init_moe(gen, cfg,
                                                   torch.float32).items()}
    x = torch.randn((2, 64, cfg.d_model), generator=gen).cuda()
    want, aux = blocks.apply_moe(pm, x, cfg)
    got, aux_d = blocks.apply_moe(
        dist.place(pm, blocks.moe_specs(cfg, prof), mesh),
        dist.place(x, (prof.dp_spec, None, None), mesh), cfg, prof)
    return {"out_rel": float((got.full_tensor() - want).abs().max()
                             / want.abs().max()),
            "lb_rel": abs(float(aux_d["load_balance"].full_tensor())
                          - float(aux["load_balance"]))
            / abs(float(aux["load_balance"]))}


def test_sharded_linear_esn_step_on_the_card_matches_unsharded(dev):
    """linear-esn smoke on the (1, 1) NCCL mesh: the loss within 1e-5 of
    the unsharded card step's, every gradient leaf within 1e-4 of its
    largest entry, B1 and its backward launched on the rank (2 layers)."""
    from repro_torch.launch.mesh import spawn_ranks
    (res,) = spawn_ranks(_sharded_rank, 1, backend="nccl", args=("esn",),
                         timeout=300)
    assert res["loss_rel"] <= 1e-5 and res["grad_rel"] <= 1e-4, res
    assert res["launches"] == [2, 2], res


def test_sharded_attention_step_on_the_card_matches_unsharded(dev):
    """smollm-135m smoke on the (1, 1) NCCL mesh through B3 on DTensor
    operands (``attention.attention``'s ``local_map``): the loss within
    1e-5 of the unsharded card step's, every gradient leaf within 1e-4 of
    its largest entry, B3 launched as often as unsharded."""
    from repro_torch.launch.mesh import spawn_ranks
    (res,) = spawn_ranks(_sharded_rank, 1, backend="nccl", args=("attn",),
                         timeout=300)
    assert res["loss_rel"] <= 1e-5 and res["grad_rel"] <= 1e-4, res
    assert res["launches"][0] == res["launches"][1] > 0, res


def test_expert_parallel_moe_on_the_card_matches_local(dev):
    """The expert-parallel MoE (a ``local_map`` body) on the (1, 1) NCCL
    mesh against the one-device block, at the MoE check's 2e-3."""
    from repro_torch.launch.mesh import spawn_ranks
    (res,) = spawn_ranks(_sharded_rank, 1, backend="nccl", args=("moe",),
                         timeout=300)
    assert res["out_rel"] <= 2e-3 and res["lb_rel"] <= 0.2, res
