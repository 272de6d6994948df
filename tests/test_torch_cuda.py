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
