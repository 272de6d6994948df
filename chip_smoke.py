#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel (the diagonal scan, its backward, the fused decode, flash attention)
against its plain PyTorch version at the main paths' shapes and times both
— the scan kernels also against their chunked plain versions at the chunk
count the launcher picks, with the profiler's device time, the host time
of a call and a sweep of the chunk count — then drives the port's five
main paths on the card, each with the launch counts set to 0 just before
it and read just after:

1. ``repro_torch.launch.serve --reservoir``: the full-width reservoir
   workload (n=1024, 8 slots, 16 sessions, 1024-token prompts, 128
   closed-loop tokens, float64), held against the port's CPU engine;
2. ``repro_torch.launch.train``: the paper's reservoir LM ``linear-esn`` at
   its published width (12 layers, d_model 768, d_rnn 1024, d_ff 2048, vocab
   50304), batch 8 x 1024 tokens, 10 AdamW steps, float32 — every scan and
   its gradient through the kernels, 12 forward and 12 backward launches a
   step; a 2-layer full-width trainer is held against the CPU's;
3. ``repro_torch.launch.serve --arch linear-esn``: the LM decode loop at
   full width in the config's bfloat16 (as the JAX loop serves), the
   card's tokens replayed through the CPU loop and every step's logits
   held against the CPU's; a 2-layer float32 loop is held against the CPU
   more tightly;
4. ``repro_torch.launch.train --arch smollm-135m``: the attention LM at its
   published widths (30 layers, d_model 576, 9 query / 3 KV heads of 64,
   d_ff 1536, vocab 49152), batch 8 x 2048 tokens, 10 AdamW steps, float32 —
   every attention forward through the flash kernel, two 1024-row query
   chunks a layer, 60 launches a step; a 2-layer full-width trainer is held
   against the CPU's;
5. ``repro_torch.launch.serve --arch smollm-135m``: its decode loop over KV
   caches (dense decode attention, as in the JAX package: no kernel), in
   bfloat16, held against the CPU as path 3 is.

Any failed phase exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it names the card and its
power limit, and the one before that lists every kernel with its error,
times, bound and launches.

Tolerances: float64 ``max|d| <= 1e-9 * max(1, max|ref|)`` — the kernels
contract multiply-adds into FMAs and sum in another order; float32 2e-4, as
the JAX package's kernel tests (scaled by ``max(1, max|ref|)`` for the
backward, whose ``da`` sums 8192 terms); flash attention in bfloat16 5e-2
(the JAX package's bf16 kernel test) and its ``lse`` 1e-5; the float32 LM
on the card against the CPU 1e-4 relative (TF32 off: cuBLAS and the CPU sum
in different orders); the bfloat16 LM serve loops against the CPU 5e-2 of
the largest |logit| (bfloat16 keeps 8 bits: the two devices round the same
ops but sum the GEMMs in other orders, so activations part by an ulp here
and there and the gaps add up over the layers — about 13 ulps of the
largest logit allowed).

Bounds: the larger of the bytes (each input read once, each output written
once) over HBM3's 3.35 TB/s and the operations over the rate of the units
that run them (NVIDIA H100 SXM data sheet, dense): 67 TFLOP/s float32 and
34 TFLOP/s float64 outside the tensor cores (float64 contractions 67 on
them); flash attention on the tensor cores, float32 as 3xTF32 (three TF32
products per float32 product at 495 TFLOP/s) and bfloat16 at 989 TFLOP/s,
with its float32 CUDA-core bound (``simt_bound_ms``) beside it.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; flop/s of
#: element-wise work outside the tensor cores, and of contractions, which
#: float64 can run on the tensor cores at twice that rate; dense
#: tensor-core rates of the flash kernel's products (TF32 operands of the
#: 3xTF32 route for float32 inputs, bfloat16).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
PEAK_CONTRACT_FLOPS = {"float64": 67e12, "float32": 67e12}
PEAK_TENSOR_FLOPS = {"tf32": 495e12, "bfloat16": 989e12}
F64_TOL, F32_TOL = 1e-9, 2e-4
LM_TOL, BF16_LM_TOL = 1e-4, 5e-2
SERVE_ARGS = ["--reservoir", "--n", "1024", "--slots", "8", "--sessions",
              "16", "--prompt-len", "1024", "--gen", "128"]
TRAIN_STEPS = 10
TRAIN_ARGS = ["--arch", "linear-esn", "--vocab", "50304", "--batch", "8",
              "--seq", "1024", "--steps", str(TRAIN_STEPS)]
LM_SERVE_ARGS = ["--arch", "linear-esn", "--batch", "4", "--prompt-len",
                 "64", "--gen", "32"]
SMOLLM_TRAIN_ARGS = ["--arch", "smollm-135m", "--vocab", "49152", "--batch",
                     "8", "--seq", "2048", "--steps", str(TRAIN_STEPS)]
SMOLLM_SERVE_ARGS = ["--arch", "smollm-135m", "--batch", "4", "--prompt-len",
                     "64", "--gen", "32"]
BF16_TOL, LSE_TOL = 5e-2, 1e-5
#: The port's kernels, by their CUDA function names (profile summaries).
OWN_KERNELS = ("diag_scan_chunk", "diag_scan", "diag_scan_bwd_chunk",
               "diag_scan_bwd", "decode_fused", "flash_attention_fwd")


def ptxas_spills(log: str) -> dict:
    """``{function: "S bytes spill stores, L bytes spill loads"}`` for each
    function of a ``-Xptxas=-v`` log that spills (empty: none does)."""
    out, func = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            func = line.split("Function properties for", 1)[1].strip()
        elif "spill stores" in line and func is not None:
            stores, loads = (int(part.split("bytes spill")[0].split()[-1])
                             for part in line.split(",")[1:3])
            if stores or loads:
                out[func] = f"{stores} bytes spill stores, {loads} loads"
            func = None
    return out


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def max_err(got, want):
    """(max |got - want|, tolerance) for one output pair."""
    import torch
    got, want = got.detach().cpu(), want.detach().cpu()
    d = float((got - want).abs().max()) if want.numel() else 0.0
    if want.dtype in (torch.float32, torch.complex64):
        return d, F32_TOL
    return d, F64_TOL * max(1.0, float(want.abs().max()) if want.numel()
                            else 1.0)


def worst_of(errs):
    """The (error, tolerance) pair with the largest ratio, so an error is
    always reported beside its own tolerance."""
    e, t = max(errs, key=lambda et: et[0] / et[1])
    return {"max_abs_err": e, "tol": t, "err_over_tol": e / t}


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def copy_bandwidth() -> float:
    """Device-to-device copy rate in bytes/s (read + write counted)."""
    import torch
    src = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=20)
    return 2 * src.numel() * 4 / (ms * 1e-3)


def bound(bytes_moved: float, flops: float, dtype: str, copy_bw: float,
          contract_flops: float = 0.0, contract_peak: float = None):
    """The larger of the byte time and the operation time; ``flops`` are
    element-wise, ``contract_flops`` those of contractions (at
    ``contract_peak``, default the dtype's contraction rate)."""
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = ((flops / PEAK_FLOPS[dtype] if flops else 0.0)
             + contract_flops / (contract_peak or PEAK_CONTRACT_FLOPS[dtype])
             ) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "copy_bound_ms": bytes_moved / copy_bw * 1e3,
            "bytes": bytes_moved, "flops": flops,
            "contract_flops": contract_flops}


# --------------------------------------------------------------------------- #
# Phase 3: B1 diag_scan                                                        #
# --------------------------------------------------------------------------- #
def scan_inputs(shape, a_kind, cplx, with_h0, dtype, seed=0):
    import torch
    g = torch.Generator().manual_seed(seed)
    b, t, n = shape
    a_shape = {"static": (n,), "time": (t, n), "full": (b, t, n)}[a_kind]
    a = torch.rand(a_shape, generator=g, dtype=torch.float64) * 0.6 + 0.35
    x = torch.randn((b, t, n), generator=g, dtype=torch.float64)
    h0 = (torch.randn((b, n), generator=g, dtype=torch.float64)
          if with_h0 else None)
    if cplx:
        a = torch.polar(a, torch.rand(a_shape, generator=g,
                                      dtype=torch.float64) * np.pi)
        x = torch.complex(x, torch.randn((b, t, n), generator=g,
                                         dtype=torch.float64))
        if h0 is not None:
            h0 = torch.complex(h0, torch.randn((b, n), generator=g,
                                               dtype=torch.float64))
    if dtype == "float32":
        cast = torch.complex64 if cplx else torch.float32
        a, x = a.to(cast), x.to(cast)
        h0 = None if h0 is None else h0.to(cast)
    return [None if v is None else v.to("cuda") for v in (a, x, h0)]


def scan_cost(a, x, h0):
    """Bytes (each input read once, the output written once) and flops of
    one diag_scan call on these inputs."""
    item = x.element_size()
    nbytes = item * (a.numel() + 2 * x.numel()
                     + (0 if h0 is None else h0.numel()))
    flops = x.numel() * (8 if x.is_complex() else 2)
    return nbytes, flops


def split_lanes(v):
    """(re, im) lanes of one operand, as the prefill route hands them to
    ``ops.diag_scan_lanes`` (im None for a real operand)."""
    if v is None:
        return None, None
    if v.is_complex():
        return v.real.contiguous(), v.imag.contiguous()
    return v, None


def kernel_calls(fn, calls: int = 20):
    """Device time and CUDA launches per call of ``fn`` in a
    ``torch.profiler`` window of ``calls`` calls: the sum of the port's own
    kernels' times (``OWN_KERNELS``) and their count, each over ``calls``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    own = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and any(f"::{n}_kernel" in e.name for n in OWN_KERNELS)]
    if not own:
        return {"device_ms": "not measured", "cuda_launches_per_call":
                "not measured"}
    us = sum(e.time_range.end - e.time_range.start for e in own)
    return {"device_ms": us / 1e3 / calls,
            "cuda_launches_per_call": len(own) / calls}


def host_us(fn, calls: int = 200, repeats: int = 10):
    """Host time of one call of ``fn``: ``perf_counter`` over ``calls``
    back-to-back calls with no synchronisation inside, ``repeats`` times
    (synchronised between repeats).  Returns ``(least, median)`` of the
    repeats: the host is shared, so the least is the call's own cost and
    the median shows the noise."""
    import torch
    fn()
    per_call = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return min(per_call), float(np.median(per_call))


def check_diag_scan(ops, ref, dsk, copy_bw):
    """Each case through both wrappers of the kernels: ``diag_scan`` (real
    or complex tensors) and ``diag_scan_lanes`` (split lanes, the entry the
    main path calls, and the one timed), against the sequential plain
    version and the chunked one at the chunk count the launcher picks."""
    import torch
    cases = [
        # name, shape, a, complex, h0, dtype, timed
        ("wave", (8, 1024, 525), "static", True, False, "float64", True),
        ("fit", (1, 2000, 525), "static", True, False, "float64", True),
        # linear-esn training: B=8, T=1024, d_rnn=1024, complex64 lanes
        ("train", (8, 1024, 1024), "static", True, False, "float32", True),
        # linear-esn LM decode: batch 4, one token, d_rnn 1024, with h0
        ("lm-decode", (4, 1, 1024), "static", True, True, "float32", True),
        ("time-a", (3, 77, 130), "time", True, False, "float64", False),
        ("full-a-h0", (2, 50, 20), "full", False, True, "float64", False),
        ("ragged-h0", (5, 333, 257), "static", True, True, "float64", False),
        ("real", (4, 100, 129), "static", False, False, "float64", False),
        ("f32", (4, 256, 300), "static", True, True, "float32", False),
    ]
    rows = []
    for name, shape, a_kind, cplx, with_h0, dtype, timed in cases:
        a, x, h0 = scan_inputs(shape, a_kind, cplx, with_h0, dtype)
        chunks = dsk.scan_chunks(*shape)
        want = ref.diag_scan_ref(a, x, h0)
        lanes = [*split_lanes(a), *split_lanes(x), *split_lanes(h0)]
        got_re, got_im = ops.diag_scan_lanes(*lanes)
        want_re, want_im = split_lanes(want)
        chunked = ref.diag_scan_lanes_chunked_ref(*lanes, chunks=chunks)
        errs = [max_err(ops.diag_scan(a, x, h0), want),
                max_err(got_re, want_re), max_err(got_re, chunked[0])]
        if cplx:
            errs += [max_err(got_im, want_im), max_err(got_im, chunked[1])]
        row = {"case": name, "shape": list(shape), "dtype": dtype,
               "chunks": chunks, **worst_of(errs)}
        for e, t in errs:
            if e > t:
                fail(f"diag_scan {name}: max|d| {e:.3e} > {t:.3e}")
        if timed:
            def call():
                return ops.diag_scan_lanes(*lanes)
            row["ms"] = time_ms(call, reps=20)
            row.update(kernel_calls(call))
            row["host_us"], row["host_us_median"] = host_us(call)
            # The host's own speed: one PyTorch elementwise op on the lanes.
            row["host_us_torch_add"] = host_us(
                lambda: torch.add(lanes[2], lanes[2]))[0]
            row["plain_ms"] = time_ms(lambda: ref.diag_scan_ref(a, x, h0),
                                      reps=2, warmup=1)
            row.update(bound(*scan_cost(a, x, h0), dtype, copy_bw))
            # Device time (profiler) of the kernels at each chunk count.
            row["chunk_sweep_device_ms"] = {
                c: kernel_calls(lambda: dsk.diag_scan_lanes_cuda(
                    *lanes, chunks=c))["device_ms"]
                for c in (1, 2, 4, 8, 16, 32, 64, 128)}
        rows.append(row)
        print(json.dumps({"diag_scan": row}), flush=True)
    return rows


def scan_bwd_cost(lanes, grads):
    """Bytes (each input read once — a, g, the saved h, h0 — and each output
    written once — dx, da at a's shape, dh0) and flops of one backward."""
    a_re, a_im, h_re, h_im, g_re, g_im, h0_re, h0_im = lanes
    ins = [v for v in lanes if v is not None]
    outs = [v for v in grads if v is not None]
    nbytes = h_re.element_size() * (sum(v.numel() for v in ins)
                                    + sum(v.numel() for v in outs))
    # Per lane-step: s = g + conj(a) s and da += s conj(h_prev).
    flops = g_re.numel() * (16 if g_im is not None else 4)
    return nbytes, flops


def max_err_scaled(got, want, tol):
    """(max |got - want|, tol * max(1, max|ref|)) for one gradient."""
    got, want = got.detach().cpu(), want.detach().cpu()
    d = float((got - want).abs().max()) if want.numel() else 0.0
    return d, tol * max(1.0, float(want.abs().max()) if want.numel() else 1.0)


def check_diag_scan_bwd(ops, ref, dsk, copy_bw):
    """The backward kernels against the plain reverse-time loop and the
    chunked plain version at the launcher's chunk count, on the same
    forward output and incoming gradient."""
    import torch
    cases = [
        # name, shape, a, complex, h0, dtype, timed
        ("train", (8, 1024, 1024), "static", True, False, "float32", True),
        ("train-f64", (8, 1024, 1024), "static", True, False, "float64",
         True),
        ("time-a", (3, 77, 130), "time", True, False, "float64", False),
        ("full-a-h0", (2, 50, 20), "full", False, True, "float64", False),
        ("ragged-h0", (5, 333, 257), "static", True, True, "float64", False),
        ("real", (4, 100, 129), "static", False, False, "float64", False),
    ]
    outs = ("da_re", "da_im", "dx_re", "dx_im", "dh0_re", "dh0_im")
    rows = []
    for name, shape, a_kind, cplx, with_h0, dtype, timed in cases:
        a, x, h0 = scan_inputs(shape, a_kind, cplx, with_h0, dtype)
        chunks = dsk.scan_chunks(*shape)
        (a_re, a_im), (h0_re, h0_im) = split_lanes(a), split_lanes(h0)
        h_re, h_im = ops.diag_scan_lanes(a_re, a_im, *split_lanes(x), h0_re,
                                         h0_im)
        g = torch.Generator().manual_seed(7)
        real = h_re.dtype
        g_re = torch.randn(shape, generator=g, dtype=real).to("cuda")
        g_im = (torch.randn(shape, generator=g, dtype=real).to("cuda")
                if cplx else None)
        lanes = (a_re, a_im, h_re, h_im, g_re, g_im, h0_re, h0_im)
        got = ops.diag_scan_bwd(*lanes)
        tol = F32_TOL if dtype == "float32" else F64_TOL
        errs = {}
        for plain, want in (("", ref.diag_scan_lanes_bwd_ref(*lanes)),
                            ("chunked ", ref.diag_scan_lanes_bwd_chunked_ref(
                                *lanes, chunks=chunks))):
            for out, gv, wv in zip(outs, got, want):
                if (gv is None) != (wv is None):
                    fail(f"diag_scan_bwd {name}: {out} missing on one side")
                if wv is None:
                    continue
                if gv.shape != wv.shape:
                    fail(f"diag_scan_bwd {name}: {out} shape "
                         f"{tuple(gv.shape)} != {tuple(wv.shape)}")
                errs[plain + out] = max_err_scaled(gv, wv, tol)
        for out, (e, t) in errs.items():
            if e > t:
                fail(f"diag_scan_bwd {name} {out}: max|d| {e:.3e} > {t:.3e}")
        row = {"case": name, "shape": list(shape), "dtype": dtype,
               "chunks": chunks, **worst_of(list(errs.values())),
               "per_output": {o: {"max_abs_err": e, "tol": t}
                              for o, (e, t) in errs.items()}}
        if timed:
            def call():
                return ops.diag_scan_bwd(*lanes)
            row["ms"] = time_ms(call, reps=20)
            row.update(kernel_calls(call))
            row["host_us"], row["host_us_median"] = host_us(call)
            row["host_us_torch_add"] = host_us(
                lambda: torch.add(g_re, g_re))[0]
            row["plain_ms"] = time_ms(
                lambda: ref.diag_scan_lanes_bwd_ref(*lanes), reps=2,
                warmup=1)
            row.update(bound(*scan_bwd_cost(lanes, got), dtype, copy_bw))
            row["chunk_sweep_device_ms"] = {
                c: kernel_calls(lambda: dsk.diag_scan_lanes_bwd_cuda(
                    *lanes, chunks=c))["device_ms"]
                for c in (1, 2, 4, 8, 16, 32, 64, 128)}
        rows.append(row)
        print(json.dumps({"diag_scan_bwd": row}), flush=True)
    return rows


def crossover(dispatch, esn, ESNConfig):
    """Kernel vs the chunked torch scan on a serving wave (8 rows, n=1024)
    at T_bucket 32 ... 1024 — where KERNEL_MIN_T should sit."""
    import torch
    p = esn.dpg_params(ESNConfig(n=1024, spectral_radius=0.95, leak=0.9),
                       sigma=0.1, device="cuda")
    out = []
    for t in (32, 64, 128, 256, 512, 1024):
        d = torch.randn((8, t, 1024), dtype=torch.float64, device="cuda")
        row = {"t_bucket": t}
        for method in ("kernel", "chunked"):
            row[f"{method}_ms"] = time_ms(
                lambda: dispatch.run_scan_q(p.lam_q, d, p.n_real,
                                            method=method), reps=5)
        out.append(row)
    return out


# --------------------------------------------------------------------------- #
# Phase 4: B2 decode_fused                                                     #
# --------------------------------------------------------------------------- #
def decode_inputs(b, nc, d, batched, seed=1):
    import torch
    g = torch.Generator().manual_seed(seed)

    def r(*shape, s=1.0):
        return (s * torch.randn(shape, generator=g,
                                dtype=torch.float64)).to("cuda")
    lead = (b,) if batched else ()
    mag = torch.rand(nc, generator=g, dtype=torch.float64) * 0.45 + 0.5
    ph = torch.rand(nc, generator=g, dtype=torch.float64) * np.pi
    return [(mag * torch.cos(ph)).to("cuda"), (mag * torch.sin(ph)).to("cuda"),
            r(b, nc), r(b, nc), r(b, d), r(*lead, d, nc, s=0.3),
            r(*lead, d, nc, s=0.3), r(*lead, d, d, s=0.2), r(*lead, d, s=0.1),
            # readout weights ~1/NC keep the closed loop's gain below one
            r(*lead, nc, d, s=0.5 / nc), r(*lead, nc, d, s=0.5 / nc)]


def decode_cost(args, mask, k):
    b, d = args[4].shape
    nc = args[2].shape[1]
    live = int(mask.sum())
    nbytes = 8 * (sum(v.numel() for v in args) + mask.numel()
                  + 2 * b * nc + b * d + k * b * d)
    # Per step and live row: the complex update and the bias add are
    # element-wise; the drive y.wd (re, im), the readout h.wh (re, im) and
    # y.wy are contractions.
    flops = k * live * (8 * nc + d)
    contract_flops = k * live * (8 * nc * d + 2 * d * d)
    return nbytes, flops, contract_flops


def check_decode_fused(ops, ref, copy_bw):
    import torch
    rows = []
    b, nc, d, k = 8, 525, 1, 128
    for batched in (False, True):
        for ensemble in ("off", "mean"):
            for partial in (False, True):
                args = decode_inputs(b, nc, d, batched)
                mask = torch.ones(b, dtype=torch.bool, device="cuda")
                if partial:
                    mask[1] = mask[6] = False
                got = ops.decode_fused(*args, mask, k=k, ensemble=ensemble)
                want = ref.decode_fused_ref(*args, mask, k=k,
                                            ensemble=ensemble)
                errs = {out: max_err(g, w) for out, g, w in
                        zip(("h_re", "h_im", "y", "ys"), got, want)}
                for out, (e, t) in errs.items():
                    if e > t:
                        fail(f"decode_fused {out} (weights "
                             f"{'3d' if batched else '2d'}, {ensemble}, "
                             f"partial={partial}): {e:.3e} > {t:.3e}")
                row = {"case": f"{'3d' if batched else '2d'}-{ensemble}-"
                               f"{'partial' if partial else 'full'}",
                       "shape": [b, nc, d, k],
                       **worst_of(list(errs.values())),
                       "per_output": {o: {"max_abs_err": e, "tol": t}
                                      for o, (e, t) in errs.items()}}
                if not batched and ensemble == "off" and not partial:
                    # The main path's case: shared weights, every slot live.
                    row["ms"] = time_ms(lambda: ops.decode_fused(
                        *args, mask, k=k), reps=20)
                    row["plain_ms"] = time_ms(lambda: ref.decode_fused_ref(
                        *args, mask, k=k), reps=2, warmup=1)
                    nbytes, flops, cflops = decode_cost(args, mask, k)
                    row.update(bound(nbytes, flops, "float64", copy_bw,
                                     contract_flops=cflops))
                rows.append(row)
                print(json.dumps({"decode_fused": row}), flush=True)
    return rows


# --------------------------------------------------------------------------- #
# B3 flash attention                                                           #
# --------------------------------------------------------------------------- #
# name, (b, hq, hkv, sq, skv, d), causal, window, q_offset, kv_len, dtype,
# timed.  The timed float32 cases are the launches of smollm-135m's
# training step at batch 8 x 2048: _banded_attention's 1024-row query
# chunks; chunk 1 is timed in bfloat16 as well (the bf16 MMA route).
FLASH_CASES = [
    ("chunk0", (8, 9, 3, 1024, 1024, 64), True, None, 0, None, "float32",
     True),
    ("chunk1", (8, 9, 3, 1024, 2048, 64), True, None, 1024, None, "float32",
     True),
    ("chunk1-bf16", (8, 9, 3, 1024, 2048, 64), True, None, 1024, None,
     "bfloat16", True),
    # the cases of tests/test_kernels.py
    ("mha-causal", (1, 2, 2, 64, 64, 32), True, None, 0, None, "float32",
     False),
    ("gqa", (2, 4, 2, 64, 64, 16), True, None, 0, None, "float32", False),
    ("mqa-ragged", (1, 3, 1, 40, 40, 8), True, None, 0, None, "float32",
     False),
    ("window16", (1, 2, 2, 64, 64, 32), True, 16, 0, None, "float32", False),
    ("decode", (1, 2, 1, 1, 96, 16), True, None, 95, None, "float32", False),
    ("cross-kv_len", (1, 2, 2, 48, 80, 16), False, None, 0, 70, "float32",
     False),
    ("bf16", (1, 2, 2, 32, 32, 16), True, None, 0, None, "bfloat16", False),
]


def flash_inputs(shape, dtype, seed=0):
    import torch
    b, hq, hkv, sq, skv, d = shape
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, hq, sq, d), generator=g)
    k = torch.randn((b, hkv, skv, d), generator=g)
    v = torch.randn((b, hkv, skv, d), generator=g)
    return [t.to(device="cuda", dtype=getattr(torch, dtype))
            for t in (q, k, v)]


def flash_cost(q, k, mask):
    """Bytes (q, k, v read once, out and the float32 lse written once) and
    the flops of the visible query-key pairs: q.k and p.v, 2 * head_dim
    each."""
    b, hq, sq, d = q.shape
    nbytes = (q.element_size() * (2 * q.numel() + 2 * k.numel())
              + 4 * b * hq * sq)
    pairs = int(mask.sum()) * b * hq
    return nbytes, 4 * d * pairs


def flash_bound(q, k, mask, dtype, copy_bw):
    """B3's bound on the route the kernel takes: the products on the tensor
    cores, float32 as 3xTF32 (three TF32 products of each pair's flops),
    bfloat16 as one bf16 product; and the float32 CUDA-core bound of the
    same flops, for comparison with a SIMT kernel."""
    nbytes, flops = flash_cost(q, k, mask)
    route, passes = (("3xTF32", 3) if dtype == "float32" else ("bf16", 1))
    peak = PEAK_TENSOR_FLOPS["tf32" if dtype == "float32" else "bfloat16"]
    out = bound(nbytes, 0.0, dtype, copy_bw, contract_flops=passes * flops,
                contract_peak=peak)
    out.update(mma_route=route, pair_flops=flops,
               simt_bound_ms=flops / PEAK_FLOPS["float32"] * 1e3)
    return out


def library_attention(q, k, v, mask):
    """The yardstick: one PyTorch call computing the same function
    (timed here only; the port never calls it)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=True)


def check_flash_attention(ops, ref, copy_bw):
    """Each case through ``ops.flash_attention_fwd`` (the entry the model
    calls) against the plain version on the same inputs: the output and
    ``lse``; the training chunks are timed beside the plain version and
    the library call."""
    import torch
    rows = []
    for name, shape, causal, window, q_offset, kv_len, dtype, timed in \
            FLASH_CASES:
        q, k, v = flash_inputs(shape, dtype)
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  kv_len=kv_len)
        out, lse = ops.flash_attention_fwd(q, k, v, **kw)
        want, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
        tol = F32_TOL if dtype == "float32" else BF16_TOL
        err = float((out.float() - want.float()).abs().max())
        lse_err = float(((lse - want_lse).abs()
                         / want_lse.abs().clamp(min=1.0)).max())
        if not bool(torch.isfinite(out.float()).all()) or err > tol \
                or lse_err > LSE_TOL:
            fail(f"flash_attention {name}: max|d| {err:.3e} (tol {tol}), "
                 f"lse {lse_err:.3e} (tol {LSE_TOL})")
        row = {"case": name, "shape": list(shape), "dtype": dtype,
               "causal": causal, "window": window, "q_offset": q_offset,
               "kv_len": kv_len, "max_abs_err": err, "tol": tol,
               "err_over_tol": err / tol, "lse_max_rel_err": lse_err}
        if timed:
            row["ms"] = time_ms(lambda: ops.flash_attention_fwd(q, k, v, **kw),
                                reps=20)
            row["plain_ms"] = time_ms(lambda: ref.flash_attention_fwd_ref(
                q, k, v, **kw), reps=2, warmup=1)
            mask = ref.attention_mask(shape[3], shape[4], device="cuda", **kw)
            lib = library_attention(q, k, v, mask)
            row["library_ms"] = time_ms(
                lambda: library_attention(q, k, v, mask), reps=20)
            row["library_max_abs_err"] = float(
                (lib.float() - want.float()).abs().max())
            row.update(flash_bound(q, k, mask, dtype, copy_bw))
        rows.append(row)
        print(json.dumps({"flash_attention": row}), flush=True)
    return rows


# --------------------------------------------------------------------------- #
# Phase 5: the main path                                                       #
# --------------------------------------------------------------------------- #
def engine_vs_cpu(esn, ESNConfig, mso_series, ReservoirEngine):
    """The same 8-session workload through the engine on the card and on
    the CPU, one params/readout pair for both (a second ridge fit would
    amplify last-bit state differences through its conditioning)."""
    import torch
    cfg = ESNConfig(n=1024, spectral_radius=0.95, leak=0.9, input_scaling=0.5,
                    ridge_alpha=1e-8, seed=0)
    sig = mso_series(3, 2001)
    p = esn.dpg_params(cfg, "noisy_golden", sigma=0.1, device="cpu")
    ro = esn.fit(p, sig[:-1, None], sig[1:, None], washout=100)
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 2000 - 1024, size=8)
    outs = {}
    for device in ("cuda", "cpu"):
        eng = ReservoirEngine(p, 8, readout=ro, device=device)
        for sid, lo in enumerate(starts):
            eng.submit(sid, sig[lo:lo + 1024, None])
        eng.flush()
        ys = eng.decode_closed_loop(128)
        outs[device] = {sid: (ys[sid], *eng.release(sid)) for sid in range(8)}
    worst = {k: {"max_abs_err": 0.0, "tol": 0.0, "max_rel_err": 0.0,
                 "rel_tol": F64_TOL} for k in ("ys", "state", "y_prev")}
    for sid in range(8):
        for name, g, w in zip(("ys", "state", "y_prev"), outs["cuda"][sid],
                              outs["cpu"][sid]):
            if not bool(torch.isfinite(g).all()):
                fail(f"engine output {name} of session {sid} is not finite")
            err, tol = max_err(g, w)
            if err > tol:
                fail(f"card engine vs CPU engine, session {sid} {name}: "
                     f"{err:.3e} > {tol:.3e}")
            # Elementwise too, each element against its own scale: a few
            # modes of this model grow past 1e20, so the max-scaled
            # tolerance alone would let every O(1) lane be wrong.
            g, w = g.cpu(), w.cpu()
            rel = float(((g - w).abs() / w.abs().clamp(min=1.0)).max())
            if rel > F64_TOL:
                fail(f"card engine vs CPU engine, session {sid} {name}: "
                     f"max |d| / max(|ref|, 1) = {rel:.3e} > {F64_TOL:.0e}")
            if err > worst[name]["max_abs_err"]:
                worst[name].update(max_abs_err=err, tol=tol)
            worst[name]["max_rel_err"] = max(worst[name]["max_rel_err"], rel)
    return worst


def device_summary(prof, wall_ms):
    """Device busy time (union of kernel and copy intervals) and the top
    device consumers of one ``torch.profiler`` window."""
    from torch.autograd import DeviceType
    # Device-side events only (kernels and copies), so nothing is counted
    # twice through the CPU ops that launched it.
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return {"device_time": "not measured"}
    by_name, busy, end = {}, 0.0, float("-inf")
    for e in sorted(dev, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        busy += max(0.0, stop - max(start, end))      # union of intervals
        end = max(end, stop)
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (stop - start) / 1e3, calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    own = {k: v for k, v in by_name.items()
           if any(f"::{n}_kernel" in k for n in OWN_KERNELS)}
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / wall_ms,
            "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                    for k, (ms, c) in top],
            "port_kernels": [{"kernel": k[:90], "ms": ms, "calls": c}
                             for k, (ms, c) in sorted(own.items())]}


def profiled(fn):
    """``device_summary`` of one call of ``fn`` under ``torch.profiler``;
    the busy share is over the call's wall time inside the profiled window
    (the profiler's own per-op cost included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_summary(prof, wall_ms)


def profile_serve(serve):
    """Device time by kernel over the serving loop (warmup + 16 sessions)
    of a freshly built engine."""
    args = serve.build_parser().parse_args(SERVE_ARGS)
    engine, sig, train_t = serve.build_engine(args)
    return profiled(lambda: serve.serve_sessions(engine, args, sig, train_t))


def profile_train_step(train, Trainer, TrainConfig, MarkovTokens,
                       argv=TRAIN_ARGS):
    """Device time by kernel over one full-width training step (the main
    path's configuration), after one untimed step."""
    import torch
    args = train.build_parser().parse_args(argv)
    cfg = train.arch_config(args)
    data = MarkovTokens(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq)
    tr = Trainer(cfg, TrainConfig(steps=1, log_every=0, lr=args.lr), data,
                 device="cuda")
    state = tr.init_state(0)
    batch = {"tokens": torch.as_tensor(data.batch_at(0)["tokens"],
                                       device="cuda")}

    def step():
        return tr.step_fn(state["params"], state["opt"], state["ef"], batch)
    step()
    return profiled(step)


def leafwise(got, want):
    """max over leaves of max|got - want| / max|want| (flattened trees)."""
    worst, worst_key = 0.0, None
    for k, w in want.items():
        d = float((got[k].cpu() - w).abs().max())
        scale = float(w.abs().max())
        r = d / scale if scale else (0.0 if d == 0 else float("inf"))
        if r >= worst:
            worst, worst_key = r, k
    return worst, worst_key


def lm_trainer_vs_cpu(lm, loss_and_grads, Trainer, TrainConfig,
                      MarkovTokens, get_config, tree, arch="linear-esn",
                      batch=2, seq=256):
    """A 2-layer ``arch`` at full width (vocab 512), ``batch`` x ``seq``
    tokens: the first step's gradients and three AdamW steps' losses on the
    card against the CPU, from the same weights (``lm_params_from_numpy``)."""
    import dataclasses
    import torch
    cfg = dataclasses.replace(get_config(arch), n_layers=2,
                              vocab=512, dtype="float32")
    weights = tree.tree_map(lambda v: v.numpy(), lm.init_params(
        torch.Generator().manual_seed(0), cfg, "cpu"))
    data = MarkovTokens(vocab=cfg.vocab, batch=batch, seq_len=seq)
    out = {}
    for device in ("cuda", "cpu"):
        params = lm.lm_params_from_numpy(weights, device)
        batch = {"tokens": torch.as_tensor(data.batch_at(0)["tokens"],
                                           device=device)}
        _, _, grads = loss_and_grads(cfg, params, batch)
        tr = Trainer(cfg, TrainConfig(steps=3, log_every=0), data,
                     device=device)
        tr.run(start_state=tr.state_of(params))
        out[device] = (tree.flatten(grads), tr.losses)
    (g_gpu, l_gpu), (g_cpu, l_cpu) = out["cuda"], out["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    grad_rel, grad_key = leafwise(g_gpu, g_cpu)
    res = {"losses_cuda": l_gpu, "losses_cpu": l_cpu,
           "max_rel_loss_err": loss_rel, "worst_leaf_grad_err": grad_rel,
           "worst_leaf": grad_key, "tol": LM_TOL}
    if not (np.isfinite(l_gpu).all() and loss_rel <= LM_TOL
            and grad_rel <= LM_TOL):
        fail(f"card trainer vs CPU trainer: {res}")
    return res


def step_errors(got, want):
    """Per decode step (the logits each token was picked from, then the
    last): max |got - want| / max |want| over the batch and vocabulary."""
    d = (got.float() - want.float()).abs().amax(dim=(0, 2))
    return (d / want.float().abs().amax(dim=(0, 2))).tolist()


def lm_serve_vs_cpu(serve, res, argv=LM_SERVE_ARGS):
    """The bfloat16 serve loop on the card (``res``, the main path's run)
    against the CPU: the same weights and prompts (``serve.lm_setup``), the
    card's tokens fed to the CPU loop (teacher forcing, so a near-tie that
    the two devices break apart cannot part their paths), every step's
    logits held to ``BF16_LM_TOL`` of the step's largest |logit|; the share
    of steps whose greedy token the CPU picks too is reported."""
    args = serve.build_parser().parse_args(argv)
    cfg, params, prompts = serve.lm_setup(args, "cpu")
    cpu = serve.generate(params, cfg, prompts, args.gen, seed=args.seed + 1,
                         forced=res["tokens"])
    rel = step_errors(res["step_logits"], cpu["step_logits"])
    same = float(np.mean(res["tokens"] == cpu["tokens"]))
    out = {"dtype": cfg.dtype, "max_rel_err": max(rel),
           "mean_rel_err": float(np.mean(rel)), "tol": BF16_LM_TOL,
           "steps": len(rel), "same_greedy_token_share": same,
           "cpu_decode_tok_s": args.batch * args.gen / cpu["decode_s"]}
    if cfg.dtype != "bfloat16" or max(rel) > BF16_LM_TOL \
            or not np.isfinite(rel).all():
        fail(f"LM serve on the card vs the CPU replay: {out}")
    return out


def lm_serve_f32_vs_cpu(serve, lm, get_config, argv=LM_SERVE_ARGS):
    """The same loop through the library (``serve.generate``) on a 2-layer
    float32 config at full width: free-running on both devices, the same
    tokens and every step's logits within ``LM_TOL`` relative."""
    import dataclasses
    import torch
    args = serve.build_parser().parse_args(argv)
    cfg = dataclasses.replace(get_config(args.arch), n_layers=2,
                              dtype="float32")
    runs = {}
    for device in ("cuda", "cpu"):
        params = lm.init_params(torch.Generator().manual_seed(args.seed), cfg,
                                device)
        prompts = torch.as_tensor(np.random.default_rng(args.seed).integers(
            0, cfg.vocab, size=(args.batch, args.prompt_len)), device=device)
        runs[device] = serve.generate(params, cfg, prompts, args.gen,
                                      seed=args.seed + 1)
    rel = step_errors(runs["cuda"]["step_logits"], runs["cpu"]["step_logits"])
    same = bool(np.array_equal(runs["cuda"]["tokens"], runs["cpu"]["tokens"]))
    out = {"n_layers": 2, "dtype": "float32", "max_rel_err": max(rel),
           "tol": LM_TOL, "same_tokens": same}
    if max(rel) > LM_TOL or not same:
        fail(f"float32 LM loop on the card vs the CPU: {out}")
    return out


def flash_summary(rows, counts, keys):
    """The ``kernels`` entry of B3: the timed chunk-1 launch at top level
    (q_offset 1024 against 2048 keys, float32), chunk 0 and chunk 1 in
    bfloat16 beside it."""
    by = {r["case"]: r for r in rows}
    c0, c1, bf = by["chunk0"], by["chunk1"], by["chunk1-bf16"]
    more = ("simt_bound_ms", "mma_route", "library_ms",
            "library_max_abs_err")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:81",
                **counts, max_abs_err=c1["max_abs_err"], tol=c1["tol"],
                worst_err_over_tol=max(r["err_over_tol"] for r in rows),
                worst_lse_rel_err=max(r["lse_max_rel_err"] for r in rows),
                bf16_max_abs_err=bf["max_abs_err"], bf16_tol=bf["tol"],
                shape=c1["shape"], q_offset=1024, dtype="float32",
                **{k: c1[k] for k in keys}, **{k: c1[k] for k in more},
                chunk0={"shape": c0["shape"], "q_offset": 0,
                        **{k: c0[k] for k in keys},
                        **{k: c0[k] for k in more}},
                chunk1_bf16={"shape": bf["shape"], "q_offset": 1024,
                             **{k: bf[k] for k in keys},
                             **{k: bf[k] for k in more}})


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an "
             "NVIDIA GPU")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        fail(f"the port's sources are missing: no {src / 'repro_torch'}")
    sys.path.insert(0, str(src))
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch, esn
    from repro_torch.core.params import ESNConfig
    from repro_torch.data.pipeline import MarkovTokens
    from repro_torch.data.signals import mso_series
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import diag_scan as dsk
    from repro_torch.launch import serve, train
    from repro_torch.models import lm
    from repro_torch.serve.engine import ReservoirEngine
    from repro_torch.train.trainer import (TrainConfig, Trainer,
                                           loss_and_grads)
    counters = {"diag_scan": ops.diag_scan, "diag_scan_bwd": ops.diag_scan_bwd,
                "decode_fused": ops.decode_fused,
                "flash_attention_fwd": ops.flash_attention_fwd}

    def drive(path, fn, expected):
        """Run one main path with every launch count set to 0 just before
        it and read just after; fail if a kernel of the path never ran."""
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        for name in expected:
            if got[name] < 1:
                fail(f"main path {path} never launched the {name} kernel")
        launches[path] = got
        return out
    launches = {}

    phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(smi_line, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    # Both False (PyTorch's default for matmuls): the card computes float32
    # products in float32, as the CPU does.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("2 build")
    t0 = time.perf_counter()
    compiled = build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "nvcc_s": compiled}), flush=True)
    spills = {}
    for stem in ("diag_scan", "flash_attention"):
        log = build.build_log(stem)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {stem}:", line.strip(), flush=True)
        spills.update(ptxas_spills(log))
    print(json.dumps({"ptxas_functions_with_spills": spills}), flush=True)
    smem = build.library("flash_attention").flash_attention_smem_bytes
    print(json.dumps({"flash_attention_dynamic_smem_bytes": {
        f"{'bf16' if bf16 else 'f32'}_d{d}": smem(bf16, d)
        for bf16 in (0, 1) for d in (32, 64, 128)}}), flush=True)
    copy_bw = copy_bandwidth()
    print(json.dumps({"copy_bytes_per_s": copy_bw}), flush=True)

    phase("3 diag_scan kernel vs plain")
    scan_rows = check_diag_scan(ops, ref, dsk, copy_bw)
    print(json.dumps({"crossover": crossover(dispatch, esn, ESNConfig)}),
          flush=True)

    phase("4 decode_fused kernel vs plain")
    decode_rows = check_decode_fused(ops, ref, copy_bw)

    phase("5 main path 1: repro_torch.launch.serve " + " ".join(SERVE_ARGS))
    res = drive("serve_reservoir", lambda: serve.main(SERVE_ARGS),
                ("diag_scan", "decode_fused"))
    print(json.dumps({"serve": res,
                      "launches": launches["serve_reservoir"]}), flush=True)
    if not res["finite"] or res["sessions"] != 16:
        fail(f"serving loop: finite={res['finite']}, "
             f"sessions={res['sessions']} (expected 16)")
    print(json.dumps({"engine_vs_cpu": engine_vs_cpu(
        esn, ESNConfig, mso_series, ReservoirEngine)}), flush=True)
    print(json.dumps({"profile": profile_serve(serve)}), flush=True)

    phase("6 diag_scan_bwd kernel vs plain")
    bwd_rows = check_diag_scan_bwd(ops, ref, dsk, copy_bw)

    phase("7 main path 2: repro_torch.launch.train " + " ".join(TRAIN_ARGS))
    torch.cuda.reset_peak_memory_stats()
    res = drive("train", lambda: train.main(TRAIN_ARGS),
                ("diag_scan", "diag_scan_bwd"))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_layers = get_config("linear-esn").n_layers
    train_out = {k: res[k] for k in ("arch", "params", "batch", "seq",
                                     "steps_run", "losses", "ms_per_step",
                                     "tokens_per_s", "finite")}
    print(json.dumps({"train": train_out, "peak_memory_gb": peak_gb,
                      "launches": launches["train"]}), flush=True)
    if not res["finite"] or res["steps_run"] != TRAIN_STEPS:
        fail(f"training: finite={res['finite']}, steps={res['steps_run']}")
    for name in ("diag_scan", "diag_scan_bwd"):
        if launches["train"][name] != n_layers * TRAIN_STEPS:
            fail(f"training launched {name} {launches['train'][name]} "
                 f"times, expected {n_layers} a step x {TRAIN_STEPS}")
    print(json.dumps({"profile_train_step": profile_train_step(
        train, Trainer, TrainConfig, MarkovTokens)}), flush=True)

    phase("8 card trainer vs CPU trainer (2 layers, full width)")
    print(json.dumps({"trainer_vs_cpu": lm_trainer_vs_cpu(
        lm, loss_and_grads, Trainer, TrainConfig, MarkovTokens, get_config,
        tree)}), flush=True)

    phase("9 main path 3: repro_torch.launch.serve " + " ".join(LM_SERVE_ARGS))
    res = drive("serve_lm", lambda: serve.main(LM_SERVE_ARGS), ("diag_scan",))
    print(json.dumps({"serve_lm": {k: v for k, v in res.items() if k not in
                                   ("tokens", "step_logits", "last_logits")},
                      "launches": launches["serve_lm"]}), flush=True)
    if not res["finite"]:
        fail("LM serve: the last logits are not finite")
    print(json.dumps({"serve_lm_vs_cpu": lm_serve_vs_cpu(serve, res)}),
          flush=True)
    print(json.dumps({"serve_lm_f32_vs_cpu": lm_serve_f32_vs_cpu(
        serve, lm, get_config)}), flush=True)

    phase("10 flash_attention kernel vs plain")
    flash_rows = check_flash_attention(ops, ref, copy_bw)

    phase("11 main path 4: repro_torch.launch.train "
          + " ".join(SMOLLM_TRAIN_ARGS))
    torch.cuda.reset_peak_memory_stats()
    res = drive("train_smollm", lambda: train.main(SMOLLM_TRAIN_ARGS),
                ("flash_attention_fwd",))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    smollm = get_config("smollm-135m")
    train_out = {k: res[k] for k in ("arch", "params", "batch", "seq",
                                     "steps_run", "losses", "ms_per_step",
                                     "tokens_per_s", "finite")}
    print(json.dumps({"train_smollm": train_out, "peak_memory_gb": peak_gb,
                      "launches": launches["train_smollm"]}), flush=True)
    if not res["finite"] or res["steps_run"] != TRAIN_STEPS:
        fail(f"smollm training: finite={res['finite']}, "
             f"steps={res['steps_run']}")
    want = smollm.n_layers * 2 * TRAIN_STEPS      # two query chunks a layer
    if launches["train_smollm"]["flash_attention_fwd"] != want:
        fail(f"smollm training launched flash_attention_fwd "
             f"{launches['train_smollm']['flash_attention_fwd']} times, "
             f"expected {want}")
    print(json.dumps({"profile_train_smollm_step": profile_train_step(
        train, Trainer, TrainConfig, MarkovTokens, SMOLLM_TRAIN_ARGS)}),
        flush=True)

    phase("12 card trainer vs CPU trainer (smollm-135m, 2 layers, full "
          "width, 1 x 2048 tokens)")
    print(json.dumps({"smollm_trainer_vs_cpu": lm_trainer_vs_cpu(
        lm, loss_and_grads, Trainer, TrainConfig, MarkovTokens, get_config,
        tree, arch="smollm-135m", batch=1, seq=2048)}), flush=True)

    phase("13 main path 5: repro_torch.launch.serve "
          + " ".join(SMOLLM_SERVE_ARGS) + " (decode attention is a dense "
          "product, as in the JAX package: no TPU kernel on this path)")
    res = drive("serve_smollm", lambda: serve.main(SMOLLM_SERVE_ARGS), ())
    print(json.dumps({"serve_smollm": {k: v for k, v in res.items()
                                       if k not in ("tokens", "step_logits",
                                                    "last_logits")},
                      "launches": launches["serve_smollm"]}), flush=True)
    if not res["finite"]:
        fail("smollm serve: the last logits are not finite")
    print(json.dumps({"serve_smollm_vs_cpu": lm_serve_vs_cpu(
        serve, res, SMOLLM_SERVE_ARGS)}), flush=True)
    print(json.dumps({"serve_smollm_f32_vs_cpu": lm_serve_f32_vs_cpu(
        serve, lm, get_config, SMOLLM_SERVE_ARGS)}), flush=True)

    phase("14 summary")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "copy_bound_ms")
    rows = {r["case"]: r for r in scan_rows}
    wave, fit, fwd_train = rows["wave"], rows["fit"], rows["train"]
    fwd_decode = rows["lm-decode"]
    bwd = {r["case"]: r for r in bwd_rows}
    bwd_train = bwd["train"]
    dec = next(r for r in decode_rows if "ms" in r)

    # The scan rows also carry the chunk count, the profiler's device time,
    # the host time and the CUDA launches of one call.
    scan_keys = keys + ("chunks", "device_ms", "host_us", "host_us_median",
                        "host_us_torch_add", "cuda_launches_per_call")

    def count(name):
        return {"launches": sum(p[name] for p in launches.values()),
                "launches_by_path": {p: c[name] for p, c in launches.items()}}
    # max_abs_err / tol are those of the timed main-path case;
    # worst_err_over_tol is the largest ratio over every case checked.
    kernels = [
        dict(name="diag_scan", route="cuda",
             source="src/repro_torch/csrc/diag_scan.cu",
             replaces="src/repro/kernels/diag_scan.py:57",
             **count("diag_scan"),
             max_abs_err=wave["max_abs_err"], tol=wave["tol"],
             worst_err_over_tol=max(r["err_over_tol"] for r in scan_rows),
             shape=wave["shape"],
             **{k: wave[k] for k in scan_keys}, library_ms=None,
             fit_shape={"shape": fit["shape"],
                        **{k: fit[k] for k in scan_keys}},
             train_shape={"shape": fwd_train["shape"], "dtype": "float32",
                          **{k: fwd_train[k] for k in scan_keys}},
             lm_decode_shape={"shape": fwd_decode["shape"],
                              "dtype": "float32",
                              **{k: fwd_decode[k] for k in scan_keys}}),
        dict(name="diag_scan_bwd", route="cuda",
             source="src/repro_torch/csrc/diag_scan.cu",
             replaces="src/repro/kernels/ops.py:85",
             replaces_note="_bwd runs diag_scan_pallas_raw "
                           "(src/repro/kernels/diag_scan.py:57) on flipped "
                           "arrays, then reduces da and dh0 in XLA",
             **count("diag_scan_bwd"),
             max_abs_err=bwd_train["max_abs_err"], tol=bwd_train["tol"],
             worst_err_over_tol=max(r["err_over_tol"] for r in bwd_rows),
             shape=bwd_train["shape"], dtype="float32",
             **{k: bwd_train[k] for k in scan_keys}, library_ms=None,
             f64={"shape": bwd["train-f64"]["shape"],
                  **{k: bwd["train-f64"][k] for k in scan_keys}}),
        dict(name="decode_fused", route="cuda",
             source="src/repro_torch/csrc/diag_scan.cu",
             replaces="src/repro/kernels/diag_scan.py:157",
             **count("decode_fused"),
             max_abs_err=dec["max_abs_err"], tol=dec["tol"],
             worst_err_over_tol=max(r["err_over_tol"] for r in decode_rows),
             shape=dec["shape"],
             **{k: dec[k] for k in keys}, library_ms=None),
        flash_summary(flash_rows, count("flash_attention_fwd"), keys),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
