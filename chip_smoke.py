#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version at the serving path's shapes, times
both, serves the full-width reservoir workload (n=1024, 8 slots, 16
sessions, 1024-token prompts, 128 closed-loop tokens, float64) through
``repro_torch.launch.serve`` on the card, checks that the path went through
both kernels, and holds the card's engine against the port's CPU engine on
the same 8-session workload.  Any failed phase exits non-zero.  The last
line of standard output is ``{"ok": true, "device": {...}}``; the line
before it lists every kernel with its error, times, bound and launches.

Tolerances: float64 ``max|d| <= 1e-9 * max(1, max|ref|)`` — the kernels
contract multiply-adds into FMAs and sum the readout in another order;
float32 2e-4, as the JAX package's kernel tests.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; flop/s of
#: element-wise work outside the tensor cores, and of contractions, which
#: float64 can run on the tensor cores at twice that rate.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
PEAK_CONTRACT_FLOPS = {"float64": 67e12, "float32": 67e12}
F64_TOL, F32_TOL = 1e-9, 2e-4
SERVE_ARGS = ["--reservoir", "--n", "1024", "--slots", "8", "--sessions",
              "16", "--prompt-len", "1024", "--gen", "128"]


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
          contract_flops: float = 0.0):
    """The larger of the byte time and the operation time; ``flops`` are
    element-wise, ``contract_flops`` those of contractions."""
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = (flops / PEAK_FLOPS[dtype]
             + contract_flops / PEAK_CONTRACT_FLOPS[dtype]) * 1e3
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


def check_diag_scan(ops, ref, copy_bw):
    """Each case through both wrappers of the kernel: ``diag_scan`` (real
    or complex tensors) and ``diag_scan_lanes`` (split lanes, the entry the
    main path calls, and the one timed)."""
    cases = [
        # name, shape, a, complex, h0, dtype, timed
        ("wave", (8, 1024, 525), "static", True, False, "float64", True),
        ("fit", (1, 2000, 525), "static", True, False, "float64", True),
        ("time-a", (3, 77, 130), "time", True, False, "float64", False),
        ("full-a-h0", (2, 50, 20), "full", False, True, "float64", False),
        ("ragged-h0", (5, 333, 257), "static", True, True, "float64", False),
        ("real", (4, 100, 129), "static", False, False, "float64", False),
        ("f32", (4, 256, 300), "static", True, True, "float32", False),
    ]
    rows = []
    for name, shape, a_kind, cplx, with_h0, dtype, timed in cases:
        a, x, h0 = scan_inputs(shape, a_kind, cplx, with_h0, dtype)
        want = ref.diag_scan_ref(a, x, h0)
        lanes = [*split_lanes(a), *split_lanes(x), *split_lanes(h0)]
        got_re, got_im = ops.diag_scan_lanes(*lanes)
        want_re, want_im = split_lanes(want)
        errs = [max_err(ops.diag_scan(a, x, h0), want),
                max_err(got_re, want_re)]
        if cplx:
            errs.append(max_err(got_im, want_im))
        row = {"case": name, "shape": list(shape), "dtype": dtype,
               **worst_of(errs)}
        for e, t in errs:
            if e > t:
                fail(f"diag_scan {name}: max|d| {e:.3e} > {t:.3e}")
        if timed:
            row["ms"] = time_ms(lambda: ops.diag_scan_lanes(*lanes), reps=20)
            row["plain_ms"] = time_ms(lambda: ref.diag_scan_ref(a, x, h0),
                                      reps=2, warmup=1)
            row.update(bound(*scan_cost(a, x, h0), dtype, copy_bw))
        rows.append(row)
        print(json.dumps({"diag_scan": row}), flush=True)
    return rows


def crossover(dispatch, esn, ESNConfig):
    """Kernel vs the chunked torch scan on a serving wave (8 rows, n=1024)
    at T_bucket 256 / 512 / 1024 — where KERNEL_MIN_T should sit."""
    import torch
    p = esn.dpg_params(ESNConfig(n=1024, spectral_radius=0.95, leak=0.9),
                       sigma=0.1, device="cuda")
    out = []
    for t in (256, 512, 1024):
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


def profile_serve(serve):
    """Device time by kernel over the serving loop (warmup + 16 sessions)
    of a freshly built engine, under ``torch.profiler``; the busy share is
    over the loop's wall time inside the profiled window (the profiler's
    own per-op cost included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = serve.build_parser().parse_args(SERVE_ARGS)
    engine, sig, train_t = serve.build_engine(args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.serve_sessions(engine, args, sig, train_t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / wall_ms,
            "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                    for k, (ms, c) in top]}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an "
             "NVIDIA GPU")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        fail(f"the port's sources are missing: no {src / 'repro_torch'}")
    sys.path.insert(0, str(src))
    from repro_torch.core import dispatch, esn
    from repro_torch.core.params import ESNConfig
    from repro_torch.data.signals import mso_series
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ReservoirEngine

    phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(smi_line, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("2 build")
    t0 = time.perf_counter()
    compiled = build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "nvcc_s": compiled}), flush=True)
    for line in build.build_log("diag_scan").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)
    copy_bw = copy_bandwidth()
    print(json.dumps({"copy_bytes_per_s": copy_bw}), flush=True)

    phase("3 diag_scan kernel vs plain")
    scan_rows = check_diag_scan(ops, ref, copy_bw)
    print(json.dumps({"crossover": crossover(dispatch, esn, ESNConfig)}),
          flush=True)

    phase("4 decode_fused kernel vs plain")
    decode_rows = check_decode_fused(ops, ref, copy_bw)

    phase("5 main path: repro_torch.launch.serve " + " ".join(SERVE_ARGS))
    ops.diag_scan.launches = 0
    ops.decode_fused.launches = 0
    res = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    launches = {"diag_scan": ops.diag_scan.launches,
                "decode_fused": ops.decode_fused.launches}
    print(json.dumps({"serve": res, "launches": launches}), flush=True)
    for name, count in launches.items():
        if count < 1:
            fail(f"the main path never launched the {name} kernel")
    if not res["finite"] or res["sessions"] != 16:
        fail(f"serving loop: finite={res['finite']}, "
             f"sessions={res['sessions']} (expected 16)")
    print(json.dumps({"engine_vs_cpu": engine_vs_cpu(
        esn, ESNConfig, mso_series, ReservoirEngine)}), flush=True)
    print(json.dumps({"profile": profile_serve(serve)}), flush=True)

    phase("6 summary")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "copy_bound_ms")
    wave = scan_rows[0]
    fit = scan_rows[1]
    dec = next(r for r in decode_rows if "ms" in r)
    # max_abs_err / tol are those of the timed main-path case;
    # worst_err_over_tol is the largest ratio over every case checked.
    kernels = [
        dict(name="diag_scan", route="cuda",
             source="src/repro_torch/csrc/diag_scan.cu",
             replaces="src/repro/kernels/diag_scan.py:57",
             launches=launches["diag_scan"],
             max_abs_err=wave["max_abs_err"], tol=wave["tol"],
             worst_err_over_tol=max(r["err_over_tol"] for r in scan_rows),
             shape=wave["shape"],
             **{k: wave[k] for k in keys}, library_ms=None,
             fit_shape={"shape": fit["shape"],
                        **{k: fit[k] for k in keys}}),
        dict(name="decode_fused", route="cuda",
             source="src/repro_torch/csrc/diag_scan.cu",
             replaces="src/repro/kernels/diag_scan.py:157",
             launches=launches["decode_fused"],
             max_abs_err=dec["max_abs_err"], tol=dec["tol"],
             worst_err_over_tol=max(r["err_over_tol"] for r in decode_rows),
             shape=dec["shape"],
             **{k: dec[k] for k in keys}, library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
