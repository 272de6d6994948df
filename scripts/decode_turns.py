#!/usr/bin/env python3
"""Time the fused decode kernel (B2) of one checkout of the port on the GPU.

    python3 scripts/decode_turns.py --src path/to/checkout/src [--label NAME]

Imports ``repro_torch`` from ``--src`` (this checkout's ``src`` by default),
builds its kernels, and at the reservoir serving loop's shape (8 slots,
n = 1024: 525 lanes, D = 1, K = 128 steps, float64) prints one JSON line:

* ``kernel_ms``: ``ops.decode_fused`` (split lanes), CUDA events over 50
  back-to-back calls; ``device_ms``: the sum of its kernels' times per call
  in a ``torch.profiler`` window of 20 calls;
* ``run_decode_fused``: the engine's call (``core.dispatch``, packed Q
  layout) — its device kernels per call (count and names), its device ms,
  and its host µs a call (least and median of 10 repeats of 200 calls)
  beside the host µs of one ``torch.add`` in the same run;
* the card's name and power limit.

With ``--mean`` it prints instead the ``ensemble="mean"`` route with
per-slot members (drive, feedback and readout weights a slot) at 525
lanes, D = 1, K = 128, float64, for B in ``MEAN_SLOTS``: ``kernel_ms``,
``device_ms`` and kernels a call as above, µs a step, or the checkout's
refusal (its ValueError) where its layout rule refuses B.

Run two checkouts in turns in one session on one card (parent, change,
change, parent) to compare them; every number is only comparable with the
others of the same session.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def device_kernels(fn, calls=20):
    """(device ms per call, kernels per call, names) of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us = sum(e.time_range.end - e.time_range.start for e in dev)
    names = sorted({e.name[:100] for e in dev})
    return us / 1e3 / calls, len(dev) / calls, names


def host_us(fn, calls=200, repeats=10):
    import torch
    fn()
    per = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return min(per), float(np.median(per))


MEAN_SLOTS = (2, 4, 8, 16, 32, 64, 128)


def kernel_ms(fn, reps=50):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch
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


def mean_rows(ops, nc, k, dev):
    """The ``mean`` route at every B of ``MEAN_SLOTS``, per-slot members."""
    import torch
    rows = []
    for b in MEAN_SLOTS:
        g = torch.Generator().manual_seed(2)

        def r(*shape, s=1.0):
            return (s * torch.randn(shape, generator=g,
                                    dtype=torch.float64)).to(dev)
        lanes = [r(nc, s=0.5), r(nc, s=0.5), r(b, nc), r(b, nc), r(b, 1),
                 r(b, 1, nc, s=0.3), r(b, 1, nc, s=0.3), r(b, 1, 1, s=0.2),
                 r(b, 1, s=0.1), r(b, nc, 1, s=0.5 / nc),
                 r(b, nc, 1, s=0.5 / nc)]
        mask = torch.ones(b, dtype=torch.bool, device=dev)

        def call():
            return ops.decode_fused(*lanes, mask, k=k, ensemble="mean")
        try:
            call()
        except ValueError as e:
            rows.append({"b": b, "refused": str(e)})
            continue
        ms, per_call, _ = device_kernels(call)
        rows.append({"b": b, "kernel_ms": kernel_ms(call), "device_ms": ms,
                     "kernels_per_call": per_call,
                     "us_per_step": ms * 1e3 / k})
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--mean", action="store_true",
                    help="time the ensemble='mean' route at MEAN_SLOTS")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("decode_turns: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import dispatch, esn
    from repro_torch.core.params import ESNConfig
    from repro_torch.kernels import ops

    b, k, dev = 8, 128, "cuda"
    cfg = ESNConfig(n=1024, spectral_radius=0.95, leak=0.9, seed=0)
    p = esn.dpg_params(cfg, "noisy_golden", sigma=0.1, device=dev)
    n = p.lam_q.shape[-1]
    nc = (n + p.n_real) // 2
    g = torch.Generator().manual_seed(1)

    def r(*shape, s=1.0):
        return (s * torch.randn(shape, generator=g,
                                dtype=torch.float64)).to(dev)
    lanes = [r(nc, s=0.5), r(nc, s=0.5), r(b, nc), r(b, nc), r(b, 1),
             r(1, nc, s=0.3), r(1, nc, s=0.3), r(1, 1, s=0.2), r(1, s=0.1),
             r(nc, 1, s=0.5 / nc), r(nc, 1, s=0.5 / nc)]
    mask = torch.ones(b, dtype=torch.bool, device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0] if smi else "nvidia-smi: no output"
    if args.mean:
        print(json.dumps({"label": args.label, "src": args.src,
                          "mean": mean_rows(ops, nc, k, dev),
                          "lanes": nc, "d": 1, "k": k, "dtype": "float64",
                          "card": card}), flush=True)
        return

    def split():
        return ops.decode_fused(*lanes, mask, k=k)
    w_drive = p.win_q + p.wfb_q if cfg.use_feedback else p.win_q
    w_out, states, y_prev = r(1 + n, 1, s=1.0 / n), r(b, n), r(b, 1)

    def packed():
        return dispatch.run_decode_fused(p.lam_q, p.n_real, w_drive, w_out,
                                         states, y_prev, mask, k,
                                         use_bias=True, use_feedback=False)
    split()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        split()
    end.record()
    torch.cuda.synchronize()
    out = {"label": args.label, "src": args.src, "shape": [b, nc, 1, k],
           "dtype": "float64", "kernel_ms": start.elapsed_time(end) / 50}
    out["device_ms"], out["kernels_per_call"], _ = device_kernels(split)
    ms, per_call, names = device_kernels(packed)
    least, median = host_us(packed)
    add = host_us(lambda: torch.add(y_prev, y_prev))
    out["run_decode_fused"] = {
        "device_ms": ms, "kernels_per_call": per_call, "kernels": names,
        "host_us": least, "host_us_median": median,
        "host_us_torch_add": add[0], "host_us_torch_add_median": add[1]}
    out["card"] = card
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
