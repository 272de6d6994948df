#!/usr/bin/env python3
"""Time the fused decode kernel (B2) of one checkout of the port on the GPU.

    python3 scripts/decode_turns.py --src path/to/checkout/src [--label NAME]
        [--shape B NC D] [--mean]

Imports ``repro_torch`` from ``--src`` (this checkout's ``src`` by default),
builds its kernels, and at the reservoir serving loop's shape (8 slots,
n = 1024: 525 lanes, D = 1, K = 128 steps, float64; ``--shape`` another
B, NC, D) prints one JSON line:

* ``kernel_ms``: ``ops.decode_fused`` (split lanes), CUDA events over 50
  back-to-back calls; ``device_ms``: the sum of its kernels' times per call
  in a ``torch.profiler`` window of 20 calls;
* ``run_decode_fused``: the engine's call (``core.dispatch``, packed Q
  layout; the serving profile's DPG model at 525 lanes, else packed
  operands drawn from a seed with NC // 7 real slots) — its device kernels
  per call (count and names), its device ms,
  and its host µs a call (least and median of 10 repeats of 200 calls)
  beside the host µs of one ``torch.add`` in the same run;
* the card's name and power limit.

With ``--mean`` it prints instead the ``ensemble="mean"`` route with
per-slot members (drive, feedback and readout weights a slot) at 525
lanes (``--shape``: NC), D = 1 (D), K = 128, float64, for B in
``MEAN_SLOTS``: ``kernel_ms``,
``device_ms`` and kernels a call as above, µs a step, or the checkout's
refusal (its ValueError) where its layout rule refuses B.

With ``--stream`` it prints instead B2's streamed route
(``ops.decode_stream``, the checkout's layout rule) at each shape of
``STREAM_SHAPES`` (B, NC, D, ensemble, per-slot, dtype; K = 128):
``kernel_ms``, ``device_ms``, kernels a call, µs a step and the layout,
or the checkout's refusal.

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
#: B2's streamed route: main path 23's shape shared and per-slot in
#: float64, per-slot in float32, 16 per-slot mean members of it, 80000
#: lanes, 1100 per-slot mean members, then the shapes past a block's
#: shared memory (D = 1500, 16384 shared mean members of D = 100, D =
#: 5000).
STREAM_SHAPES = [(8, 2562, 64, "off", False, "float64"),
                 (8, 2562, 64, "off", True, "float64"),
                 (8, 2562, 64, "off", True, "float32"),
                 (16, 2562, 64, "mean", True, "float64"),
                 (2, 80000, 1, "off", False, "float64"),
                 (1100, 525, 1, "mean", True, "float64"),
                 (8, 525, 1500, "off", False, "float64"),
                 (16384, 64, 100, "mean", False, "float64"),
                 (8, 525, 5000, "off", False, "float64")]


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


def mean_rows(ops, nc, k, dev, d=1):
    """The ``mean`` route at every B of ``MEAN_SLOTS``, per-slot members."""
    import torch
    rows = []
    for b in MEAN_SLOTS:
        g = torch.Generator().manual_seed(2)

        def r(*shape, s=1.0):
            return (s * torch.randn(shape, generator=g,
                                    dtype=torch.float64)).to(dev)
        lanes = [r(nc, s=0.5), r(nc, s=0.5), r(b, nc), r(b, nc), r(b, d),
                 r(b, d, nc, s=0.3), r(b, d, nc, s=0.3), r(b, d, d, s=0.2),
                 r(b, d, s=0.1), r(b, nc, d, s=0.5 / nc),
                 r(b, nc, d, s=0.5 / nc)]
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


def stream_rows(ops, dsk, k, dev):
    """B2's streamed route at every shape of ``STREAM_SHAPES``."""
    import torch
    rows = []
    for b, nc, d, ensemble, per_slot, dtype in STREAM_SHAPES:
        g = torch.Generator().manual_seed(3)
        dt = getattr(torch, dtype)
        lead = (b,) if per_slot else ()

        def r(*shape, s=1.0):
            return (s * torch.randn(shape, generator=g,
                                    dtype=torch.float64)).to(dt).to(dev)
        lanes = [r(nc, s=0.5), r(nc, s=0.5), r(b, nc), r(b, nc), r(b, d),
                 r(*lead, d, nc, s=0.3), r(*lead, d, nc, s=0.3),
                 r(*lead, d, d, s=0.5 / d), r(*lead, d, s=0.1),
                 r(*lead, nc, d, s=0.5 / nc), r(*lead, nc, d, s=0.5 / nc)]
        mask = torch.ones(b, dtype=torch.bool, device=dev)
        row = {"shape": [b, nc, d, k], "ensemble": ensemble,
               "per_slot": per_slot, "dtype": dtype}

        def call():
            return ops.decode_stream(*lanes, mask, k=k, ensemble=ensemble)
        try:
            call()
        except ValueError as e:
            rows.append(dict(row, refused=str(e)))
            continue
        ms, per_call, _ = device_kernels(call)
        row.update(kernel_ms=kernel_ms(call, reps=20), device_ms=ms,
                   kernels_per_call=per_call, us_per_step=ms * 1e3 / k,
                   layout=dsk.decode_stream_layout(
                       b, nc, d, lanes[0].element_size(), ensemble=ensemble,
                       batched=per_slot)._asdict())
        rows.append(row)
        del lanes
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--mean", action="store_true",
                    help="time the ensemble='mean' route at MEAN_SLOTS")
    ap.add_argument("--stream", action="store_true",
                    help="time B2's streamed route at STREAM_SHAPES")
    ap.add_argument("--shape", nargs=3, type=int, default=(8, 525, 1),
                    metavar=("B", "NC", "D"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("decode_turns: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import dispatch, esn
    from repro_torch.core.params import ESNConfig
    from repro_torch.kernels import ops

    (b, nc, d), k, dev = args.shape, 128, "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0] if smi else "nvidia-smi: no output"
    if args.stream:
        import importlib
        dsk = importlib.import_module("repro_torch.kernels.diag_scan")
        print(json.dumps({"label": args.label, "src": args.src,
                          "stream": stream_rows(ops, dsk, k, dev),
                          "card": card}), flush=True)
        return
    cfg = ESNConfig(n=1024, spectral_radius=0.95, leak=0.9, seed=0)
    if nc == 525:
        p = esn.dpg_params(cfg, "noisy_golden", sigma=0.1, device=dev)
        n, n_real = p.lam_q.shape[-1], p.n_real
        lam_q, w_drive = p.lam_q, p.win_q
    else:
        n_real = nc // 7
        n = 2 * nc - n_real
    g = torch.Generator().manual_seed(1)

    def r(*shape, s=1.0):
        return (s * torch.randn(shape, generator=g,
                                dtype=torch.float64)).to(dev)
    lanes = [r(nc, s=0.5), r(nc, s=0.5), r(b, nc), r(b, nc), r(b, d),
             r(d, nc, s=0.3), r(d, nc, s=0.3), r(d, d, s=0.2), r(d, s=0.1),
             r(nc, d, s=0.5 / nc), r(nc, d, s=0.5 / nc)]
    mask = torch.ones(b, dtype=torch.bool, device=dev)
    if args.mean:
        print(json.dumps({"label": args.label, "src": args.src,
                          "mean": mean_rows(ops, nc, k, dev, d),
                          "lanes": nc, "d": d, "k": k, "dtype": "float64",
                          "card": card}), flush=True)
        return

    def split():
        return ops.decode_fused(*lanes, mask, k=k)
    if nc != 525:
        lam_q = torch.cat([r(n_real, s=0.5), r(n - n_real, s=0.5)])
        w_drive = r(d, n, s=0.3)
    w_out, states, y_prev = r(1 + n, d, s=1.0 / n), r(b, n), r(b, d)

    def packed():
        return dispatch.run_decode_fused(lam_q, n_real, w_drive, w_out,
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
    out = {"label": args.label, "src": args.src, "shape": [b, nc, d, k],
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
