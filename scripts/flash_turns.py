#!/usr/bin/env python3
"""Time flash attention (B3) of one checkout of the port on the GPU.

    python3 scripts/flash_turns.py --src path/to/checkout/src [--label NAME]
        [--cases d256|f32|all]

Imports ``repro_torch`` from ``--src`` (this checkout's ``src`` by default),
builds its kernels, and prints one JSON line with, per case:

* ``max_abs_err`` / ``lse_max_rel_err`` of ``ops.flash_attention_fwd``
  against ``ref.flash_attention_fwd_ref`` on the same inputs;
* ``ms``: CUDA events over 20 back-to-back calls; ``device_ms``: the sum of
  its kernels' times per call in a ``torch.profiler`` window of 10 calls
  (after a warm-up window, between two spin kernels);
* ``library_ms``: ``scaled_dot_product_attention`` on the same inputs and
  mask (the yardstick; the port never calls it);
* ``bound_ms``: the larger of the bytes (q, k, v read once, out and lse
  written once) over 3.35 TB/s and the visible pairs' flops (4 x head_dim a
  pair) on the tensor cores: float32 as 3xTF32 (3 x the flops at 495
  TFLOP/s), bfloat16 at 989 TFLOP/s (NVIDIA H100 SXM data sheet);

and ptxas's lines of the build (registers, spills) and the card's name and
power limit.  The cases (``--cases``): ``d256`` (the default) are
recurrentgemma-2b's local-attention training launches (batch 2 x 2048: q
(2, 10, 1024, 256) against k / v (2, 1, 1024 or 2048, 256), window 2048;
chunk 0 at q_offset 0, chunk 1 at 1024; float32, and chunk 1 in bfloat16);
``f32`` every float32 launch of a main path of ``chip_smoke.py``: those
two chunks, smollm-135m's two band chunks (q (8, 9, 1024, 64) against k /
v (8, 3, 1024 or 2048, 64), causal), whisper-tiny's encoder (8, 6, 1500,
64, non-causal) and llava-next-mistral-7b's two band chunks (q (2, 32,
1024, 128) against k / v (2, 8, 1024 or 2048, 128), window 4096); ``all``
both.  Run two checkouts in turns in one session on one card
(parent, change, change, parent) to compare them; every number is only
comparable with the others of the same session.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

PEAK_BYTES_S = 3.35e12
PEAK = {"float32": (3, 495e12), "bfloat16": (1, 989e12)}
# name: (b, hq, hkv, sq, skv, d), causal, window, q_offset, dtype
D256 = {
    "local-chunk0": ((2, 10, 1, 1024, 1024, 256), True, 2048, 0, "float32"),
    "local-chunk1": ((2, 10, 1, 1024, 2048, 256), True, 2048, 1024,
                     "float32"),
    "local-chunk1-bf16": ((2, 10, 1, 1024, 2048, 256), True, 2048, 1024,
                          "bfloat16")}
F32 = {
    "chunk0": ((8, 9, 3, 1024, 1024, 64), True, None, 0, "float32"),
    "chunk1": ((8, 9, 3, 1024, 2048, 64), True, None, 1024, "float32"),
    "whisper-encoder": ((8, 6, 6, 1500, 1500, 64), False, None, 0,
                        "float32"),
    "llava-chunk0": ((2, 32, 8, 1024, 1024, 128), True, 4096, 0, "float32"),
    "llava-chunk1": ((2, 32, 8, 1024, 2048, 128), True, 4096, 1024,
                     "float32"),
    "local-chunk0": D256["local-chunk0"], "local-chunk1": D256["local-chunk1"]}
CASES = {"d256": D256, "f32": F32, "all": {**F32, **D256}}


def device_ms(fn, calls=10):
    """Device ms a call and kernel names, from a profiler window that
    follows a warm-up window, the calls between two spin kernels left out
    of the result (the tracer can lose a window's edge kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    dev = []

    def keep(prof):
        dev.extend(e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "spin_kernel" not in e.name)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=keep) as prof:
        for _ in range(2):
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            prof.step()
    us = sum(e.time_range.end - e.time_range.start for e in dev)
    return us / 1e3 / calls, sorted({e.name[:90] for e in dev})


def event_ms(fn, reps=20):
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--cases", choices=sorted(CASES), default="d256")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("flash_turns: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build, ops, ref

    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [line.strip() for line in
             build.build_log("flash_attention").splitlines()
             if "registers" in line or "spill" in line
             or "Compiling" in line]
    smem = build.library("flash_attention").flash_attention_smem_bytes
    out = {"label": args.label, "src": args.src, "build_s": build_s,
           "ptxas": ptxas, "smem_bytes_d256": {"f32": smem(0, 256),
                                               "bf16": smem(1, 256)},
           "cases": {}}
    for name, (shape, causal, window, q_offset, dtype) in \
            CASES[args.cases].items():
        b, hq, hkv, sq, skv, d = shape
        g = torch.Generator().manual_seed(0)
        q = torch.randn((b, hq, sq, d), generator=g)
        k = torch.randn((b, hkv, skv, d), generator=g)
        v = torch.randn((b, hkv, skv, d), generator=g)
        q, k, v = (t.to("cuda", getattr(torch, dtype)) for t in (q, k, v))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        got, lse = ops.flash_attention_fwd(q, k, v, **kw)
        want, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
        mask = ref.attention_mask(sq, skv, device="cuda", **kw)
        passes, peak = PEAK[dtype]
        flops = 4 * d * int(mask.sum()) * b * hq
        nbytes = (q.element_size() * (2 * q.numel() + 2 * k.numel())
                  + 4 * b * hq * sq)
        dms, names = device_ms(lambda: ops.flash_attention_fwd(q, k, v,
                                                               **kw))
        out["cases"][name] = {
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "lse_max_rel_err": float(((lse - want_lse).abs()
                                      / want_lse.abs().clamp(min=1.0)).max()),
            "finite": bool(torch.isfinite(got.float()).all()),
            "ms": event_ms(lambda: ops.flash_attention_fwd(q, k, v, **kw)),
            "device_ms": dms, "kernels": names,
            "library_ms": event_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)),
            "bound_ms": max(passes * flops / peak,
                            nbytes / PEAK_BYTES_S) * 1e3,
            "pair_flops": flops}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out["card"] = smi
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
