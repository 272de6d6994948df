#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel (the diagonal scan, its backward, the fused decode, flash attention)
against its plain PyTorch version at the main paths' shapes and times both
— the scan kernels also against their chunked plain versions at the chunk
count the launcher picks, with the profiler's device time, the host time
of a call and a sweep of the chunk count, and at the param-batched wave
with one row of coefficients a reservoir; the fused decode through both of
its entries (split lanes, the engine's packed layout), with a sweep of its
warps a row at five shapes, its mean route on a thread-block cluster at 8,
16 and 32 slots (and, at 2, 4 and 8, beside the whole arena in one block),
and the engine's call shown to be one launch — and fails if a decode
instantiation spills; the scan and its backward also with real per-timestep gates
(B, T, N) at the RG-LRU and sLSTM training shapes, and flash attention at
head_dim 256 (recurrentgemma's local layer, both band chunks in float32
and chunk 1 in bfloat16, through the route that splits the head dim
between two warpgroups; its ptxas registers, spills and shared memory are
printed, and a spill fails the build phase), and at whisper-tiny's encoder
(1500 frames, non-causal) and llava-next-mistral-7b's band chunks (GQA
32:8, head_dim 128); then drives the port's nineteen main paths and two
more phases on the card, each with the launch counts set to 0 just before
it and read just after:

1. ``repro_torch.launch.serve --reservoir``: the full-width reservoir
   workload (n=1024, 8 slots, 16 sessions, 1024-token prompts, 128
   closed-loop tokens, float64), held against the port's CPU engine; then
   the same at 16 slots and 32 sessions (the JAX benchmark's mixed-traffic
   arena), held against the CPU engine too;
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
   bfloat16, held against the CPU as path 3 is;
6. the ``LinearESN`` facade at the serving profile (n=1024, float64):
   standard fit, EWT into the diagonalized model, DPG fit, predict and
   ``generate(128)``, held against the port on the CPU;
7. ``repro_torch.launch.serve --reservoir --ensemble mean`` (then
   ``weighted`` and ``independent``): 8 independently seeded reservoirs in
   a param-batched engine — the prefill through B1 with one row of
   coefficients a reservoir, the mean's closed loop through B2's ensemble
   route; ``--slots 16`` and ``--slots 32`` with ``mean`` must decode
   every wave through one B2 launch on its thread-block cluster, no wave
   on the step route; both fused ensembles held against the CPU engine,
   ``mean`` at 8 and 16 slots, the 16-slot wave timed beside the step
   route it took before the cluster;
8. the decode-SLO interleave (two protected decoders, chunked prompts,
   8-token decode waves) bit-exact against the decode-blind schedule on
   the card; main path 1 through the driver under ``--decode-slo 2000
   --chunk-max 256 --decode-wave-tokens 8 --autotune``; a 64-step
   ``decode_step`` / ``observe`` loop against the CPU; and one
   ``profile_dir`` capture whose trace names B2;
9. ``repro_torch.launch.serve --reservoir --park-host-rows 16 --cold-dir
   --snapshot``: the tiered session store at the serving profile (8 hot
   slots, 32 sessions, a 16-row host pool and a cold tier), the snapshot
   restored on the card; the park.restore rotation (every group decode
   pages a parked group in and the hot one out) against the CPU and bit
   for bit against the caller-managed release / resubmit workflow, with
   the pinned copy rates, and its tokens' distance in ULPs from unpaged
   16- and 32-slot engines (the arena-width effect); the pipeline.overlap churn (32 slots, 64 pool
   rows) bit-equal between ``pipeline_depth`` 2 and 0, its overlap demotes
   on the side stream and a profiler window of them; and a snapshot of an
   engine mid-workload restored on the card bit for bit, and one written
   on the CPU restored on the card against the CPU;
10. learn-while-serving: ``repro_torch.launch.serve --reservoir --learn
   --refit-every 64`` at the serving profile (a 1024-token prompt, 2048
   teacher tokens, 32 refit waves; its stream RMSE must not rise, its
   served errors and last readout's predictions held against the CPU's to
   1e-7 of max|y|), again with ``--drift-threshold`` so DPG members grow
   and vote, and the teacher loop's µs a token with learning on and off;
   tenant readout pools through B2 (8 sessions in tenants A and B, A
   refit, one closed-loop launch with the per-slot pool: B bit for bit
   against a twin that never refit A, the whole loop against a CPU engine
   serving the card's pool readouts); the facade-parity replay on the card
   (``tests/torch_facade_parity_workload.py``, 31 arrays to 1e-5: North
   star criterion 3); and a learn snapshot (dirty sessions, an active
   pool) restored on the card bit for bit, one written on the CPU against
   the CPU;
11. ``repro_torch.launch.serve`` with no ``--arch``: its default,
   ``recurrentgemma-2b``, at published widths and depth (26 layers of
   (rglru, rglru, local), d_model 2560, 10 query / 1 KV head of 256, d_ff
   7680, vocab 256000; 3.55 G parameters) in bfloat16 with the float32
   activations its embed scale gives, as in JAX; no kernel runs (an RG-LRU
   decode step is one sequential update, decode attention a dense product)
   and the path fails if one does; a 3-layer full-width model (one period
   of the pattern) on the card, its tokens replayed on the CPU and every
   step's logits held against the CPU's;
12. ``repro_torch.launch.train --arch recurrentgemma-2b --layers 9``: its
   published widths and vocab at 9 layers (three periods: the float32
   params, gradients and AdamW moments of 26 layers would take ~57 GB
   alone), batch 2 x 2048, 5 steps — every RG-LRU scan and its gradient
   through B1 with per-timestep gates, every local layer's two 1024-row
   query chunks through B3 at head_dim 256 (its profiled step must name
   that route's kernel); a 3-layer full-width trainer held against the
   CPU's;
13. ``repro_torch.launch.train --arch xlstm-125m``: the full config (12
   layers of mLSTM / sLSTM, d_model 768, vocab 50304), batch 8 x 2048, 10
   steps — each sLSTM layer's c and n scans and their gradients through
   B1; a 2-layer full-width trainer held against the CPU's;
14. ``repro_torch.launch.serve --arch xlstm-125m``: its bfloat16 decode
   loop at full width (the sLSTM steps through B1), held against the CPU
   replay as paths 3 and 5 are;
15. the open-loop front end (``serve.OpenLoopServer``) at the serving
   profile: 16 sessions arrive on a seeded exponential schedule, each
   submits a 1024-token prompt to an 8-slot engine with a bounded
   admission queue (at least one ``AdmissionFull`` must happen; the
   client retries 1 ms on) and streams 128 tokens; a graceful ``drain()`` ends
   the run; with ``decode_interleave`` off, then on (a decode SLO,
   256-token prefill chunks, 8-token decode waves) on the 16-slot arena,
   where the reference's stall behind a full arena cannot arise (ROADMAP
   C9); every streamed token
   held against the CPU engine on the same sessions; TTFT, inter-token
   p50 / p95, streamed tok/s and a ``torch.add`` of the same run;
16. ``whisper-tiny`` at its published widths (4 encoder and 4 decoder
   layers, d_model 384, 6 heads of 64, d_ff 1536, vocab 51865, 1500
   frames), 10 AdamW steps in float32 through the library ``Trainer`` on
   seeded tokens (8 x 448) and frames (8 x 1500 x 384) — the encoder's
   attention through B3, one launch an encoder layer; a profiled step;
   the whole model's loss and gradients at batch 2 (and again with the
   attention dense on the card) and a prefill plus 8 ``decode_step``s held
   against the CPU;
17. ``repro_torch.launch.train --arch kimi-k2-1t-a32b --d-model 1024
   --layers 1``: kimi's 384 experts, top-8 and expert width 2048 (the MoE
   block, no TPU kernel), batch 8 x 512, 5 steps, with the load-balance
   and router-z losses and the share of assignments dropped; then
   ``--arch arctic-480b --smoke`` through the driver and the loss and
   gradients held against the CPU, and ``launch.serve --arch
   kimi-k2-1t-a32b --smoke`` held against the CPU replay;

then llava-next-mistral-7b's embedding inputs (full width, 2 of 32
layers, float32: one trainer step on 2 x 2048 ``embeds`` with ``labels``,
B3 at GQA 32:8 and head_dim 128; loss and gradients at 2 x 256 held
against the CPU), and the four examples (``examples/torch_*.py``), each as
its own process on its default device; then

18. the sharded slot arena at the serving profile: ``launch.serve
   --reservoir ... --mesh 1x1`` bit-equal to path 1's run without
   ``--mesh``, with path 1's launches; engines on logical (2, 1), (1, 2)
   and (2, 2) meshes of the one card (each cell its own shard and
   launches) serving path 1's 16 sessions against the unsharded card
   engine, one scan launch a cell a prefill wave, one fused decode a data
   shard a closed-loop wave where the model axis is whole and the step
   route where it is split, each mesh's wall beside the unsharded
   engine's; ``--ensemble mean``'s 8 reservoirs on (2, 1) on the step
   route; a (2, 1) snapshot restored unsharded and on (1, 2); and B3's
   float32 output at whisper's encoder against float64;
19. the sharded LM (DTensor over a process group, one spawned process a
   rank; ``LM_MESH_BACKEND`` says why the card's mesh is (1, 1) over
   NCCL): ``linear-esn`` at its published widths and depth, float32,
   AdamW, batch 8 x 1024 — its first step's loss and gradients, then 5
   trainer steps (``Trainer(prof=)``), against the unsharded card run from
   the same seed (losses 1e-5 relative, gradients ``LM_TOL`` of each
   leaf's largest entry), B1 and its backward counted on the rank (12 a
   step each), the wall ms a step beside the unsharded run's;
   ``smollm-135m`` at its published widths and depth, float32, batch 8 x
   2048 — its first step's loss and gradients through B3 on the rank's
   local heads and batch, against the unsharded card step (the same
   limits), B3 counted in each and launched as often on the mesh; and
   kimi-k2's expert-parallel MoE block (384 experts, top-8, expert width
   2048, d_model 1024, 2 x 256 tokens) against the one-device block at
   the MoE check's 2e-3.

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
largest logit allowed).  Paging moves rows with no change of dtype: a
paged engine on the card is held bit for bit against the same workload on
an unpaged engine of its width, a pipelined one against the synchronous
one, and a restored one against the engine it was snapshotted from; the
card against the CPU elementwise at 1e-9 * max(|ref|, 1).  Slice 12's
whole float32 models on the card against the CPU: losses and gradients
leaf by leaf to 1.3e-5 (``TRAINER_TOL``: arctic, llava, and whisper
through B3 and with its attention dense on the card), one forward's or
decode step's logits to 1e-5 of the largest |logit|.  The
sharded arena on the card against the unsharded card engine elementwise
at 1e-9 * max(|ref|, 1) (the readout sums in shard order); B3's float32
output against float64 3e-6.

Bounds: the larger of the bytes (each input read once, each output written
once) over HBM3's 3.35 TB/s and the operations over the rate of the units
that run them (NVIDIA H100 SXM data sheet, dense): 67 TFLOP/s float32 and
34 TFLOP/s float64 outside the tensor cores (float64 contractions 67 on
them); flash attention on the tensor cores, float32 as 3xTF32 (three TF32
products per float32 product at 495 TFLOP/s) and bfloat16 at 989 TFLOP/s.
"""
import dataclasses
import gc
import importlib
import json
import subprocess
import sys
import time
import types
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
SERVE16_ARGS = ["--reservoir", "--n", "1024", "--slots", "16", "--sessions",
                "32", "--prompt-len", "1024", "--gen", "128"]
#: Main path 1 under a decode SLO, planned by an autotuned cost model.
SLO_ARGS = ["--chunk-max", "256", "--decode-slo", "2000",
            "--decode-wave-tokens", "8", "--autotune"]
TRAIN_STEPS = 10
TRAIN_ARGS = ["--arch", "linear-esn", "--vocab", "50304", "--batch", "8",
              "--seq", "1024", "--steps", str(TRAIN_STEPS)]
LM_SERVE_ARGS = ["--arch", "linear-esn", "--batch", "4", "--prompt-len",
                 "64", "--gen", "32"]
SMOLLM_TRAIN_ARGS = ["--arch", "smollm-135m", "--vocab", "49152", "--batch",
                     "8", "--seq", "2048", "--steps", str(TRAIN_STEPS)]
SMOLLM_SERVE_ARGS = ["--arch", "smollm-135m", "--batch", "4", "--prompt-len",
                     "64", "--gen", "32"]
#: Main paths 11-14: the recurrent LM families (recurrentgemma-2b is the
#: serve driver's default arch).
RG_SERVE_ARGS = ["--batch", "4", "--prompt-len", "64", "--gen", "64"]
RG_TRAIN_STEPS = 5
RG_TRAIN_ARGS = ["--arch", "recurrentgemma-2b", "--layers", "9", "--vocab",
                 "256000", "--batch", "2", "--seq", "2048", "--steps",
                 str(RG_TRAIN_STEPS)]
XL_TRAIN_ARGS = ["--arch", "xlstm-125m", "--vocab", "50304", "--batch", "8",
                 "--seq", "2048", "--steps", str(TRAIN_STEPS)]
XL_SERVE_ARGS = ["--arch", "xlstm-125m", "--batch", "4", "--prompt-len",
                 "64", "--gen", "64"]
BF16_TOL, LSE_TOL = 5e-2, 1e-5
#: Slice 12: one float32 forward's or decode step's logits, card against
#: CPU, against the largest |logit| (losses and gradients: ``TRAINER_TOL``).
LM_ONE_TOL = 1e-5
#: Slice 12's trainers, card against CPU: losses and gradients of arctic
#: smoke, llava and whisper-tiny (through B3 and with dense attention).
TRAINER_TOL = 1.3e-5
WHISPER_STEPS, WHISPER_BATCH, WHISPER_SEQ = 10, 8, 448
KIMI_TRAIN_STEPS = 5
#: kimi-k2's published experts (384), top-k (8) and expert width (2048),
#: cut to d_model 1024 and one layer through the driver's own flags: 16
#: heads over kimi's 8 KV heads (768 would give 12, which 8 does not
#: divide).  Its step peaks at ~77.5 GB (params, gradients, AdamW moments
#: and the update's new copies), within the card's 85.
KIMI_TRAIN_ARGS = ["--arch", "kimi-k2-1t-a32b", "--d-model", "1024",
                   "--layers", "1", "--batch", "8", "--seq", "512",
                   "--steps", str(KIMI_TRAIN_STEPS)]
ARCTIC_SMOKE_ARGS = ["--arch", "arctic-480b", "--smoke", "--batch", "4",
                     "--seq", "64", "--steps", "3"]
KIMI_SERVE_ARGS = ["--arch", "kimi-k2-1t-a32b", "--smoke", "--batch", "4",
                   "--prompt-len", "16", "--gen", "16"]
#: llava-next-mistral-7b at full width, 2 of its 32 layers.
LLAVA_LAYERS, LLAVA_BATCH, LLAVA_SEQ, LLAVA_CHECK_SEQ = 2, 2, 2048, 256
#: The port's kernels, by their CUDA function names (profile summaries).
OWN_KERNELS = ("diag_scan_chunk", "diag_scan", "diag_scan_bwd_chunk",
               "diag_scan_bwd", "decode_fused", "flash_attention_fwd",
               "flash_attention_fwd_wide")


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


def wide_route_report(log: str) -> dict:
    """ptxas's registers and spills of each instantiation of the head_dim
    129..256 route (``flash_attention_fwd_wide_kernel<T, heads a block>``)
    in a ``-Xptxas=-v`` log."""
    out, func, spill = {}, None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            func = name if "flash_attention_fwd_wide_kernel" in name else None
        elif func and "spill stores" in line:
            parts = line.split(",")
            spill = (f"{int(parts[1].split()[0])} bytes spill stores, "
                     f"{int(parts[2].split()[0])} loads")
        elif func and "Used" in line and "registers" in line:
            t = "bfloat16" if "nv_bfloat16" in func else "float32"
            heads = func.split("wide_kernelI")[1].split("Li")[1][0]
            out[f"{t}, {heads} head(s) a block"] = {
                "registers": int(line.split("Used")[1].split()[0]),
                "spill": spill}
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
    a_shape = {"static": (n,), "row": (b, 1, n), "time": (t, n),
               "full": (b, t, n)}[a_kind]
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


def cuda_events(fn, calls: int = 20):
    """The device events of ``calls`` calls of ``fn`` in a ``torch.profiler``
    window that follows a warm-up window of as many calls.  The calls sit
    between two spin kernels (``torch.cuda._sleep``), left out of the
    result: the tracer can lose a window's edge kernel (one of 20 decode
    launches, in two runs in a row on torch 2.11)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    got = []

    def keep(prof):
        got.extend(e for e in prof.events()
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
    return got


def kernel_calls(fn, calls: int = 20, windows: int = 1):
    """Device time and CUDA launches per call of ``fn`` in a
    ``torch.profiler`` window of ``calls`` calls: the sum of the port's own
    kernels' times (``OWN_KERNELS``) and their count, each over ``calls``.
    With ``windows`` > 1, a window with fewer of them than calls (the
    tracer dropped some, see ``device_kernels``) is taken again, up to
    ``windows`` in all."""
    for _ in range(windows):
        own = [e for e in cuda_events(fn, calls)
               if any(f"::{n}_kernel" in e.name for n in OWN_KERNELS)]
        if len(own) >= calls:
            break
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
        # the param-batched wave: one row of coefficients per reservoir,
        # static in time ((B, 1, N) lanes read with a time stride of 0)
        ("wave-row-a", (8, 1024, 525), "row", True, False, "float64", True),
        ("fit", (1, 2000, 525), "static", True, False, "float64", True),
        # linear-esn training: B=8, T=1024, d_rnn=1024, complex64 lanes
        ("train", (8, 1024, 1024), "static", True, False, "float32", True),
        # linear-esn LM decode: batch 4, one token, d_rnn 1024, with h0
        ("lm-decode", (4, 1, 1024), "static", True, True, "float32", True),
        # real per-timestep gates (B, T, N): the RG-LRU training shape of
        # recurrentgemma-2b (batch 2 x 2048, d_rnn 2560) and the sLSTM one
        # of xlstm-125m (batch 8 x 2048, d_model 768)
        ("rglru-gates", (2, 2048, 2560), "full", False, False, "float32",
         True),
        ("slstm-gates", (8, 2048, 768), "full", False, False, "float32",
         True),
        # xlstm-125m's serve loop: each sLSTM layer scans c and n one token
        # at a time, gates (4, 1, 768) with the carried state as h0
        ("slstm-decode", (4, 1, 768), "full", False, True, "float32", True),
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
               "h0": with_h0, "chunks": chunks, **worst_of(errs)}
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
        ("rglru-gates", (2, 2048, 2560), "full", False, False, "float32",
         True),
        ("slstm-gates", (8, 2048, 768), "full", False, False, "float32",
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
DECODE_K = 128
#: (B, NC, D) timed and swept in phase 4: the main path's shape, the 16-slot
#: arena, the served model at n = 2048 (1043 lanes), 4096 lanes, 8 outputs.
DECODE_SHAPES = [(8, 525, 1), (16, 525, 1), (8, 1043, 1), (4, 4096, 1),
                 (4, 525, 8)]


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


def packed_decode_inputs(b, nc, d, batched, seed=2):
    """The engine's packed Q operands of the same decode (``lam_q, n_real,
    w_drive, w_out, states, y_prev``): nc // 7 real slots, the rest pairs,
    ``w_out`` rows ``[bias | feedback | states]``."""
    import torch
    rng = np.random.default_rng(seed)
    nr = nc // 7
    npairs = nc - nr
    n = nr + 2 * npairs
    lead = (b,) if batched else ()
    mag = rng.uniform(0.5, 0.95, lead + (npairs,))
    ph = rng.uniform(0, np.pi, lead + (npairs,))
    pairs = np.stack([mag * np.cos(ph), mag * np.sin(ph)], -1).reshape(
        lead + (2 * npairs,))
    lam = np.concatenate([rng.uniform(-0.95, 0.95, lead + (nr,)), pairs], -1)
    w_out = 0.1 * rng.normal(size=lead + (n + 1 + d, d))
    w_out[..., 1 + d:, :] *= 5.0 / n

    def t(v):
        return torch.tensor(v, dtype=torch.float64, device="cuda")
    return (t(lam), nr, t(0.3 * rng.normal(size=lead + (d, n))), t(w_out),
            t(rng.normal(size=(b, n))), t(rng.normal(size=(b, d))))


def device_kernels(fn, calls: int = 20, windows: int = 3):
    """Every device kernel of one call of ``fn`` (names and count per call,
    from a ``torch.profiler`` window of ``calls`` calls).  The tracer can
    drop a window's events (3 of 20 decode launches once on torch 2.11),
    never add any: a window with fewer events than calls is taken again,
    up to ``windows`` in all, and the last one taken is returned."""
    for window in range(1, windows + 1):
        dev = [e.name for e in cuda_events(fn, calls)]
        if len(dev) >= calls:
            break
    return {"kernels_per_call": len(dev) / calls,
            "kernel_names": sorted({n[:100] for n in dev}),
            "windows": window}


#: Slot counts of phase 4's ``mean`` rows on the cluster, and those timed
#: beside the one-block layout (``rows=B``: the whole arena in one block).
MEAN_SLOTS = (8, 16, 32)
MEAN_VS_ONE_BLOCK = (2, 4, 8)


def check_mean_cluster(ops, ref, dsk, copy_bw, spills):
    """B2's ``mean`` route on its thread-block cluster at 525 float64
    lanes, D = 1, K = 128, per-slot and shared operands: against the plain
    version with row 1 frozen (every live row fed back the same y, bit for
    bit), then with every row live its kernel ms (CUDA events), device ms
    and launches a call (profiler; one a call, or the phase fails), µs a
    step, the cluster launched, the bound and the plain version's time; at
    MEAN_VS_ONE_BLOCK slots also the one-block layout's, in the same
    call, and at 16 per-slot rows every W that fits."""
    import torch
    nc, d, k = 525, 1, DECODE_K
    out = []
    for b in sorted(set(MEAN_SLOTS + MEAN_VS_ONE_BLOCK)):
        for batched in (True, False):
            args = decode_inputs(b, nc, d, batched)
            frozen = torch.arange(b, device="cuda") != 1
            live = torch.ones(b, dtype=torch.bool, device="cuda")
            lay = dsk.decode_layout(b, nc, d, 8, ensemble="mean",
                                    batched=batched)
            got = ops.decode_fused(*args, frozen, k=k, ensemble="mean")
            want = ref.decode_fused_ref(*args, frozen, k=k, ensemble="mean")
            errs = [max_err(g, w) for g, w in zip(got, want)]
            case = f"mean-{'per_slot' if batched else 'shared'}-B{b}"
            for e, t in errs:
                if e > t:
                    fail(f"decode_fused {case}: {e:.3e} > {t:.3e}")
            rows = frozen.nonzero()[:, 0]
            if not torch.equal(got[3][:, rows], got[3][:, rows[:1]].expand(
                    -1, len(rows), -1)):
                fail(f"decode_fused {case}: live rows fed back different y")

            def call():
                return ops.decode_fused(*args, live, k=k, ensemble="mean")
            row = {"case": case, "shape": [b, nc, d, k], **worst_of(errs),
                   "fed_back_y": "bit-equal across live rows",
                   "cluster": {"blocks": lay.cluster, "rows_a_block":
                               lay.rows, "warps_a_row": lay.warps,
                               "lanes_a_thread": lay.per,
                               "threads_a_block": lay.threads,
                               "smem_a_block": lay.smem},
                   "ptxas_decode_instantiations_spilling": spills,
                   "ms": time_ms(call, reps=50),
                   **kernel_calls(call, windows=3),
                   "plain_ms": time_ms(lambda: ref.decode_fused_ref(
                       *args, live, k=k, ensemble="mean"), reps=2,
                       warmup=1)}
            if row["cuda_launches_per_call"] != 1:
                fail(f"decode_fused {case}: {row['cuda_launches_per_call']}"
                     f" CUDA launches a call, expected 1")
            row["us_per_step"] = row["device_ms"] * 1e3 / k
            nbytes, flops, cflops = decode_cost(args, live, k)
            row.update(bound(nbytes, flops + k * (b + 1) * d, "float64",
                             copy_bw, contract_flops=cflops))
            if b in MEAN_VS_ONE_BLOCK:
                one = dsk.decode_layout(b, nc, d, 8, ensemble="mean",
                                        batched=batched, rows=b)

                def one_call():
                    return dsk.decode_fused_cuda(*args, live, k=k,
                                                 ensemble="mean", rows=b)
                oerrs = [max_err(g, w) for g, w in zip(
                    dsk.decode_fused_cuda(*args, frozen, k=k,
                                          ensemble="mean", rows=b), want)]
                for e, t in oerrs:
                    if e > t:
                        fail(f"decode_fused {case} in one block: {e:.3e} > "
                             f"{t:.3e}")
                oc = kernel_calls(one_call, windows=3)
                row["one_block"] = {
                    "warps_a_row": one.warps, "threads": one.threads,
                    **worst_of(oerrs), "ms": time_ms(one_call, reps=50),
                    **oc, "us_per_step": oc["device_ms"] * 1e3 / k}
            if b == 16 and batched:
                # The rule takes the fewest warps a row that fit
                # (DECODE_MEAN_AIM_WARPS): every W beside it.
                sweep = {}
                for w in (1, 2, 4, 8, 16):
                    try:
                        dsk.decode_layout(b, nc, d, 8, ensemble="mean",
                                          batched=True, warps=w)
                    except ValueError:
                        sweep[w] = "does not fit"
                        continue
                    sweep[w] = kernel_calls(lambda: dsk.decode_fused_cuda(
                        *args, live, k=k, ensemble="mean", warps=w),
                        windows=3)["device_ms"]
                row["warps_sweep_device_ms"] = sweep
            out.append(row)
            print(json.dumps({"decode_fused_mean": row}), flush=True)
    return out


def check_decode_fused(ops, ref, dsk, dispatch, esn, ESNConfig, copy_bw):
    """B2 at the main path's shape (8 rows, 525 lanes, D = 1, K = 128,
    float64) through both entries — split lanes and the engine's packed
    layout — against their plain versions; then the times: the main case,
    a sweep of W (warps a row) at every shape of ``DECODE_SHAPES`` beside
    the rule's pick, the mean route, and the engine's call
    (``run_decode_fused``: one launch, its host time beside ``torch.add``).
    """
    import torch
    rows = []
    b, nc, d, k = 8, 525, 1, DECODE_K
    main = None
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
                packed = packed_decode_inputs(b, nc, d, batched)
                kw = dict(k=k, use_bias=True, use_feedback=True,
                          ensemble=ensemble)
                got = ops.decode_fused_packed(*packed, mask, **kw)
                want = ref.decode_fused_packed_ref(*packed, mask, **kw)
                errs.update({out: max_err(g, w) for out, g, w in zip(
                    ("packed_states", "packed_y", "packed_ys"), got, want)})
                case = (f"{'3d' if batched else '2d'}-{ensemble}-"
                        f"{'partial' if partial else 'full'}")
                for out, (e, t) in errs.items():
                    if e > t:
                        fail(f"decode_fused {out} ({case}): {e:.3e} > "
                             f"{t:.3e}")
                row = {"case": case, "shape": [b, nc, d, k],
                       **worst_of(list(errs.values())),
                       "per_output": {o: {"max_abs_err": e, "tol": t}
                                      for o, (e, t) in errs.items()}}
                if not batched and ensemble == "off" and not partial:
                    main = (args, mask)
                rows.append(row)
                print(json.dumps({"decode_fused": row}), flush=True)
    # The main path's case: shared weights, every slot live.
    args, mask = main
    row = rows[0]

    def call():
        return ops.decode_fused(*args, mask, k=k)
    layout = dsk.decode_layout(b, nc, d, 8)
    row.update(warps=layout.warps, per=layout.per)
    row["ms"] = time_ms(call, reps=50)
    row.update(kernel_calls(call))
    row["us_per_step"] = row["device_ms"] * 1e3 / k
    row["plain_ms"] = time_ms(lambda: ref.decode_fused_ref(*args, mask, k=k),
                              reps=2, warmup=1)
    nbytes, flops, cflops = decode_cost(args, mask, k)
    row.update(bound(nbytes, flops, "float64", copy_bw,
                     contract_flops=cflops))
    def shared_mean():
        return ops.decode_fused(*args, mask, k=k, ensemble="mean")
    mean = kernel_calls(shared_mean)
    row["mean_route"] = {"warps": dsk.decode_layout(
        b, nc, d, 8, ensemble="mean").warps, **mean,
        "us_per_step": mean["device_ms"] * 1e3 / k,
        "ms": time_ms(shared_mean, reps=50),
        "plain_ms": time_ms(lambda: ref.decode_fused_ref(
            *args, mask, k=k, ensemble="mean"), reps=2, warmup=1)}
    # The mean route with per-slot lambda / wd / w_out (one shared-memory
    # copy of the lane operands a row): the ensemble engine's call.
    bargs = decode_inputs(b, nc, d, True)

    def mean_call():
        return ops.decode_fused(*bargs, mask, k=k, ensemble="mean")
    per_slot = next(r for r in rows if r["case"] == "3d-mean-full")
    mrow = {"shape": [b, nc, d, k], "max_abs_err": per_slot["max_abs_err"],
            "tol": per_slot["tol"], "warps": dsk.decode_layout(
                b, nc, d, 8, ensemble="mean", batched=True).warps,
            "ms": time_ms(mean_call, reps=50), **kernel_calls(mean_call),
            "plain_ms": time_ms(lambda: ref.decode_fused_ref(
                *bargs, mask, k=k, ensemble="mean"), reps=2, warmup=1)}
    mrow["us_per_step"] = mrow["device_ms"] * 1e3 / k
    nbytes, flops, cflops = decode_cost(bargs, mask, k)
    # plus the step's mean over the live rows: a sum and a scale per output
    mrow.update(bound(nbytes, flops + k * (b + 1) * d, "float64", copy_bw,
                      contract_flops=cflops))
    row["mean_per_slot"] = mrow
    # The shapes, each swept over W beside the rule's pick.
    shapes = []
    for sb, snc, sd in DECODE_SHAPES:
        sargs = decode_inputs(sb, snc, sd, False)
        smask = torch.ones(sb, dtype=torch.bool, device="cuda")
        pick = dsk.decode_layout(sb, snc, sd, 8)
        sweep = {}
        for w in (1, 2, 4, 8, 16, 32):
            try:
                dsk.decode_layout(sb, snc, sd, 8, warps=w)
            except ValueError:
                sweep[w] = "does not fit"
                continue
            sweep[w] = kernel_calls(lambda: dsk.decode_fused_cuda(
                *sargs, smask, k=k, warps=w))["device_ms"]
        timed = {w: v for w, v in sweep.items() if isinstance(v, float)}
        best = min(timed, key=timed.get)
        srow = {"shape": [sb, snc, sd, k], "rule_warps": pick.warps,
                "per": pick.per, "device_ms": sweep[pick.warps],
                "us_per_step": sweep[pick.warps] * 1e3 / k,
                "fastest_warps": best, "fastest_device_ms": timed[best],
                "sweep_device_ms": sweep}
        shapes.append(srow)
        print(json.dumps({"decode_fused_shape": srow}), flush=True)
    row["shapes"] = shapes
    # The engine's call at the serving shape: packed Q, one launch.
    cfg = ESNConfig(n=1024, spectral_radius=0.95, leak=0.9, seed=0)
    p = esn.dpg_params(cfg, "noisy_golden", sigma=0.1, device="cuda")
    n = p.lam_q.shape[-1]
    g = torch.Generator().manual_seed(3)
    w_out = (torch.randn((1 + n, 1), generator=g, dtype=torch.float64)
             / n).to("cuda")
    states = torch.randn((b, n), generator=g, dtype=torch.float64).to("cuda")
    y_prev = torch.randn((b, 1), generator=g, dtype=torch.float64).to("cuda")

    def engine_call():
        return dispatch.run_decode_fused(p.lam_q, p.n_real, p.win_q, w_out,
                                         states, y_prev, mask, k,
                                         use_bias=True, use_feedback=False)
    eng = device_kernels(engine_call)
    if eng["kernels_per_call"] != 1 or "decode_fused_kernel" not in \
            eng["kernel_names"][0]:
        fail(f"run_decode_fused is not one decode_fused launch: {eng}")
    eng.update(kernel_calls(engine_call))
    # Its bound: the packed operands read once (lam_q, w_drive, w_out,
    # states, y_prev, mask), states, y_prev and ys written once; the
    # arithmetic of the split-lane call at the same (B, NC, D, K).
    pnc = (n + p.n_real) // 2
    nbytes = 8 * (n + p.win_q.numel() + w_out.numel() + 2 * states.numel()
                  + 2 * y_prev.numel() + k * y_prev.numel()) + mask.numel()
    live = int(mask.sum())
    eng.update(bound(nbytes, k * live * (8 * pnc + 1), "float64", copy_bw,
                     contract_flops=k * live * 8 * pnc))
    eng["host_us"], eng["host_us_median"] = host_us(engine_call)
    eng["host_us_torch_add"] = host_us(lambda: torch.add(y_prev, y_prev))[0]
    eng["ms"] = time_ms(engine_call, reps=50)
    eng["plain_ms"] = time_ms(lambda: ref.decode_fused_packed_ref(
        p.lam_q, p.n_real, p.win_q, w_out, states, y_prev, mask, k=k,
        use_bias=True, use_feedback=False), reps=2, warmup=1)
    row["run_decode_fused"] = eng
    # The tenant pool's operand mix (slice 9): shared lam_q and w_drive, a
    # per-slot (8, 1025, 1) w_out.  Against the plain version, each row bit
    # for bit against a launch serving that row's readout to every row.
    pool = torch.stack([w_out * (1.0 + 0.1 * r) for r in range(b)])

    def pool_call():
        return dispatch.run_decode_fused(p.lam_q, p.n_real, p.win_q, pool,
                                         states, y_prev, mask, k,
                                         use_bias=True, use_feedback=False)
    got = pool_call()
    want = ref.decode_fused_packed_ref(p.lam_q, p.n_real, p.win_q, pool,
                                       states, y_prev, mask, k=k,
                                       use_bias=True, use_feedback=False)
    perrs = [max_err(g_, w_) for g_, w_ in zip(got, want)]
    for e, t in perrs:
        if e > t:
            fail(f"decode_fused with a per-slot w_out: {e:.3e} > {t:.3e}")
    for r in range(b):
        one = dispatch.run_decode_fused(p.lam_q, p.n_real, p.win_q,
                                        pool[r].contiguous(), states, y_prev,
                                        mask, k, use_bias=True,
                                        use_feedback=False)
        if any(not torch.equal(o[..., r, :] if o.ndim == 3 else o[r],
                               g_[..., r, :] if g_.ndim == 3 else g_[r])
               for o, g_ in zip(one, got)):
            fail(f"decode_fused row {r} with the per-slot pool differs from "
                 f"its shared-readout launch")
    prow = {"shape": [b, pnc, d, k], "w_out": [b, 1 + n, d],
            **worst_of(perrs), "rows_vs_shared_launch": "bit-equal",
            "ms": time_ms(pool_call, reps=50), **kernel_calls(pool_call),
            "plain_ms": time_ms(lambda: ref.decode_fused_packed_ref(
                p.lam_q, p.n_real, p.win_q, pool, states, y_prev, mask, k=k,
                use_bias=True, use_feedback=False), reps=2, warmup=1)}
    prow.update(bound(nbytes + 8 * (b - 1) * w_out.numel(),
                      k * live * (8 * pnc + 1), "float64", copy_bw,
                      contract_flops=k * live * 8 * pnc))
    row["tenant_pool"] = prow
    print(json.dumps({"decode_fused_main": row}), flush=True)
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
    # recurrentgemma-2b's local layer in training at batch 2 x 2048: GQA
    # 10:1, head_dim 256 (the route that splits the head dim between two
    # warpgroups), window 2048, both chunks; chunk 1 in bfloat16 as well
    ("local-chunk0", (2, 10, 1, 1024, 1024, 256), True, 2048, 0, None,
     "float32", True),
    ("local-chunk1", (2, 10, 1, 1024, 2048, 256), True, 2048, 1024, None,
     "float32", True),
    ("local-chunk1-bf16", (2, 10, 1, 1024, 2048, 256), True, 2048, 1024,
     None, "bfloat16", True),
    ("local-bf16", (1, 10, 1, 100, 300, 256), True, 150, 200, None,
     "bfloat16", False),
    # whisper-tiny's encoder in training at batch 8 (path 16): 6 heads of
    # 64 over 1500 frames, non-causal; 1500 is no multiple of the key tile
    ("whisper-encoder", (8, 6, 6, 1500, 1500, 64), False, None, 0, None,
     "float32", True),
    # llava-next-mistral-7b's layers at batch 2 x 2048 (the llava phase):
    # GQA 32:8, head_dim 128, window 4096, both band chunks
    ("llava-chunk0", (2, 32, 8, 1024, 1024, 128), True, 4096, 0, None,
     "float32", True),
    ("llava-chunk1", (2, 32, 8, 1024, 2048, 128), True, 4096, 1024, None,
     "float32", True),
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
    bfloat16 as one bf16 product."""
    nbytes, flops = flash_cost(q, k, mask)
    route, passes = (("3xTF32", 3) if dtype == "float32" else ("bf16", 1))
    peak = PEAK_TENSOR_FLOPS["tf32" if dtype == "float32" else "bfloat16"]
    out = bound(nbytes, 0.0, dtype, copy_bw, contract_flops=passes * flops,
                contract_peak=peak)
    out.update(mma_route=route, pair_flops=flops)
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
            row.update(kernel_calls(lambda: ops.flash_attention_fwd(
                q, k, v, **kw)))
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
def serving_profile(ESNConfig):
    """The serving profile of the JAX package's serving benchmark
    (``benchmarks/serve_engine.py``): n = 1024, float64."""
    return ESNConfig(n=1024, spectral_radius=0.95, leak=0.9,
                     input_scaling=0.5, ridge_alpha=1e-8, seed=0)


def engine_vs_cpu(esn, ESNConfig, mso_series, ReservoirEngine, slots=8):
    """The same ``slots``-session workload (one wave, 1024-token prompts,
    128 closed-loop tokens) through an engine of ``slots`` slots on the card
    and on the CPU, one params/readout pair for both (a second ridge fit
    would amplify last-bit state differences through its conditioning)."""
    import torch
    cfg = serving_profile(ESNConfig)
    sig = mso_series(3, 2001)
    p = esn.dpg_params(cfg, "noisy_golden", sigma=0.1, device="cpu")
    ro = esn.fit(p, sig[:-1, None], sig[1:, None], washout=100)
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 2000 - 1024, size=slots)
    outs = {}
    for device in ("cuda", "cpu"):
        eng = ReservoirEngine(p, slots, readout=ro, device=device)
        for sid, lo in enumerate(starts):
            eng.submit(sid, sig[lo:lo + 1024, None])
        eng.flush()
        ys = eng.decode_closed_loop(128)
        outs[device] = {sid: (ys[sid], *eng.release(sid))
                        for sid in range(slots)}
    worst = {k: {"max_abs_err": 0.0, "tol": 0.0, "max_rel_err": 0.0,
                 "rel_tol": F64_TOL} for k in ("ys", "state", "y_prev")}
    for sid in range(slots):
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


def release_cache():
    """Hand the allocator's cached blocks back to the card.  A training run
    of recurrentgemma-2b (~59 GB at its peak) does not fit beside the
    blocks that the paths before it left cached."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def profile_train_step(train, Trainer, TrainConfig, MarkovTokens,
                       argv=TRAIN_ARGS):
    """Device time by kernel over one full-width training step (the main
    path's configuration), after one untimed step."""
    args = train.build_parser().parse_args(argv)
    cfg = train.arch_config(args)
    data = MarkovTokens(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq)
    return profile_arch_step(cfg, data, Trainer, TrainConfig, lr=args.lr)


def leaf_rel(got, want):
    """max|got - want| / max|want| of one leaf."""
    d = float((got.cpu() - want).abs().max())
    scale = float(want.abs().max())
    return d / scale if scale else (0.0 if d == 0 else float("inf"))


def leafwise(got, want):
    """max over leaves of max|got - want| / max|want| (flattened trees)."""
    worst, worst_key = 0.0, None
    for k, w in want.items():
        r = leaf_rel(got[k], w)
        if r >= worst:
            worst, worst_key = r, k
    return worst, worst_key


def lm_trainer_vs_cpu(lm, loss_and_grads, Trainer, TrainConfig,
                      MarkovTokens, get_config, tree, arch="linear-esn",
                      batch=2, seq=256, n_layers=2):
    """An ``n_layers`` ``arch`` at full width (vocab 512), ``batch`` x
    ``seq`` tokens: the first step's gradients and three AdamW steps' losses
    on the card against the CPU, from the same weights
    (``lm_params_from_numpy``)."""
    import dataclasses
    import torch
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
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
    res = {"n_layers": n_layers, "batch": data.batch, "seq": seq,
           "losses_cuda": l_gpu, "losses_cpu": l_cpu,
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


def lm_serve_vs_cpu(serve, res, argv=LM_SERVE_ARGS, n_layers=None,
                    dtype="bfloat16"):
    """The serve loop on the card (``res``, the main path's run; a config
    of ``dtype``) against the CPU: the same weights and prompts
    (``serve.lm_setup``), the card's tokens fed to the CPU loop (teacher
    forcing, so a near-tie that the two devices break apart cannot part
    their paths), every step's logits held to ``BF16_LM_TOL`` (bfloat16)
    or ``LM_TOL`` (float32) of the step's largest |logit|; the share of
    steps whose greedy token the CPU picks too is reported.  With
    ``n_layers`` (an arch whose full depth is too slow to replay on the
    host) ``res`` is None: the model is cut to that depth at full width,
    from the same seeds, and its card run is made here."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.models import lm
    args = serve.build_parser().parse_args(argv)
    if n_layers is None:
        cfg, params, prompts = serve.lm_setup(args, "cpu")
    else:
        cfg = dataclasses.replace(serve.get_config(args.arch),
                                  n_layers=n_layers)
        params = lm.init_params(torch.Generator().manual_seed(args.seed), cfg,
                                "cpu")
        prompts = torch.as_tensor(np.random.default_rng(args.seed).integers(
            0, cfg.vocab, size=(args.batch, args.prompt_len)))
        res = serve.generate(tree.tree_map(lambda v: v.to("cuda"), params),
                             cfg, prompts.to("cuda"), args.gen,
                             seed=args.seed + 1)
    cpu = serve.generate(params, cfg, prompts, args.gen, seed=args.seed + 1,
                         forced=res["tokens"])
    tol = BF16_LM_TOL if dtype == "bfloat16" else LM_TOL
    rel = step_errors(res["step_logits"], cpu["step_logits"])
    out = {"n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "prompt_len": args.prompt_len, "gen": args.gen,
           "max_rel_err": max(rel), "mean_rel_err": float(np.mean(rel)),
           "tol": tol, "steps": len(rel),
           "same_greedy_token_share": float(np.mean(
               res["tokens"] == cpu["tokens"])),
           "card_decode_tok_s": args.batch * args.gen / res["decode_s"],
           "cpu_decode_tok_s": args.batch * args.gen / cpu["decode_s"]}
    if cfg.dtype != dtype or max(rel) > tol or not np.isfinite(rel).all():
        fail(f"{cfg.name} serve on the card vs the CPU replay: {out}")
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


def train_path(drive, launches, train, path, argv, steps, expect):
    """One training main path through ``train.main(argv)`` with its peak
    memory; fails unless every step ran and stayed finite and each kernel
    of ``expect`` launched the count given (per step x steps)."""
    import torch
    release_cache()
    torch.cuda.reset_peak_memory_stats()
    res = drive(path, lambda: train.main(argv), tuple(expect))
    out = {k: res[k] for k in ("arch", "params", "batch", "seq", "steps_run",
                               "losses", "ms_per_step", "tokens_per_s",
                               "finite")}
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({path: out, "launches": launches[path]}), flush=True)
    if not res["finite"] or res["steps_run"] != steps:
        fail(f"{path}: finite={res['finite']}, steps={res['steps_run']}")
    for name, per_step in expect.items():
        got = launches[path][name]
        if got != per_step * steps:
            fail(f"{path} launched {name} {got} times, expected "
                 f"{per_step} a step x {steps}")
    return out


# --------------------------------------------------------------------------- #
# Phases 14-16: the facade, the param-batched ensembles, observe / interleave  #
# --------------------------------------------------------------------------- #
def traj_err(got, want, name):
    """Fail unless ``got`` is finite and within ``F64_TOL`` of ``want``,
    max-scaled and element by element against max(|ref|, 1)."""
    import torch
    got, want = got.detach().cpu(), want.detach().cpu()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: not finite")
    err, tol = max_err(got, want)
    rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
    if err > tol or rel > F64_TOL:
        fail(f"{name}: max|d| {err:.3e} (tol {tol:.3e}), elementwise "
             f"{rel:.3e} (tol {F64_TOL:.0e})")
    return {"max_abs_err": err, "tol": tol, "max_rel_err": rel}


def readout_err(model, w_card, u, name):
    """A readout ridge-fitted on the card against the CPU model's own: the
    predictions each gives on the CPU model's features of the rows it was
    fitted on (``u[100:2000]``, after the washout) agree to 1e-5 of their
    largest value.  The weights themselves are not compared (reported
    only): at ridge_alpha 1e-8 the systems are ill-conditioned (cond(G)
    ~1e20 standard, ~1e105 DPG), and the two devices' solves part along
    near-null directions that the training rows do not see and the
    washout and later rows do (ROADMAP C3)."""
    x = model.features(model.run(u))[100:2000]
    w_cpu, w_card = model.w_out, w_card.detach().cpu()
    want, got = x @ w_cpu, x @ w_card
    err = float((got - want).abs().max())
    tol = 1e-5 * float(want.abs().max())
    if not err <= tol:
        fail(f"{name}: predictions of the two readouts part by {err:.3e} "
             f"> {tol:.3e}")
    return {"max_abs_err": err, "tol": tol,
            "weights_max_rel_diff": float((w_card - w_cpu).abs().max()
                                          / w_cpu.abs().max())}


def wall_ms(fn, reps: int = 3):
    """Least host wall time of ``fn`` over ``reps`` calls, each ending in a
    synchronise (a host-bound loop's time is its wall time)."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return min(out)


def facade_path(esn, ESNConfig, mso_series):
    """The ``LinearESN`` facade at the serving profile on the card:
    standard fit, EWT into the diagonalized model, DPG fit (B1 at the fit
    shape), predictions and ``generate(128)``.  Returns the card's models
    and outputs."""
    cfg = serving_profile(ESNConfig)
    sig = mso_series(3, 2601)
    u, y = sig[:-1, None], sig[1:, None]
    std = esn.LinearESN.standard(cfg, device="cuda").fit(u[:2000], y[:2000],
                                                         washout=100)
    dia = esn.LinearESN.diagonalized(cfg, device="cuda").ewt_from(std)
    dpg = esn.LinearESN.dpg(cfg, sigma=0.1, device="cuda").fit(
        u[:2000], y[:2000], washout=100)
    return {"std": std, "dia": dia, "dpg": dpg,
            "p_std": std.predict(u), "p_dia": dia.predict(u),
            "p_dpg": dpg.predict(u),
            "gen": dpg.generate(128, u[:2000], y[:2000])}


def facade_vs_cpu(esn, ESNConfig, mso_series, card):
    """The facade on the card against the port on the CPU: readouts at
    1e-5 (of the predictions they give); the EWT equivalence (standard vs diagonalized predictions) on the
    card at 1e-5; predictions and generate(128) from the card's readout at
    1e-9 max(|ref|, 1); and the card's times."""
    cfg = serving_profile(ESNConfig)
    sig = mso_series(3, 2601)
    u, y = sig[:-1, None], sig[1:, None]
    std = esn.LinearESN.standard(cfg, device="cpu").fit(u[:2000], y[:2000],
                                                        washout=100)
    dia = esn.LinearESN.diagonalized(cfg, device="cpu").ewt_from(std)
    dpg = esn.LinearESN.dpg(cfg, sigma=0.1, device="cpu").fit(
        u[:2000], y[:2000], washout=100)
    out = {"readout_std": readout_err(std, card["std"].w_out, u,
                                      "standard readout"),
           "readout_ewt": readout_err(dia, card["dia"].w_out, u,
                                      "EWT readout"),
           "readout_dpg": readout_err(dpg, card["dpg"].w_out, u,
                                      "DPG readout")}
    p_std = card["p_std"].cpu()
    ewt = float((card["p_dia"].cpu() - p_std).abs().max())
    out["ewt_equivalence"] = {"max_abs_err": ewt,
                              "tol": 1e-5 * float(p_std.abs().max())}
    if not ewt <= out["ewt_equivalence"]["tol"]:
        fail(f"EWT on the card: standard vs diagonalized predictions "
             f"{out['ewt_equivalence']}")
    dpg.w_out = card["dpg"].w_out.cpu()
    out["predict"] = traj_err(card["p_dpg"], dpg.predict(u), "DPG predict")
    out["generate_128"] = traj_err(card["gen"],
                                   dpg.generate(128, u[:2000], y[:2000]),
                                   "generate(128)")
    truth = sig[2001:2129]
    out["generate_rmse_vs_signal"] = float(np.sqrt(np.mean(
        (card["gen"][:, 0].cpu().numpy() - truth) ** 2)))
    m = card["dpg"]
    out["card_ms"] = {
        "dpg_fit_2000": wall_ms(lambda: m.fit(u[:2000], y[:2000],
                                              washout=100)),
        "predict_2600": wall_ms(lambda: m.predict(u)),
        "generate_128": wall_ms(lambda: m.generate(128, u[:2000], y[:2000])),
        "generate_128_warmup_run": wall_ms(lambda: m.run(u[:2000]))}
    return out


ENS_ARGS = ["--reservoir", "--n", "1024", "--slots", "8", "--prompt-len",
            "1024", "--gen", "128"]


def ensemble_vs_cpu(esn, ESNConfig, mso_series, ReservoirEngine, ensemble,
                    slots=8):
    """A param-batched engine (``slots`` dpg reservoirs at the serving
    profile, readouts fitted on the card) on the card and the CPU: prefill
    slots x 1024 (B1 with per-row coefficients), one open-loop step,
    ``observe``, 128 closed-loop tokens (``mean``: B2's ensemble route on
    its thread-block cluster; ``weighted``: the step-at-a-time path) —
    held at 1e-9 max(|ref|, 1); with the card's time of the closed loop
    and, for ``mean``, of the same 128-token wave on the step route
    (``arena.closed_loop``, which ``mean`` past 8 slots took before the
    cluster) from the same arena."""
    import dataclasses
    import torch
    from repro_torch.core.params import Readout, stack_params
    from repro_torch.kernels import ops
    from repro_torch.serve import arena as arena_mod
    cfg = serving_profile(ESNConfig)
    sig = mso_series(3, 2601)
    u, y = sig[:-1, None], sig[1:, None]
    ps = [esn.dpg_params(dataclasses.replace(cfg, seed=i), "noisy_golden",
                         sigma=0.1, device="cuda") for i in range(slots)]
    ro = Readout(torch.stack([esn.fit(p, u[:2000], y[:2000],
                                      washout=100).w_out for p in ps]))
    params = stack_params(ps)
    outs, res = {}, {"slots": slots}
    for device in ("cuda", "cpu"):
        eng = ReservoirEngine.from_param_batch(params, ro, ensemble=ensemble,
                                               device=device)
        if ensemble == "weighted":
            eng.set_ensemble_weights(np.linspace(0.5, 2.0, slots))
        for i in range(slots):
            eng.submit(i, sig[16 * i:16 * i + 1024, None])
        eng.flush()
        step = eng.decode_step({i: sig[1100 + i, None]
                                for i in range(slots)})
        eng.observe(3, [0.5])
        counts = ops.decode_fused.launches
        ys = eng.decode_closed_loop(128)
        if device == "cuda":
            torch.cuda.synchronize()
            res["decode_fused_launches_in_closed_loop"] = (
                ops.decode_fused.launches - counts)
            res["decode_waves_by_route"] = eng.stats().decode_waves_by_route
            res["closed_loop_128_ms"] = wall_ms(
                lambda: eng.decode_closed_loop(128))
            if ensemble == "mean":
                p, w, a = eng.params, eng.w_out, eng.arena
                mask = torch.ones(slots, dtype=torch.bool, device="cuda")
                res["wave_128_fused_ms"] = wall_ms(
                    lambda: arena_mod.closed_loop_fused(
                        p, w, a, mask, 128, batched=True, ensemble="mean"))
                res["wave_128_step_route_ms"] = wall_ms(
                    lambda: arena_mod.closed_loop(
                        p, w, a, mask, 128, batched=True, ensemble="mean"))
        outs[device] = ([torch.as_tensor(step[i]) for i in range(slots)],
                        [ys[i] for i in range(slots)], eng)
    for name, i in (("step", 0), ("ys", 1)):
        errs = [traj_err(g, w, f"{ensemble} ensemble {name} {j}")
                for j, (g, w) in enumerate(zip(outs["cuda"][i],
                                               outs["cpu"][i]))]
        res[name] = max(errs, key=lambda e: e["max_rel_err"])
    return res


#: The interleave phase's decode SLO (microseconds of prefill cost, planned
#: and on the wall, between a protected session's decode waves).
INTERLEAVE_SLO_US = 1500.0


def interleave_path(esn, ESNConfig, mso_series, ReservoirEngine, drive):
    """Decode-SLO interleave at the serving profile on the card: 8 slots,
    two protected decoders, four 1024-token prompts in 256-token chunks,
    8-token decode waves.  Prefill outputs equal the decode-blind engine's
    and the interleaved tokens equal 1-token closed-loop calls of it, bit
    for bit (the wave order only differs)."""
    import torch
    cfg = serving_profile(ESNConfig)
    sig = mso_series(3, 2601)
    p = esn.dpg_params(cfg, "noisy_golden", sigma=0.1, device="cuda")
    ro = esn.fit(p, sig[:2000, None], sig[1:2001, None], washout=100)

    def build(slo):
        kw = {} if slo is None else dict(decode_slo_us=slo,
                                         decode_wave_tokens=8)
        e = ReservoirEngine(p, 8, readout=ro, device="cuda", chunk_max=256,
                            **kw)
        e.submit("d0", sig[:300, None])
        e.submit("d1", sig[50:350, None])
        e.flush()
        e.decode_closed_loop(1)
        e.collect_decoded()
        for i in range(4):
            e.submit(("f", i), sig[100 * i:100 * i + 1024, None])
        return e
    aware, blind = build(INTERLEAVE_SLO_US), build(None)
    ra = drive("serve_interleave",
               lambda: aware.flush(decode_interleave=True, want_outputs=True),
               ("diag_scan", "decode_fused"))
    rb = blind.flush(want_outputs=True)
    for sid in rb:
        if not torch.equal(ra[sid], rb[sid]):
            fail(f"interleaved prefill of {sid} differs from the blind one")
    st = aware.stats()
    if st.decode_interleave_waves < 1:
        fail("the SLO flush ran no interleaved decode wave")
    res = aware.collect_decoded()
    n_tok = int(res["d0"].shape[0])
    for i in range(n_tok):
        ys = blind.decode_closed_loop(1, sids=["d0", "d1"])
        for sid in ("d0", "d1"):
            if not torch.equal(res[sid][i:i + 1], ys[sid]):
                fail(f"interleaved token {i} of {sid} differs from the "
                     f"1-token closed loop")
    waves_us = [w["us"] for w in res.waves]
    return {"decode_interleave_waves": st.decode_interleave_waves,
            "interleaved_tokens": n_tok, "decode_wave_tokens": 8,
            "prefill_waves": st.waves_total,
            "decode_gap_p50_us": st.decode_gap_p50_us,
            "decode_gap_p95_us": st.decode_gap_p95_us,
            "interleave_wave_us_min": min(waves_us),
            "interleave_wave_us_median": float(np.median(waves_us)),
            "slo_us": INTERLEAVE_SLO_US, "bit_exact": True}


def observe_vs_cpu(esn, ESNConfig, mso_series, ReservoirEngine):
    """64 open-loop ``decode_step`` tokens with ``observe`` after each on
    one of two sessions, on the card and the CPU from one params/readout:
    outputs and states at 1e-9 max(|ref|, 1)."""
    import torch
    cfg = serving_profile(ESNConfig)
    sig = mso_series(3, 2601)
    p = esn.dpg_params(cfg, "noisy_golden", sigma=0.1, device="cpu")
    ro = esn.fit(p, sig[:2000, None], sig[1:2001, None], washout=100)
    outs = {}
    for device in ("cuda", "cpu"):
        eng = ReservoirEngine(p, 8, readout=ro, device=device)
        eng.submit("a", sig[:512, None])
        eng.submit("b", sig[300:812, None])
        eng.flush()
        rows = []
        for t in range(64):
            got = eng.decode_step({"a": sig[512 + t, None],
                                   "b": sig[812 + t, None]})
            eng.observe("a", sig[513 + t, None])
            rows.append(torch.as_tensor(np.stack([got["a"], got["b"]])))
        outs[device] = (torch.stack(rows), eng.states.cpu(),
                        eng.y_prev.cpu())
    return {name: traj_err(g, w, f"observe loop {name}") for name, g, w in
            zip(("outputs", "states", "y_prev"), outs["cuda"], outs["cpu"])}


def profile_capture(esn, ESNConfig, mso_series, ReservoirEngine):
    """One ``profile_dir`` capture around 16 closed-loop decode waves of 8
    tokens on an 8-slot engine: its Chrome trace must exist and name B2's
    kernel.  The card's profiler windows drop some kernel records (B3's
    windows caught 15-18 of 20 launches, PERF.md), so the window holds 16
    launches and the count captured is reported."""
    import shutil
    cfg = serving_profile(ESNConfig)
    sig = mso_series(3, 2601)
    p = esn.dpg_params(cfg, "noisy_golden", sigma=0.1, device="cuda")
    ro = esn.fit(p, sig[:2000, None], sig[1:2001, None], washout=100)
    out_dir = Path(__file__).resolve().parent / "build" / "profile_capture"
    shutil.rmtree(out_dir, ignore_errors=True)
    eng = ReservoirEngine(p, 8, readout=ro, device="cuda",
                          profile_dir=str(out_dir))
    for i in range(8):
        eng.submit(i, sig[16 * i:16 * i + 1024, None])
    eng.flush()
    with eng.tracker.capture("decode"):
        for _ in range(16):
            eng.decode_closed_loop(8)
    traces = sorted(out_dir.glob("decode.*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"profile_dir capture wrote {len(traces)} traces: {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    b2 = [e for e in events if "decode_fused_kernel" in e.get("name", "")]
    if not b2:
        fail(f"the capture's trace {traces[0].name} does not name B2 "
             f"({len(events)} events)")
    return {"trace": traces[0].name, "events": len(events),
            "decode_fused_kernel_events": len(b2), "launched": 16}


# --------------------------------------------------------------------------- #
# Phase 17: main path 9, the tiered session store                             #
# --------------------------------------------------------------------------- #
#: Main path 9: the paged reservoir server at the serving profile — 8 hot
#: slots, 32 sessions, a 16-row host pool and a cold tier (the JAX
#: benchmark's park.restore geometry, ``benchmarks/serve_engine.py:455-496``).
PAGED_ARGS = ["--reservoir", "--n", "1024", "--slots", "8", "--sessions",
              "32", "--prompt-len", "1024", "--gen", "128",
              "--park-host-rows", "16"]
PAGED_DIR = Path(__file__).resolve().parent / "build" / "paged"


def fresh_dir(name: str) -> str:
    """An empty directory under ``build/paged`` (gitignored)."""
    import shutil
    d = PAGED_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return str(d)


def pinned_rates():
    """Pinned host <-> device copy rates on one card: CUDA events around 20
    ``non_blocking`` copies of a page wave's rows (8 x 1025 float64, 65.6
    KB) and of 64 MiB."""
    import torch
    out = {}
    for name, numel in (("page_wave_8x1025_f64", 8 * 1025),
                        ("64MiB", 8 << 20)):
        h = torch.ones(numel, dtype=torch.float64, pin_memory=True)
        d = torch.empty(numel, dtype=torch.float64, device="cuda")
        h2d = time_ms(lambda: d.copy_(h, non_blocking=True), reps=20)
        d2h = time_ms(lambda: h.copy_(d, non_blocking=True), reps=20)
        out[name] = {"bytes": numel * 8, "h2d_us": h2d * 1e3,
                     "d2h_us": d2h * 1e3,
                     "h2d_gb_s": numel * 8 / (h2d * 1e-3) / 1e9,
                     "d2h_gb_s": numel * 8 / (d2h * 1e-3) / 1e9}
    return out


def torch_add_us():
    """Host µs of one ``torch.add`` on the card in this call (the yardstick
    beside every host-side time)."""
    import torch
    a = torch.ones(1024, device="cuda")
    least, median = host_us(lambda: torch.add(a, a))
    return {"least": least, "median": median}


def served_model(esn, ESNConfig, mso_series):
    """The serving profile's DPG reservoir and its readout, fitted on the
    CPU (one pair for the card and the CPU engines), and the signal."""
    cfg = serving_profile(ESNConfig)
    sig = mso_series(3, 2601)
    p = esn.dpg_params(cfg, "noisy_golden", sigma=0.1, device="cpu")
    return p, esn.fit(p, sig[:2000, None], sig[1:2001, None],
                      washout=100), sig


def park_rotation(p, ro, sig, ReservoirEngine, device, drive=None, *,
                  host_rows=16, cold=True, pipeline_depth=2):
    """The park.restore rotation: 32 sessions of 1024-token prompts through
    8 slots, a 16-row pool and a cold tier; then ``decode_closed_loop(32)``
    round-robin over the 4 groups of 8, 2 laps — every group decode pages
    a parked group in (here always from the cold tier) and the hot one out.
    Returns the tokens by session and each lap's numbers."""
    import torch
    eng = ReservoirEngine(p, 8, readout=ro, park_host_rows=host_rows,
                          cold_dir=(fresh_dir(f"rotation_{device}_{host_rows}"
                                              f"_{pipeline_depth}")
                                    if cold else None),
                          pipeline_depth=pipeline_depth, device=device)
    starts = np.random.default_rng(0).integers(0, 2000 - 1024, size=32)
    groups = [[("park", g * 8 + i) for i in range(8)] for g in range(4)]
    toks = {}

    def run():
        for s, lo in enumerate(starts):
            eng.submit(("park", s), sig[lo:lo + 1024, None])
        eng.flush()
        tiers = eng.store.stats()
        laps = []
        for lap in range(2):
            if device == "cuda":
                torch.cuda.synchronize()
            eng._agg.promote_us.clear()
            st0, t0 = eng.stats(), time.perf_counter()
            for grp in groups:
                out = eng.decode_closed_loop(32, sids=grp)
                for sid in grp:
                    toks.setdefault(sid, []).append(out[sid])
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = eng.stats()
            promotes = list(eng._agg.promote_us)
            demotes = st.demote_waves - st0.demote_waves
            laps.append({
                "wall_ms": wall * 1e3, "tok_s": 32 * 32 / wall,
                "promote_waves": st.promote_waves - st0.promote_waves,
                "demote_waves": demotes,
                "page_rows": st.page_rows_total - st0.page_rows_total,
                "promote_us_p95": st.promote_us_p95,
                "promote_us_median": float(np.median(promotes)),
                "demote_us_per_wave": (st.page_us_sum - st0.page_us_sum
                                       - sum(promotes)) / max(demotes, 1)})
            eng.collect_decoded()
        return {"tiers_after_admission": tiers, "laps": laps}

    res = run() if drive is None else drive(
        "park_restore", run, ("diag_scan", "decode_fused"))
    return {sid: torch.cat(v) for sid, v in toks.items()}, res


def manual_rotation(p, ro, sig, ReservoirEngine, slots=8):
    """The caller-managed workflow of the same rotation on an unpaged
    engine of ``slots`` slots on the card: release every session after its
    group's prefill, then per group decode resubmit the held states, decode
    32 tokens and release again (``tests/test_session_store.py:116-167``).
    Its waves are the paged engine's (8 rows) at any width."""
    import torch
    eng = ReservoirEngine(p, slots, readout=ro, device="cuda")
    starts = np.random.default_rng(0).integers(0, 2000 - 1024, size=32)
    groups = [[("park", g * 8 + i) for i in range(8)] for g in range(4)]
    held, toks = {}, {}
    for grp in groups:
        for sid in grp:
            lo = starts[sid[1]]
            eng.submit(sid, sig[lo:lo + 1024, None])
        eng.flush()
        for sid in grp:
            held[sid] = tuple(eng.release(sid))
    for _ in range(2):
        for grp in groups:
            for sid in grp:
                eng.submit(sid, h0=held[sid][0], y0=held[sid][1])
            eng.flush()
            out = eng.decode_closed_loop(32, sids=grp)
            for sid in grp:
                toks.setdefault(sid, []).append(out[sid])
                held[sid] = tuple(eng.release(sid))
    return {sid: torch.cat(v) for sid, v in toks.items()}


def resident_rotation(p, ro, sig, ReservoirEngine):
    """The rotation's decodes on an unpaged 32-slot engine on the card that
    holds every session resident: one flush admits all 32 prompts (one
    32-row prefill wave), then the same round-robin group decodes."""
    import torch
    eng = ReservoirEngine(p, 32, readout=ro, device="cuda")
    starts = np.random.default_rng(0).integers(0, 2000 - 1024, size=32)
    groups = [[("park", g * 8 + i) for i in range(8)] for g in range(4)]
    for s, lo in enumerate(starts):
        eng.submit(("park", s), sig[lo:lo + 1024, None])
    eng.flush()
    toks = {}
    for _ in range(2):
        for grp in groups:
            out = eng.decode_closed_loop(32, sids=grp)
            for sid in grp:
                toks.setdefault(sid, []).append(out[sid])
    return {sid: torch.cat(v) for sid, v in toks.items()}


def ulps(got, want):
    """How far two float64 token sets lie apart: tokens that differ, the
    most units in the last place between two of them (on the ordered
    integer image of the bits), and the elementwise error against the 1e-9
    tolerance (``traj_err``)."""
    import torch
    diff, most, worst = 0, 0, 0.0

    def ordered(t):
        i = t.detach().cpu().contiguous().view(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFFFFFFFFFF), i)

    for sid in want:
        d = (ordered(got[sid]) - ordered(want[sid])).abs()
        diff += int((d > 0).sum())
        most = max(most, int(d.max()))
        worst = max(worst, traj_err(got[sid], want[sid],
                                    f"arena width {sid}")["max_rel_err"])
    return {"tokens": sum(int(t.numel()) for t in want.values()),
            "differing": diff, "max_ulps": most, "max_rel_err": worst}


def park_restore_path(esn, ESNConfig, mso_series, ReservoirEngine, drive):
    """The rotation on the card against the port on the CPU (1e-9
    elementwise) and against the caller-managed workflow on the card (bit
    for bit), with lap 2's tok/s, promote p95, demote µs a wave and page
    rows beside the pinned copy rates and ``torch.add``."""
    import torch
    p, ro, sig = served_model(esn, ESNConfig, mso_series)
    card, res = park_rotation(p, ro, sig, ReservoirEngine, "cuda", drive)
    tiers = res["tiers_after_admission"]
    if (tiers["host"], tiers["cold"]) != (16, 8):
        fail(f"park.restore tiers after admission: {tiers}, expected 16 "
             f"host and 8 cold")
    cpu, _ = park_rotation(p, ro, sig, ReservoirEngine, "cpu")
    manual = manual_rotation(p, ro, sig, ReservoirEngine)
    # Arena width on the card: the paged 8-slot rotation's tokens against
    # an unpaged 16-slot engine with the same 8-row waves, and against an
    # unpaged 32-slot engine that never parks (one 32-row wave: B1 cuts it
    # into fewer time chunks, ``scan_chunks``).  Measured, not assumed.
    width = {"unpaged_16_slots_8_row_waves": ulps(manual_rotation(
                 p, ro, sig, ReservoirEngine, slots=16), card),
             "resident_32_slots_32_row_wave": ulps(resident_rotation(
                 p, ro, sig, ReservoirEngine), card)}
    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for sid in card:
        e = traj_err(card[sid], cpu[sid], f"rotation {sid} card vs CPU")
        worst["max_abs_err"] = max(worst["max_abs_err"], e["max_abs_err"])
        worst["max_rel_err"] = max(worst["max_rel_err"], e["max_rel_err"])
        if not torch.equal(card[sid], manual[sid]):
            fail(f"rotation {sid}: paged tokens differ from the "
                 f"caller-managed release / resubmit workflow")
    for lap in res["laps"]:
        if lap["promote_waves"] != 4 or lap["demote_waves"] != 4:
            fail(f"rotation lap paged {lap['promote_waves']} promote / "
                 f"{lap['demote_waves']} demote waves, expected 4 / 4")
    # Where a page wave's time goes: the same rotation with the cold tier's
    # I/O inline (a synchronous engine: no I/O lane), and with a pool of 32
    # rows and no cold tier (no file I/O at all); tokens bit-equal.
    variants = {}
    for name, kw in (("sync_io", dict(pipeline_depth=0)),
                     ("host_tier_only", dict(host_rows=32, cold=False))):
        toks, vres = park_rotation(p, ro, sig, ReservoirEngine, "cuda", **kw)
        if any(not torch.equal(toks[s], card[s]) for s in card):
            fail(f"rotation variant {name} differs from the lane's tokens")
        variants[name] = vres["laps"][1]
    return {**res, "vs_cpu": worst, "vs_manual_workflow": "bit-equal",
            "arena_width_vs_paged_8": width,
            "variants_lap2": variants, "pinned_copy": pinned_rates(),
            "torch_add_us": torch_add_us()}


def churn(eng, prompts, rounds=16, grp=8):
    """The pipeline.overlap churn (``benchmarks/serve_engine.py:498-556``):
    each round admits a fresh group of 8 prompts; every 4th round decodes
    its group for 4 tokens.  Returns the tokens and the states."""
    eng.reset()
    toks = {}
    for r in range(rounds):
        for i in range(grp):
            eng.submit((r, i), prompts[(r * grp + i) % len(prompts)])
        eng.flush()
        if r % 4 == 3:
            eng.decode_closed_loop(4, sids=[(r, i) for i in range(grp)])
            toks.update(eng.collect_decoded().tokens)
    eng.store.drain_io()
    states = {(r, i): eng.state_of((r, i)) for r in range(rounds)
              for i in range(grp)}
    return toks, states


def overlaps(prof):
    """Device intervals of one profiler window: the fast path's D2H copies
    into pinned memory, B1's launches, and the copies that ran while a B1
    launch was on the device."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    d2h = [e.time_range for e in dev
           if "DtoH" in e.name and "Pinned" in e.name]
    b1 = [e.time_range for e in dev if "diag_scan" in e.name]
    hit = [c for c in d2h if any(c.start < s.end and s.start < c.end
                                 for s in b1)]
    return {"d2h_copies": len(d2h), "b1_launches": len(b1),
            "d2h_during_b1": len(hit),
            "d2h_during_b1_us": sum(c.end - c.start for c in hit),
            "d2h_names": sorted({e.name for e in dev if "DtoH" in e.name})}


def overlap_path(esn, ESNConfig, mso_series, ReservoirEngine, drive):
    """The churn at the serving profile on the card, 32 slots over a 64-row
    pool and a cold tier: ``pipeline_depth=2`` with the I/O lane against
    ``pipeline_depth=0, io_workers=0`` — tokens and states bit-equal, the
    overlap fast path taken; both walls (3 turns each, after a warm-up of
    each) and the pipelined engine's ``host_block_us``; one profiler window
    over a pipelined run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    p, ro, sig = served_model(esn, ESNConfig, mso_series)
    prompts = [sig[37 * i:37 * i + 1024, None] for i in range(24)]
    engines = {d: ReservoirEngine(p, 32, readout=ro, park_host_rows=64,
                                  pipeline_depth=depth, device="cuda",
                                  cold_dir=fresh_dir(f"overlap_{d}"))
               for d, depth in ((2, 2), (0, 0), ("2_sync_io", 2))}
    if engines[0].store.io_workers != 0 or engines[2].store.io_workers < 1:
        fail("the synchronous engine must get a synchronous store")
    # A measurement variant: the pipelined engine with the cold tier's I/O
    # inline, which separates the I/O lane's cost from the window's.
    engines["2_sync_io"].store.io_workers = 0
    out = drive("pipeline_overlap", lambda: churn(engines[2], prompts),
                ("diag_scan", "decode_fused"))
    churn(engines[0], prompts)
    churn(engines["2_sync_io"], prompts)
    walls = {d: [] for d in engines}
    for _ in range(3):
        for d in engines:
            st0 = engines[d].stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = churn(engines[d], prompts)
            torch.cuda.synchronize()
            st = engines[d].stats()
            walls[d].append({
                "wall_ms": (time.perf_counter() - t0) * 1e3,
                "host_block_us": st.host_block_us - st0.host_block_us,
                "overlap_demotes": st.overlap_demotes - st0.overlap_demotes,
                "demote_waves": st.demote_waves - st0.demote_waves})
            if d == 0:
                ref = res
            elif d == 2:
                pipe = res
        (ta, sa), (tb, sb) = pipe, ref
        if ta.keys() != tb.keys() or any(
                not torch.equal(ta[s], tb[s]) for s in ta) or any(
                not np.array_equal(sa[s], sb[s]) for s in sa):
            fail("pipelined churn differs from the synchronous churn")
    if min(w["overlap_demotes"] for w in walls[2]) < 1:
        fail(f"the pipelined churn took no overlap demote: {walls[2]}")
    if any(w["overlap_demotes"] for w in walls[0]):
        fail("the synchronous churn took the overlap fast path")
    for s in out[0]:
        if not torch.equal(out[0][s], ta[s]):
            fail(f"the counted pipelined run differs at {s}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        churn(engines[2], prompts)
        torch.cuda.synchronize()
    return {"pipelined": walls[2], "synchronous": walls[0],
            "pipelined_sync_io": walls["2_sync_io"],
            "bit_exact": True, "profile": overlaps(prof)}


def snapshot_path(esn, ESNConfig, mso_series, ReservoirEngine):
    """Snapshot on the card an engine with hot sessions, parked sessions in
    both tiers, a queued prompt and uncollected tokens; restore it on the
    card and resume both bit for bit.  Then a snapshot written on the CPU
    restored on the card, against the CPU continuation (1e-9
    elementwise).  The snapshot's and the restore's wall ms."""
    import torch
    p, ro, sig = served_model(esn, ESNConfig, mso_series)
    sids = [f"s{i}" for i in range(10)]

    def build(device):
        eng = ReservoirEngine(p, 3, readout=ro, park_host_rows=4,
                              cold_dir=fresh_dir(f"snap_cold_{device}"),
                              device=device)
        for i, sid in enumerate(sids):
            eng.submit(sid, sig[50 * i:50 * i + 256, None])
        eng.flush()
        for sid in sids[:4]:
            eng.decode_closed_loop(2, sids=[sid])
        eng.submit("queued", sig[900:1156, None])
        tiers = {eng.store.tier_of(s) for s in eng.store.sids}
        if tiers != {"host", "cold"} or len(eng.pending) != 1:
            fail(f"snapshot engine: tiers {tiers}, queued {len(eng.pending)}")
        return eng

    def resume(eng):
        buf = eng.collect_decoded().tokens
        out = [buf[s] for s in sids[:4]]
        eng.flush()
        return out + [eng.decode_closed_loop(3, sids=[s])[s]
                      for s in sids + ["queued"]]

    card = build("cuda")
    t0 = time.perf_counter()
    path = card.snapshot(fresh_dir("snap_card") + "/engine")
    snap_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    restored = ReservoirEngine.restore(path, device="cuda")
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    for i, (a, b) in enumerate(zip(resume(card), resume(restored))):
        if not torch.equal(a, b):
            fail(f"restored card engine differs at output {i}")
    cpu = build("cpu")
    from_cpu = ReservoirEngine.restore(
        cpu.snapshot(fresh_dir("snap_cpu") + "/engine"), device="cuda")
    errs = [traj_err(b, a, f"CPU snapshot on the card, output {i}")
            for i, (a, b) in enumerate(zip(resume(cpu), resume(from_cpu)))]
    return {"snapshot_ms": snap_ms, "restore_ms": restore_ms,
            "card_restore": "bit-equal",
            "cpu_snapshot_on_card_max_rel_err": max(
                e["max_rel_err"] for e in errs),
            "epoch_after_restore": restored.store.epoch}


LEARN_ARGS = ["--reservoir", "--n", "1024", "--slots", "8", "--prompt-len",
              "1024", "--gen", "1537", "--learn", "--refit-every", "64"]
#: ``--gen 1537`` sizes the driver's signal (prompt + gen + 512 steps) so
#: 2048 teacher tokens (the demo's min(16 gen, what the signal holds)) fit
#: after the 1024-token prompt: 32 refit waves of 64 tokens.
LEARN_TOKENS = 2048
#: A drift threshold below any stream RMSE here: every refit grows a member
#: until the cap (``growth_max_members=3``).
GROWTH_ARGS = LEARN_ARGS + ["--drift-threshold", "1e-12"]
#: Readout predictions on the card against the CPU's, of max |y| (cond(G)
#: ~1e20 at n = 1024: fitted weights part by percents, predictions do not).
PRED_TOL = 1e-7


def pred_err(got, want, scale, name):
    """Fail unless ``got`` (predictions) is within ``PRED_TOL * scale`` of
    ``want``; returns the error over the scale."""
    got, want = np.asarray(got), np.asarray(want)
    if not np.isfinite(got).all():
        fail(f"{name}: not finite")
    err = float(np.abs(got - want).max()) / scale
    if err > PRED_TOL:
        fail(f"{name}: max|d| / max|y| = {err:.3e} > {PRED_TOL:.0e}")
    return err


def learn_driver_path(serve, esn, ESNConfig, drive):
    """Path 10a: the ``--learn`` driver on the card and on the CPU (the same
    argv), then with DPG growth on the card.  The served errors of every
    token (each refit wave's readout serves the next 64) and the last
    readout's predictions on the teacher rows, card against CPU."""
    import torch
    card = drive("serve_learn", lambda: serve.main(LEARN_ARGS),
                 ("diag_scan",))
    cpu = serve.main(LEARN_ARGS + ["--device", "cpu"])
    for res in (card, cpu):
        if (not res["finite"] or res["teacher_tokens"] != LEARN_TOKENS
                or res["refit_waves"] != 32 or res["refit_rows"] != 32):
            fail(f"learn driver: {dict((k, res[k]) for k in keys_of(res, LEARN_KEEP))}")
        if not res["rmse_second_half"] <= res["rmse_first_half"]:
            fail(f"learn driver: stream RMSE rose from "
                 f"{res['rmse_first_half']:.3e} to "
                 f"{res['rmse_second_half']:.3e}")
    cfg = serving_profile(ESNConfig)
    from repro_torch.data.signals import mso_series
    p_len = 1024
    sig = mso_series(3, p_len + 1537 + 512 + 1)
    p = esn.dpg_params(cfg, "noisy_golden", sigma=0.1, device="cpu")
    x = esn.features(p, esn.run(p, sig[:p_len + LEARN_TOKENS, None]))
    x = x[p_len:]
    y_max = float(np.abs(sig).max())
    # Each refit wave's readout against the CPU's, by its predictions on
    # the teacher rows it was fit on.  Out of sample the two part: the
    # early waves fit 64k rows of 1025 features (cond(G) past 1e20), and
    # the served errors of each device's own base fit part too (recorded).
    every = int(LEARN_ARGS[LEARN_ARGS.index("--refit-every") + 1])
    waves = [pred_err(x[:every * (i + 1)] @ wc.cpu(), x[:every * (i + 1)]
                      @ wp, y_max, f"learn driver refit wave {i}")
             for i, (wc, wp) in enumerate(zip(card["refit_readouts"],
                                              cpu["refit_readouts"]))]
    half = LEARN_TOKENS // 2
    errs = {"refit_predictions_worst_wave": max(waves),
            "refit_predictions_last_wave": waves[-1],
            "served_errors_first_half": float(np.abs(
                card["errors"][:half] - cpu["errors"][:half]).max()) / y_max,
            "served_errors_second_half": float(np.abs(
                card["errors"][half:] - cpu["errors"][half:]).max()) / y_max}
    growth = drive("serve_learn_growth", lambda: serve.main(GROWTH_ARGS),
                   ("diag_scan",))
    if not (1 <= growth["growth_events"] <= 3) or not growth["finite"]:
        fail(f"learn driver with --drift-threshold: growth "
             f"{growth['growth_events']}, finite {growth['finite']}")
    keep = LEARN_KEEP
    torch.cuda.synchronize()
    return {"card": {k: card[k] for k in keys_of(card, keep)},
            "cpu": {k: cpu[k] for k in keys_of(cpu, keep)},
            "refit_us_per_wave": card["refit_ms"] * 1e3 / card["refit_waves"],
            "card_vs_cpu_over_max_y": errs,
            "growth": {k: growth[k] for k in keys_of(growth, keep)},
            "growth_extra_us_per_token": growth["us_per_token"]
            - card["us_per_token"]}


LEARN_KEEP = ("teacher_tokens", "rmse_first_half", "rmse_second_half",
              "refit_waves", "refit_rows", "refit_ms", "drift_rmse",
              "growth_events", "wall_s", "us_per_token", "finite")


def keys_of(res, keep):
    return [k for k in keep if k in res]


def teacher_loop_us(p, ro, sig, ReservoirEngine, learn, tokens=512):
    """µs of host wall a teacher token (``decode_step`` + ``observe``, no
    refit) for one session on an 8-slot card engine, learning on or off,
    after 64 warm-up tokens."""
    import torch
    eng = ReservoirEngine(p, 8, readout=ro, learn=learn, device="cuda")
    eng.submit("s", sig[:1024, None])
    eng.flush()
    t0 = None
    for t in range(1024, 1024 + 64 + tokens):
        if t == 1024 + 64:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        eng.decode_step({"s": sig[t, None]})
        eng.observe("s", sig[t + 1, None])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / tokens * 1e6


def fold_us(eng, rows=64, reps=20):
    """µs of one refit fold of ``rows`` buffered teacher rows on the card
    (one upload, the λ-weighted batched Gram), median of ``reps``."""
    import torch
    from repro_torch.serve.learn import _GramAcc
    ln, n = eng._learn_plane, eng.cfg.n
    rng = np.random.default_rng(0)
    h = list(rng.normal(size=(rows, n)))
    y = list(rng.normal(size=(rows, 1)))
    times = []
    for _ in range(reps + 1):
        acc = _GramAcc(buf_h=list(h), buf_fb=[None] * rows, buf_y=list(y))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ln._fold_acc(acc, eng.params)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(times[1:]))


def tenant_engine(p, ro, sig, ReservoirEngine, device, refit_a):
    """8 slots, 8 sessions of 1024-token prompts (one prefill wave), tenants
    A (sessions 0-3) and B (4-7); 256 teacher tokens each; with
    ``refit_a`` a refit of A's sessions.  Returns the engine."""
    eng = ReservoirEngine(p, 8, readout=ro, learn=True, device=device)
    starts = [37 * i for i in range(8)]
    for i, lo in enumerate(starts):
        eng.submit(i, sig[lo:lo + 1024, None], tenant="A" if i < 4 else "B")
    eng.flush()
    for t in range(1024, 1024 + 256):
        eng.decode_step({i: sig[lo + t, None]
                         for i, lo in enumerate(starts)})
        for i, lo in enumerate(starts):
            eng.observe(i, sig[lo + t + 1, None])
    if refit_a:
        for i in range(4):
            if set(eng.refit(i)) != {i}:
                fail(f"refit({i}) re-solved other sessions")
    return eng


def tenant_pool_path(esn, ESNConfig, mso_series, ReservoirEngine, drive,
                     launches):
    """Path 10b: tenant pools through B2 at the serving profile.  B's 128
    closed-loop tokens and next ``decode_step`` bit for bit against a twin
    that never refit A; the card's closed loop against a CPU engine given
    the card's states and pool readouts (1e-9 elementwise); launches B1 1
    (the prefill wave) and B2 1 (the closed loop).  Then refit µs of one
    8-row wave and the fold's µs."""
    import torch
    p, ro, sig = served_model(esn, ESNConfig, mso_series)
    twin = tenant_engine(p, ro, sig, ReservoirEngine, "cuda", False)
    twin_loop = twin.decode_closed_loop(128)
    twin_step = twin.decode_step({i: sig[2000, None] for i in range(8)})

    def run():
        eng = tenant_engine(p, ro, sig, ReservoirEngine, "cuda", True)
        seed = {i: (eng.state_of(i), eng.y_prev[eng.sessions[i].slot].cpu(),
                    eng.sessions[i].slot) for i in range(8)}
        return eng, seed, eng.decode_closed_loop(128)
    eng, seed, loop = drive("tenant_pools", run,
                            ("diag_scan", "decode_fused"))
    got = launches["tenant_pools"]
    if (got["diag_scan"], got["decode_fused"]) != (1, 1):
        fail(f"tenant pools launched B1 {got['diag_scan']} / B2 "
             f"{got['decode_fused']} times, expected 1 / 1")
    if eng._exec._slot_w is None or eng._exec._slot_w.shape != (8, 1025, 1):
        fail("the tenant pool is not the (8, 1025, 1) per-slot readout")
    step = eng.decode_step({i: sig[2000, None] for i in range(8)})
    for i in range(4, 8):
        if not torch.equal(loop[i], twin_loop[i]) or not np.array_equal(
                step[i], twin_step[i]):
            fail(f"tenant B session {i} moved when tenant A was refit")
    cpu = ReservoirEngine(p, 8, readout=ro, device="cpu")
    for i, (h, y0, slot) in seed.items():
        cpu.submit(i, h0=h, y0=y0, slot=slot, tenant="A" if i < 4 else "B")
    cpu.set_readout("A", eng.readout_for(0).cpu())
    want = cpu.decode_closed_loop(128)
    worst = max(traj_err(loop[i], want[i], f"tenant pool loop {i}")
                ["max_rel_err"] for i in range(8))
    st0 = twin.stats()
    twin.refit()                       # all 8 dirty: one 8-row wave
    st = twin.stats()
    if st.refit_rows_total - st0.refit_rows_total != 8:
        fail("the 8-session refit was not one 8-row wave")
    return {"b_vs_twin": "bit-equal (128 closed-loop tokens, 1 step)",
            "loop_vs_cpu_max_rel_err": worst,
            "refit_us_1_row_waves": (eng.stats().refit_us_sum / 4),
            "refit_us_8_rows": st.refit_us_sum - st0.refit_us_sum,
            "fold_us_64_rows": fold_us(twin)}


def facade_replay_path(drive):
    """Path 10c: the facade-parity workload through the card engine, all
    31 reference arrays to 1e-5 with equal NaN patterns."""
    tests = Path(__file__).resolve().parent / "tests"
    sys.path.insert(0, str(tests))
    import torch_facade_parity_workload as workload
    ref_arrays = np.load(workload.REF_PATH)
    t0 = time.perf_counter()
    got = drive("facade_replay", lambda: workload.run_workload("cuda"),
                ("diag_scan", "decode_fused"))
    wall = (time.perf_counter() - t0) * 1e3
    try:
        worst = workload.compare(got, ref_arrays, atol=1e-5)
    except AssertionError as e:
        fail(f"facade replay on the card: {e}")
    return {"arrays": len(ref_arrays.files), "max_abs_err": worst,
            "tol": 1e-5, "wall_ms": wall}


def learn_snapshot_path(esn, ESNConfig, mso_series, ReservoirEngine):
    """Path 10d: a card engine mid-stream (3 learning sessions, tenant A
    refit so the pool is live, B dirty) snapshotted and restored on the
    card; both continue 64 teacher tokens and a refit, bit for bit.  Then
    the same written on the CPU and restored on the card: the teacher
    tokens' outputs against the CPU (1e-9 elementwise), the refit readouts
    by their predictions on the buffered rows (``PRED_TOL`` of max|y|)."""
    import torch
    p, ro, sig = served_model(esn, ESNConfig, mso_series)
    sids = ("a0", "a1", "b0")

    def build(device):
        eng = ReservoirEngine(p, 3, readout=ro, learn=True, device=device)
        for i, sid in enumerate(sids):
            eng.submit(sid, sig[50 * i:50 * i + 256, None],
                       tenant=sid[0].upper())
        eng.flush()
        for t in range(256, 320):
            eng.decode_step({s: sig[50 * i + t, None]
                             for i, s in enumerate(sids)})
            for i, s in enumerate(sids):
                eng.observe(s, sig[50 * i + t + 1, None])
        eng.refit("a0")
        return eng

    def resume(eng):
        outs = []
        for t in range(320, 384):
            got = eng.decode_step({s: sig[50 * i + t, None]
                                   for i, s in enumerate(sids)})
            outs.append(torch.as_tensor(np.stack([got[s] for s in sids])))
            for i, s in enumerate(sids):
                eng.observe(s, sig[50 * i + t + 1, None])
        ln = eng._learn_plane
        rows = {s: np.stack(ln.state[s].acc.buf_h) for s in sids}
        w = eng.refit()
        return torch.stack(outs), {s: w[s].cpu() for s in w}, rows

    card = build("cuda")
    if card._exec._slot_w is None or not card.stats().sessions_dirty:
        fail("learn snapshot: the pool is not live or no session is dirty")
    t0 = time.perf_counter()
    path = card.snapshot(fresh_dir("learn_snap_card") + "/engine")
    snap_ms = (time.perf_counter() - t0) * 1e3
    restored = ReservoirEngine.restore(path, device="cuda")
    (oa, wa, _), (ob, wb, _) = resume(card), resume(restored)
    if not torch.equal(oa, ob) or wa.keys() != wb.keys() or any(
            not torch.equal(wa[s], wb[s]) for s in wa):
        fail("restored learn engine differs from the engine written from")
    cpu = build("cpu")
    from_cpu = ReservoirEngine.restore(
        cpu.snapshot(fresh_dir("learn_snap_cpu") + "/engine"), device="cuda")
    (oc, wc, rows), (od, wd, _) = resume(cpu), resume(from_cpu)
    err = traj_err(od, oc, "CPU learn snapshot on the card")
    y_max = float(np.abs(sig).max())
    pred = 0.0
    for s in wc:
        x = np.concatenate([np.ones((len(rows[s]), 1)), rows[s]], 1)
        pred = max(pred, pred_err(x @ wd[s].numpy(), x @ wc[s].numpy(),
                                  y_max, f"learn snapshot refit {s}"))
    return {"snapshot_ms": snap_ms, "card_restore": "bit-equal",
            "cpu_snapshot_on_card_max_rel_err": err["max_rel_err"],
            "cpu_snapshot_refit_predictions_over_max_y": pred}


# --------------------------------------------------------------------------- #
# Phases 23-27 (slice 12): the open-loop front end, whisper-tiny, the MoE     #
# LMs, llava's embedding inputs, the examples                                  #
# --------------------------------------------------------------------------- #
FE_SESSIONS, FE_PROMPT, FE_DECODE, FE_SLOTS = 16, 1024, 128, 8
#: With ``decode_interleave`` on, the reference's front end stops for good
#: once a request queues while every slot holds a session that still owes
#: tokens (ROADMAP C9, reproduced by the port): that run serves the 16
#: sessions on the 16-slot arena (the JAX benchmark's mixed-traffic
#: arena), where every queued request finds a slot at the next flush.
FE_SLOTS_INTERLEAVE = 16
#: The bounded admission queue: 8 sessions hold the slots and 4 more may
#: wait; an arrival past that meets ``AdmissionFull`` and retries 1 ms on.
FE_MAX_QUEUED = 4
FE_MEAN_GAP_S = 0.002
FE_SLO_US = 2000.0


def frontend_workload(n_sessions=FE_SESSIONS, prompt=FE_PROMPT, seed=15):
    """Seeded prompt starts in the signal and exponential arrival times
    (s after the start, mean gap ``FE_MEAN_GAP_S``)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, 2000 - prompt, size=n_sessions)
    return starts, np.cumsum(rng.exponential(FE_MEAN_GAP_S, size=n_sessions))


def percentiles(xs):
    return {"p50": float(np.percentile(xs, 50)),
            "p95": float(np.percentile(xs, 95))} if len(xs) else None


def frontend_run(p, ro, sig, ReservoirEngine, OpenLoopServer, AdmissionFull,
                 interleave, device="cuda", n_sessions=FE_SESSIONS,
                 prompt=FE_PROMPT, n_decode=FE_DECODE, slots=FE_SLOTS,
                 max_queued=FE_MAX_QUEUED):
    """Main path 15: ``n_sessions`` clients arrive on the seeded schedule,
    each submits its prompt to an ``OpenLoopServer`` over a bounded engine
    (retrying on ``AdmissionFull``) and streams ``n_decode`` tokens; the
    run ends with a graceful ``drain()``.  With ``interleave`` the engine
    holds a decode SLO and prefills in 256-token chunks, decoding 8-token
    waves between them."""
    import asyncio
    starts, arrivals = frontend_workload(n_sessions, prompt)
    kw = (dict(decode_slo_us=FE_SLO_US, decode_wave_tokens=8, chunk_max=256)
          if interleave else {})
    eng = ReservoirEngine(p, slots, readout=ro, device=device,
                          max_queued=max_queued, **kw)
    rejected = []

    async def client(server, sid, t0):
        lo = int(starts[sid])
        await asyncio.sleep(max(0.0, t0 + arrivals[sid] - time.perf_counter()))
        t_arrive = time.perf_counter()
        while True:
            try:
                h = await server.submit(sid, sig[lo:lo + prompt, None],
                                        n_decode=n_decode)
                break
            except AdmissionFull:
                rejected.append(sid)
                await asyncio.sleep(0.001)
        return t_arrive, h, await h.tokens()

    async def serve():
        server = OpenLoopServer(eng, decode_interleave=interleave)
        await server.start()
        t0 = time.perf_counter()
        runs = await asyncio.gather(*(client(server, s, t0)
                                      for s in range(n_sessions)))
        await server.drain()
        return runs, time.perf_counter() - t0

    runs, wall = asyncio.run(serve())
    ttft, itl, tokens = [], [], {}
    for sid, (t_arrive, h, toks) in enumerate(runs):
        # With interleave on, one flush may stream a session past its
        # quota (ROADMAP C9): at least n_decode, in order.
        if [t.index for t in toks] != list(range(len(toks))) or \
                len(toks) < n_decode or (len(toks) > n_decode and
                                         not interleave):
            fail(f"front end: session {sid} streamed {len(toks)} tokens, "
                 f"not {n_decode}")
        tokens[sid] = np.stack([t.y for t in toks])
        ttft.append((h.t_first - t_arrive) * 1e3)
        walls = [t.t_wall for t in toks]
        itl.extend(np.diff(walls) * 1e3)
    st = eng.stats()
    if eng.sessions or len(eng.scheduler) or not (rejected or interleave):
        fail(f"front end: {len(eng.sessions)} sessions and "
             f"{len(eng.scheduler)} queued after drain, "
             f"{len(rejected)} AdmissionFull")
    out = {"decode_interleave": interleave, "sessions": n_sessions,
           "prompt_len": prompt, "n_decode": n_decode, "slots": slots,
           "max_queued": max_queued, "admission_full": len(rejected),
           "sessions_rejected_at_least_once": len(set(rejected)),
           "wall_s": wall, "streamed_tok_s": n_sessions * n_decode / wall,
           "tokens_past_quota": sum(len(v) - n_decode
                                    for v in tokens.values()),
           "ttft_ms": percentiles(ttft), "inter_token_ms": percentiles(itl),
           "prefill_waves": st.waves_total,
           "decode_interleave_waves": st.decode_interleave_waves}
    return out, tokens


def frontend_reference(p, ro, sig, ReservoirEngine, device="cpu",
                       n_sessions=FE_SESSIONS, prompt=FE_PROMPT,
                       n_decode=2 * FE_DECODE, slots=FE_SLOTS):
    """The same sessions on a plain engine, ``slots`` at a time: submit,
    flush, ``decode_closed_loop(n_decode)`` (twice the streams' quota: an
    interleaved stream may run past it)."""
    starts, _ = frontend_workload(n_sessions, prompt)
    out = {}
    for g0 in range(0, n_sessions, slots):
        eng = ReservoirEngine(p, slots, readout=ro, device=device)
        group = range(g0, min(g0 + slots, n_sessions))
        for sid in group:
            eng.submit(sid, sig[starts[sid]:starts[sid] + prompt, None])
        eng.flush()
        ys = eng.decode_closed_loop(n_decode)
        out.update({sid: ys[sid].cpu().numpy() for sid in group})
    return out


def stream_err(tokens, ref):
    """Fail unless every streamed token is finite and within ``F64_TOL``
    of the reference, element by element against max(|ref|, 1)."""
    worst = 0.0
    for sid, want in ref.items():
        got = tokens[sid]
        if not np.isfinite(got).all() or len(got) > len(want):
            fail(f"front end: session {sid}: {len(got)} tokens, finite "
                 f"{bool(np.isfinite(got).all())}")
        want = want[:len(got)]
        worst = max(worst, float((np.abs(got - want)
                                  / np.maximum(np.abs(want), 1.0)).max()))
    if worst > F64_TOL:
        fail(f"front end vs the CPU engine: {worst:.3e} > {F64_TOL:.0e}")
    return {"max_rel_err": worst, "tol": F64_TOL, "tokens_checked":
            sum(v.size for v in tokens.values())}


class ArchBatches:
    """Seeded batches of an arch's inputs, as ``tests/test_arch_smoke.py::
    _batch`` makes them: ``embeds`` (B, S, d) and ``labels`` for an
    embedding-input config, else ``tokens`` (B, S); plus ``frames`` (B,
    encoder_seq, d) for an encoder-decoder.  A trainer's data source."""

    def __init__(self, cfg, batch, seq, seed=16):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed

    def batch_at(self, step):
        cfg, b, s = self.cfg, self.batch, self.seq
        rng = np.random.default_rng([self.seed, step])
        out = {}
        if cfg.input_mode == "embeddings":
            out["embeds"] = rng.standard_normal((b, s, cfg.d_model),
                                                dtype=np.float32)
            out["labels"] = rng.integers(0, cfg.vocab, size=(b, s),
                                         dtype=np.int32)
        else:
            out["tokens"] = rng.integers(0, cfg.vocab, size=(b, s),
                                         dtype=np.int32)
        if cfg.is_encoder_decoder:
            out["frames"] = rng.standard_normal(
                (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
        return out


def trainer_run(cfg, data, Trainer, TrainConfig, steps, device="cuda"):
    """``steps`` AdamW steps of the library's ``Trainer`` on ``data``:
    losses, median ms a step (steps 2..N), tokens/s, peak memory."""
    import torch
    release_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, TrainConfig(steps=steps, log_every=0), data,
                 device=device)
    tr.run()
    ms = 1e3 * float(np.median(tr.step_seconds[1:] or tr.step_seconds))
    out = {"arch": cfg.name, "params": cfg.param_count(), "n_layers":
           cfg.n_layers, "batch": data.batch, "seq": data.seq,
           "steps_run": len(tr.losses), "losses": tr.losses,
           "ms_per_step": ms, "tokens_per_s": data.batch * data.seq / (
               ms * 1e-3),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if len(tr.losses) != steps or not np.isfinite(tr.losses).all():
        fail(f"{cfg.name} training: {out}")
    return out


def profile_arch_step(cfg, data, Trainer, TrainConfig, lr=3e-3):
    """``device_summary`` of one training step of ``cfg`` on ``data``
    after one untimed step."""
    import torch
    release_cache()
    tr = Trainer(cfg, TrainConfig(steps=1, log_every=0, lr=lr), data,
                 device="cuda")
    state = tr.init_state(0)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in data.batch_at(0).items()}

    def step():
        return tr.step_fn(state["params"], state["opt"], state["ef"], batch)
    step()
    return profiled(step)


def encdec_decode_vs_cpu(cfg, lm, tree, seq, n_steps=8, batch=2):
    """whisper's forward in prefill mode (frames through the encoder) and
    ``n_steps`` ``decode_step``s from an empty cache, on the card and the
    CPU from the same weights: each one's logits within ``LM_ONE_TOL`` of
    its largest |logit|."""
    import torch
    weights = tree.tree_map(lambda v: v.numpy(), lm.init_params(
        torch.Generator().manual_seed(0), cfg, "cpu"))
    data = ArchBatches(cfg, batch, seq).batch_at(0)
    outs = {}
    with torch.no_grad():
        for device in ("cuda", "cpu"):
            params = lm.lm_params_from_numpy(weights, device)
            b = {k: torch.as_tensor(v, device=device) for k, v in data.items()}
            logits, _, _ = lm.forward(params, cfg, b, mode="prefill")
            cache = lm.make_decode_cache(params, cfg, batch, n_steps)
            steps = []
            for t in range(n_steps):
                step, cache = lm.decode_step(params, cfg, cache,
                                             b["tokens"][:, t:t + 1])
                steps.append(step.cpu())
            outs[device] = (logits.cpu(), torch.cat(steps, 1))
    rel = {name: float((g - w).abs().max() / w.abs().max()) for name, g, w in
           zip(("prefill", "decode"), outs["cuda"], outs["cpu"])}
    out = {"batch": batch, "seq": seq, "decode_steps": n_steps,
           "max_rel_err": rel, "tol": LM_ONE_TOL}
    if max(rel.values()) > LM_ONE_TOL:
        fail(f"{cfg.name} prefill / decode on the card vs the CPU: {out}")
    return out


def loss_grads_vs_cpu(cfg, data, lm, loss_and_grads, tree, tol,
                      witness=None, witness_tol=None):
    """One loss-and-gradient evaluation of ``cfg`` on ``data.batch_at(0)``
    on the card and the CPU from the same weights: the loss (with its MoE
    aux) and every gradient leaf within ``tol`` relative.  ``witness``
    (model keywords, e.g. ``{"attn_impl": "dense"}``) adds one more card
    evaluation with them, held against the same CPU one to
    ``witness_tol``: its gap at the first evaluation's worst leaf tells
    the route's share of that gap."""
    import torch
    weights = tree.tree_map(lambda v: v.numpy(), lm.init_params(
        torch.Generator().manual_seed(0), cfg, "cpu"))
    runs = {"cuda": ("cuda", {}), "cpu": ("cpu", {})}
    if witness:
        runs["witness"] = ("cuda", witness)
    out = {}
    for name, (device, kw) in runs.items():
        params = lm.lm_params_from_numpy(weights, device)
        b = {k: torch.as_tensor(v, device=device)
             for k, v in data.batch_at(0).items()}
        loss, metrics, grads = loss_and_grads(cfg, params, b, **kw)
        out[name] = (float(loss), tree.flatten(grads),
                     {k: float(v) for k, v in metrics.items()})
        del params, grads
        release_cache()
    (l_gpu, g_gpu, m_gpu), (l_cpu, g_cpu, m_cpu) = out["cuda"], out["cpu"]
    grad_rel, grad_key = leafwise(g_gpu, g_cpu)
    res = {"loss_cuda": l_gpu, "loss_cpu": l_cpu,
           "rel_loss_err": abs(l_gpu - l_cpu) / abs(l_cpu),
           "worst_leaf_grad_err": grad_rel, "worst_leaf": grad_key,
           "metrics_cuda": m_gpu, "metrics_cpu": m_cpu, "tol": tol}
    ok = np.isfinite(l_gpu) and res["rel_loss_err"] <= tol and grad_rel <= tol
    if witness:
        l_w, g_w, _ = out["witness"]
        w_rel, w_key = leafwise(g_w, g_cpu)
        res["witness"] = {
            "kw": witness, "tol": witness_tol,
            "rel_loss_err": abs(l_w - l_cpu) / abs(l_cpu),
            "worst_leaf_grad_err": w_rel, "worst_leaf": w_key,
            "grad_err_at_first_worst_leaf": leaf_rel(g_w[grad_key],
                                                     g_cpu[grad_key])}
        ok = ok and np.isfinite(l_w) and w_rel <= witness_tol \
            and res["witness"]["rel_loss_err"] <= witness_tol
    if not ok:
        fail(f"{cfg.name} loss and gradients on the card vs the CPU: {res}")
    return res


def driver_trainer_vs_cpu(train, argv, tol):
    """The training driver on ``argv`` on the card and the CPU (the same
    seeded weights and batches): every step's loss within ``tol``
    relative."""
    runs = {d: train.main(argv + ["--device", d]) for d in ("cuda", "cpu")}
    l_gpu, l_cpu = runs["cuda"]["losses"], runs["cpu"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    res = {"argv": argv, "losses_cuda": l_gpu, "losses_cpu": l_cpu,
           "max_rel_loss_err": rel, "tol": tol}
    if len(l_gpu) != len(l_cpu) or rel > tol:
        fail(f"training driver on the card vs the CPU: {res}")
    return res


class MoeStats:
    """Counts the MoE block's routed and dropped assignments
    (``blocks.moe_route``) and keeps the aux losses of each ``lm.loss_fn``
    while installed; read after the run (the counts stay on the device
    until then)."""

    def __init__(self, blocks, lm):
        self.blocks, self.lm = blocks, lm
        self.route, self.loss_fn = blocks.moe_route, lm.loss_fn
        self.assignments, self.dropped, self.aux = 0, [], []

    def __enter__(self):
        def route(*a, **kw):
            out = self.route(*a, **kw)
            self.assignments += out[5].numel()
            self.dropped.append((~out[5]).sum())
            return out

        def loss_fn(*a, **kw):
            total, metrics = self.loss_fn(*a, **kw)
            self.aux.append({k: metrics[k].detach()
                             for k in ("load_balance", "router_z")})
            return total, metrics
        self.blocks.moe_route, self.lm.loss_fn = route, loss_fn
        return self

    def __exit__(self, *exc):
        self.blocks.moe_route, self.lm.loss_fn = self.route, self.loss_fn

    def summary(self):
        per_call = [int(d) for d in self.dropped]
        dropped = sum(per_call)
        return {"assignments": self.assignments, "dropped": dropped,
                "dropped_share": dropped / max(self.assignments, 1),
                "dropped_share_by_call": [
                    d / (self.assignments / len(per_call)) for d in per_call],
                "load_balance": [float(a["load_balance"]) for a in self.aux],
                "router_z": [float(a["router_z"]) for a in self.aux]}


#: The examples (``examples/torch_*.py``), each run as its own process on
#: its default device (the card).
EXAMPLES = ("torch_quickstart.py", "torch_serve_sessions.py",
            "torch_serve_batched.py", "torch_train_reservoir_lm.py")


def examples_phase():
    """Each example as a subprocess (the kernels already built); a nonzero
    exit fails the run.  Returns each one's seconds and last line."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    rows = []
    for name in EXAMPLES:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(root / "examples" / name)],
                              cwd=root, env=env, capture_output=True,
                              text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0:
            fail(f"example {name} exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        rows.append({"example": name, "s": time.perf_counter() - t0,
                     "last_line": lines[-1] if lines else ""})
        print(json.dumps({"example": rows[-1]}), flush=True)
    return rows


#: The scan's per-timestep-gate shapes, each with the main path that gives
#: the kernel that shape.
GATE_PATHS = {"rglru-gates": "train_recurrentgemma",
              "slstm-gates": "train_xlstm", "slstm-decode": "serve_xlstm"}


def gate_rows(rows, keys, kernel, launches):
    """The per-timestep-gate shapes of ``rows`` (main paths 12-14) for the
    ``kernels`` line: a (B, T, N) real float32, each with ``kernel``'s
    launches on its main path."""
    return {case.replace("-", "_"): {
        "shape": rows[case]["shape"], "a": "(B, T, N) per-timestep, real",
        "h0": rows[case].get("h0", False), "dtype": "float32",
        "max_abs_err": rows[case]["max_abs_err"], "tol": rows[case]["tol"],
        "main_path": path, "launches": launches[path][kernel],
        **{k: rows[case][k] for k in keys}}
        for case, path in GATE_PATHS.items() if case in rows}


#: B3's route per head dim (``csrc/flash_attention.cu``).
FLASH_ROUTES = {
    "head_dim 1..128": "wgmma, one warpgroup a head's 64-row query tile "
                       "(padded to 32, 64 or 128)",
    "head_dim 129..256": "wgmma, the head dim (padded to 256) split between "
                         "two warpgroups that add their partial scores "
                         "through shared memory"}


#: Slice 12's B3 shapes, each with the main path that gives it its shape.
SLICE12_FLASH_PATHS = {"whisper-encoder": "train_whisper",
                       "llava-chunk0": "llava_embeds",
                       "llava-chunk1": "llava_embeds"}


def flash_summary(rows, counts, keys):
    """The ``kernels`` entry of B3: the timed chunk-1 launch at top level
    (q_offset 1024 against 2048 keys, float32), chunk 0 and chunk 1 in
    bfloat16 beside it; then recurrentgemma's head_dim-256 chunks (main
    path 12, whose launches they share), whisper's encoder (path 16) and
    llava's two band chunks (the llava phase)."""
    by = {r["case"]: r for r in rows}
    more = ("mma_route", "library_ms",
            "library_max_abs_err", "device_ms", "cuda_launches_per_call")
    slice12 = {case.replace("-", "_"): {
        "shape": by[case]["shape"], "causal": by[case]["causal"],
        "window": by[case]["window"], "q_offset": by[case]["q_offset"],
        "dtype": by[case]["dtype"], "main_path": path,
        "launches_on_main_path": counts["launches_by_path"].get(path, 0),
        "max_abs_err": by[case]["max_abs_err"], "tol": by[case]["tol"],
        "lse_max_rel_err": by[case]["lse_max_rel_err"],
        **{k: by[case][k] for k in keys}, **{k: by[case][k] for k in more}}
        for case, path in SLICE12_FLASH_PATHS.items()}
    c0, c1, bf = by["chunk0"], by["chunk1"], by["chunk1-bf16"]
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:125",
                routes_by_head_dim=FLASH_ROUTES,
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
                             **{k: bf[k] for k in more}},
                **{f"local_d256_{c.replace('-', '_')}": {
                    "shape": by[f"local-{c}"]["shape"], "window": 2048,
                    "q_offset": by[f"local-{c}"]["q_offset"],
                    "dtype": by[f"local-{c}"]["dtype"],
                    "route": FLASH_ROUTES["head_dim 129..256"],
                    "main_path": "train_recurrentgemma",
                    "launches_on_main_path": (
                        counts["launches_by_path"].get(
                            "train_recurrentgemma", 0)
                        if by[f"local-{c}"]["dtype"] == "float32" else 0),
                    "max_abs_err": by[f"local-{c}"]["max_abs_err"],
                    "tol": by[f"local-{c}"]["tol"],
                    "lse_max_rel_err": by[f"local-{c}"]["lse_max_rel_err"],
                    **{k: by[f"local-{c}"][k] for k in keys},
                    **{k: by[f"local-{c}"][k] for k in more}}
                   for c in ("chunk0", "chunk1", "chunk1-bf16")},
                **slice12)


def slice12_phases(drive, launches, m):
    """Phases 23-27: main paths 15-17, the llava phase and the examples.
    ``m``: the port's modules and names that ``main`` imported."""
    import dataclasses

    phase(f"23 main path 15: the open-loop front end at the serving profile "
          f"({FE_SESSIONS} sessions on a seeded exponential schedule, "
          f"{FE_PROMPT}-token prompts, {FE_DECODE} streamed tokens each, "
          f"max_queued {FE_MAX_QUEUED}): decode_interleave off on "
          f"{FE_SLOTS} slots, then on on {FE_SLOTS_INTERLEAVE} (C9)")
    p, ro, sig = served_model(m.esn, m.ESNConfig, m.mso_series)
    ref = frontend_reference(p, ro, sig, m.ReservoirEngine)
    for interleave in (False, True):
        path = f"frontend_interleave_{'on' if interleave else 'off'}"
        slots = FE_SLOTS_INTERLEAVE if interleave else FE_SLOTS
        res, tokens = drive(path, lambda: frontend_run(
            p, ro, sig, m.ReservoirEngine, m.OpenLoopServer, m.AdmissionFull,
            interleave, slots=slots), ("diag_scan", "decode_fused"))
        res["vs_cpu_engine"] = stream_err(tokens, ref)
        res["torch_add_us"] = torch_add_us()
        print(json.dumps({path: res, "launches": launches[path]}),
              flush=True)

    phase(f"24 main path 16: whisper-tiny at its published widths "
          f"({WHISPER_STEPS} AdamW steps, batch {WHISPER_BATCH} x "
          f"{WHISPER_SEQ} tokens and 1500 frames, float32, through the "
          f"library Trainer)")
    wcfg = dataclasses.replace(m.get_config("whisper-tiny"), dtype="float32")
    wdata = ArchBatches(wcfg, WHISPER_BATCH, WHISPER_SEQ)
    res = drive("train_whisper", lambda: trainer_run(
        wcfg, wdata, m.Trainer, m.TrainConfig, WHISPER_STEPS),
        ("flash_attention_fwd",))
    want = wcfg.encoder_layers * WHISPER_STEPS    # one launch an encoder layer
    if launches["train_whisper"]["flash_attention_fwd"] != want:
        fail(f"whisper training launched B3 "
             f"{launches['train_whisper']['flash_attention_fwd']} times, "
             f"expected {want}")
    print(json.dumps({"train_whisper": res,
                      "launches": launches["train_whisper"]}), flush=True)
    print(json.dumps({"profile_train_whisper_step": profile_arch_step(
        wcfg, wdata, m.Trainer, m.TrainConfig)}), flush=True)
    print(json.dumps({"whisper_loss_grads_vs_cpu": loss_grads_vs_cpu(
        wcfg, ArchBatches(wcfg, 2, WHISPER_SEQ), m.lm, m.loss_and_grads,
        m.tree, TRAINER_TOL, witness={"attn_impl": "dense"},
        witness_tol=TRAINER_TOL)}), flush=True)
    print(json.dumps({"whisper_decode_vs_cpu": encdec_decode_vs_cpu(
        wcfg, m.lm, m.tree, seq=WHISPER_SEQ)}), flush=True)

    phase("25 main path 17: repro_torch.launch.train "
          + " ".join(KIMI_TRAIN_ARGS) + "; arctic-480b --smoke and "
          "kimi-k2-1t-a32b --smoke serving against the CPU")
    with MoeStats(m.blocks, m.lm) as stats:
        res = train_path(drive, launches, m.train, "train_kimi",
                         KIMI_TRAIN_ARGS, KIMI_TRAIN_STEPS, {})
    moe = stats.summary()
    print(json.dumps({"train_kimi_moe": moe}), flush=True)
    if not 0.0 <= moe["dropped_share"] < 1.0 or not moe["load_balance"]:
        fail(f"kimi MoE statistics: {moe}")
    release_cache()
    print(json.dumps({"arctic_smoke_driver_vs_cpu": driver_trainer_vs_cpu(
        m.train, ARCTIC_SMOKE_ARGS, TRAINER_TOL)}), flush=True)
    acfg = m.train.arch_config(m.train.build_parser().parse_args(
        ARCTIC_SMOKE_ARGS))
    print(json.dumps({"arctic_smoke_loss_grads_vs_cpu": loss_grads_vs_cpu(
        acfg, m.MarkovTokens(vocab=acfg.vocab, batch=4, seq_len=64), m.lm,
        m.loss_and_grads, m.tree, TRAINER_TOL)}), flush=True)
    res = drive("serve_kimi", lambda: m.serve.main(KIMI_SERVE_ARGS), ())
    print(json.dumps({"serve_kimi": {k: v for k, v in res.items()
                                     if k not in ("tokens", "step_logits",
                                                  "last_logits")},
                      "launches": launches["serve_kimi"]}), flush=True)
    if not res["finite"]:
        fail("kimi serve: the last logits are not finite")
    print(json.dumps({"serve_kimi_vs_cpu": lm_serve_vs_cpu(
        m.serve, res, KIMI_SERVE_ARGS, dtype="float32")}), flush=True)

    phase(f"26 llava-next-mistral-7b embeddings: full width, "
          f"{LLAVA_LAYERS} of 32 layers, float32, one trainer step on "
          f"batch {LLAVA_BATCH} x {LLAVA_SEQ} embeds with labels")
    lcfg = dataclasses.replace(m.get_config("llava-next-mistral-7b"),
                               n_layers=LLAVA_LAYERS, dtype="float32")
    res = drive("llava_embeds", lambda: trainer_run(
        lcfg, ArchBatches(lcfg, LLAVA_BATCH, LLAVA_SEQ), m.Trainer,
        m.TrainConfig, 1), ("flash_attention_fwd",))
    want = 2 * LLAVA_LAYERS            # two 1024-row band chunks a layer
    if launches["llava_embeds"]["flash_attention_fwd"] != want:
        fail(f"llava's step launched B3 "
             f"{launches['llava_embeds']['flash_attention_fwd']} times, "
             f"expected {want}")
    print(json.dumps({"llava_embeds": res,
                      "launches": launches["llava_embeds"]}), flush=True)
    print(json.dumps({"llava_loss_grads_vs_cpu": loss_grads_vs_cpu(
        lcfg, ArchBatches(lcfg, LLAVA_BATCH, LLAVA_CHECK_SEQ), m.lm,
        m.loss_and_grads, m.tree, TRAINER_TOL)}), flush=True)
    release_cache()

    phase("27 the examples on the card: " + ", ".join(EXAMPLES))
    examples_phase()


# --------------------------------------------------------------------------- #
# Main path 18: the sharded slot arena                                        #
# --------------------------------------------------------------------------- #
#: Logical meshes on the one card: each cell its own shard with its own
#: launches (``launch.mesh.make_local_mesh(..., devices=[cuda:0] * D*M)``).
MESH_SHAPES = ((2, 1), (1, 2), (2, 2))
#: B3's float32 output against float64 at whisper-tiny's encoder: the
#: error the tile-accumulator repair holds it to (SDPA: 1.38e-6).
B3_F64_TOL = 3e-6


class EngineRecorder:
    """While active, records every ``decode_closed_loop`` token block and
    every released ``(state, y_prev)`` of a ``ReservoirEngine`` class, in
    call order (the driver returns rates, not tokens)."""

    def __init__(self, cls):
        self.cls, self.rec = cls, []

    def __enter__(self):
        loop, release, rec = (self.cls.decode_closed_loop, self.cls.release,
                              self.rec)

        def looped(eng, *a, **kw):
            out = loop(eng, *a, **kw)
            rec.extend(out[s].detach().clone() for s in out)
            return out

        def released(eng, sid, **kw):
            out = release(eng, sid, **kw)
            rec.extend(v.detach().clone() for v in out[:2])
            return out
        self._saved = (loop, release)
        self.cls.decode_closed_loop, self.cls.release = looped, released
        return self.rec

    def __exit__(self, *exc):
        self.cls.decode_closed_loop, self.cls.release = self._saved
        return False


def card_mesh(make_local_mesh, d, m, device="cuda:0"):
    """A (d, m) mesh of logical shards, every cell on ``device``."""
    return make_local_mesh(d, m, devices=[device] * (d * m))


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mesh_sessions(p, ro, sig, ReservoirEngine, mesh, n=16, slots=8,
                  prompt=1024, gen=128, device="cuda"):
    """The serving profile's 16 sessions through ``slots`` slots: two
    waves of 1024-token prompts, 128 closed-loop tokens each, every
    session released.  Returns the outputs in order, the wall ms (host
    clock, synchronised) and the decode waves by route."""
    rng = np.random.default_rng(3)
    starts = rng.integers(0, 2000 - prompt, size=n)
    kw = dict(device=device) if mesh is None else dict(mesh=mesh)
    eng = ReservoirEngine(p, slots, readout=ro, **kw)
    out = []
    sync(device)
    t0 = time.perf_counter()
    for sid, lo in enumerate(starts):
        eng.submit(sid, sig[lo:lo + prompt, None])
    while len(eng.pending) or eng.active_sessions:
        eng.flush()
        wave = list(eng.ready_sessions)
        ys = eng.decode_closed_loop(gen, sids=wave)
        for sid in wave:
            out += [ys[sid], *eng.release(sid)]
    sync(device)
    return out, (time.perf_counter() - t0) * 1e3, \
        eng.stats().decode_waves_by_route


def mesh_snapshot_path(p, ro, sig, ReservoirEngine, make_local_mesh,
                       prompt=1024, device="cuda"):
    """A (2, 1) engine snapshotted mid-workload (8 of 16 sessions admitted,
    64 tokens decoded), restored unsharded and on (1, 2) on the card; each
    continues the workload against the uninterrupted engine."""
    starts = np.random.default_rng(4).integers(0, 2000 - prompt, size=16)

    def start(eng):
        for sid, lo in enumerate(starts):
            eng.submit(sid, sig[lo:lo + prompt, None])
        eng.flush()
        eng.decode_closed_loop(64)
        return eng

    def finish(eng):
        buf = eng.collect_decoded().tokens
        out = [buf[s] for s in range(8)]
        out += [eng.decode_closed_loop(64)[s] for s in range(8)]
        for sid in range(8):
            out += list(eng.release(sid))
        eng.flush()
        ys = eng.decode_closed_loop(128)
        return out + [ys[s] for s in range(8, 16)]
    dev0 = "cuda:0" if device == "cuda" else device
    eng = start(ReservoirEngine(p, 8, readout=ro, mesh=card_mesh(
        make_local_mesh, 2, 1, dev0)))
    path = eng.snapshot(fresh_dir("mesh_snap") + "/engine")
    want = finish(eng)
    res = {}
    for name, mesh in (("unsharded", None),
                       ("1x2", card_mesh(make_local_mesh, 1, 2, dev0))):
        got = finish(ReservoirEngine.restore(path, device=device, mesh=mesh))
        errs = [traj_err(g, w, f"(2, 1) snapshot restored {name}, output "
                               f"{i}") for i, (g, w) in enumerate(
                                   zip(got, want))]
        res[f"restored_{name}_max_rel_err"] = max(e["max_rel_err"]
                                                  for e in errs)
    return res


def b3_f64_error(ops):
    """B3's float32 output at whisper-tiny's encoder (8, 6, 1500, 64),
    non-causal, against dense softmax attention in float64, beside SDPA's
    (``scripts/b3_f32_error.py``'s ``random`` case)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((8, 6, 1500, 64), generator=g).cuda()
               for _ in range(3))
    out, _ = ops.flash_attention_fwd(q, k, v, causal=False)
    s = q.double() @ k.double().transpose(-1, -2) * 64 ** -0.5
    want = torch.softmax(s, dim=-1) @ v.double()
    del s
    res = {"b3_err": float((out.double() - want).abs().max()),
           "sdpa_err": float((F.scaled_dot_product_attention(q, k, v)
                              .double() - want).abs().max()),
           "tol": B3_F64_TOL}
    if res["b3_err"] > B3_F64_TOL:
        fail(f"B3 float32 at whisper's encoder: {res['b3_err']:.3e} off "
             f"float64 (tol {B3_F64_TOL:.0e})")
    return res


def slice13_phases(drive, launches, m):
    """Phase 28: main path 18, the sharded slot arena, and B3's float32
    error against float64.  ``m``: the port's modules and names."""
    import torch
    phase("28 main path 18: the sharded slot arena at the serving profile — "
          "repro_torch.launch.serve " + " ".join(SERVE_ARGS) + " --mesh 1x1 "
          "against path 1; logical (2, 1), (1, 2), (2, 2) meshes on the card; "
          "--ensemble mean on (2, 1); snapshots across meshes; B3's float32 "
          "error")
    with EngineRecorder(m.ReservoirEngine) as want:
        m.serve.main(SERVE_ARGS)
    with EngineRecorder(m.ReservoirEngine) as got:
        res = drive("serve_mesh_1x1", lambda: m.serve.main(
            SERVE_ARGS + ["--mesh", "1x1"]), ("diag_scan", "decode_fused"))
    if len(got) != len(want) or not all(torch.equal(a, b)
                                        for a, b in zip(got, want)):
        fail("--mesh 1x1 differs from the run without --mesh")
    if launches["serve_mesh_1x1"] != launches["serve_reservoir"]:
        fail(f"--mesh 1x1 launches {launches['serve_mesh_1x1']}, path 1 "
             f"{launches['serve_reservoir']}")
    print(json.dumps({"serve_mesh_1x1": {
        "sessions_per_s": res["sessions_per_s"], "bit_equal_to_path_1": True,
        "outputs_compared": len(got)},
        "launches": launches["serve_mesh_1x1"]}), flush=True)

    p, ro, sig = served_model(m.esn, m.ESNConfig, m.mso_series)
    ref, ref_ms, ref_routes = mesh_sessions(p, ro, sig, m.ReservoirEngine,
                                            None)
    rows = {"unsharded": {"wall_ms": ref_ms, "routes": ref_routes}}
    for d, k in MESH_SHAPES:
        path = f"serve_mesh_{d}x{k}"
        out, ms, routes = drive(path, lambda: mesh_sessions(
            p, ro, sig, m.ReservoirEngine,
            card_mesh(m.make_local_mesh, d, k)), ("diag_scan",))
        errs = [traj_err(g, w, f"{d}x{k} mesh, output {i}")
                for i, (g, w) in enumerate(zip(out, ref))]
        # Two prefill waves, one scan launch a cell each; two closed-loop
        # waves, one fused decode a data shard where the model axis is
        # whole, else the step route and no fused decode.
        want_l = {"diag_scan": 2 * d * k,
                  "decode_fused": 2 * d if k == 1 else 0}
        got_l = {n: launches[path][n] for n in want_l}
        want_r = {"fused": 2, "step": 0} if k == 1 else {"fused": 0,
                                                          "step": 2}
        if got_l != want_l or routes != want_r:
            fail(f"{d}x{k} mesh: launches {got_l} (want {want_l}), routes "
                 f"{routes} (want {want_r})")
        rows[f"{d}x{k}"] = {"wall_ms": ms, "routes": routes,
                            "launches": launches[path],
                            "max_rel_err": max(e["max_rel_err"]
                                               for e in errs)}
    print(json.dumps({"mesh_sessions": rows}), flush=True)

    members = [m.esn.dpg_params(dataclasses.replace(
        serving_profile(m.ESNConfig), seed=i), "noisy_golden", sigma=0.1,
        device="cpu") for i in range(8)]
    outs = {}
    stack = m.stack_params(members)
    readout = m.Readout(torch.stack([m.esn.fit(
        q, sig[:2000, None], sig[1:2001, None], washout=100).w_out
        for q in members]))

    def ensemble(mesh):
        kw = dict(device="cuda") if mesh is None else dict(mesh=mesh)
        eng = m.ReservoirEngine.from_param_batch(stack, readout,
                                                 ensemble="mean", **kw)
        for i in range(8):
            eng.submit(i, sig[:1024, None])
        eng.flush()
        ys = eng.decode_closed_loop(128)
        return ([ys[i] for i in range(8)] + [eng.states],
                eng.stats().decode_waves_by_route)
    outs["unsharded"], _ = ensemble(None)
    got, routes = drive("serve_mesh_ensemble_2x1", lambda: ensemble(
        card_mesh(m.make_local_mesh, 2, 1)), ("diag_scan",))
    errs = [traj_err(g, w, f"ensemble mean on (2, 1), output {i}")
            for i, (g, w) in enumerate(zip(got, outs["unsharded"]))]
    lc = launches["serve_mesh_ensemble_2x1"]
    if lc["diag_scan"] != 2 or lc["decode_fused"] != 0 or routes != {
            "fused": 0, "step": 1}:
        fail(f"ensemble mean on (2, 1): launches {lc}, routes {routes}")
    print(json.dumps({"mesh_ensemble_2x1": {
        "routes": routes, "max_rel_err": max(e["max_rel_err"]
                                             for e in errs)},
        "launches": lc}), flush=True)
    print(json.dumps({"mesh_snapshots": mesh_snapshot_path(
        p, ro, sig, m.ReservoirEngine, m.make_local_mesh)}), flush=True)
    print(json.dumps({"b3_f32_vs_float64": b3_f64_error(m.ops)}),
          flush=True)


# --------------------------------------------------------------------------- #
# Main path 19: the sharded LM (DTensor, one process a rank)                  #
# --------------------------------------------------------------------------- #
#: Path 19's process group and meshes.  scripts/probe_process_group.py on
#: the H100, ranks sharing the card: NCCL refuses two ("Duplicate GPU
#: detected"); over gloo, at world 2 and 4, the functional all-gather —
#: what DTensor's Shard -> Replicate redistribution calls — did not return
#: within 45 s, nor did that redistribution (the classic collectives and
#: the functional all-reduce, reduce-scatter and permute did).  So the
#: card runs the (1, 1) mesh over NCCL, at full width, through the same
#: DTensor code (placements, local_map bodies, the gradient reduction) as
#: the multi-rank meshes, which run on the CPU over gloo
#: (tests/test_torch_distributed.py).
LM_MESH_BACKEND = "nccl"
LM_MESHES = ((1, 1),)
SHARDED_STEPS = 5
#: kimi-k2's expert parallelism on the (1, 1) mesh: its 384 experts, top-8
#: and expert width 2048 at d_model 1024 (path 17's cut), 2 x 256 tokens.
KIMI_EP_BATCH, KIMI_EP_SEQ, MOE_TOL = 2, 256, 2e-3


def sharded_lm_rank(rank, shape, steps):
    """One rank of main path 19 on its own process (spawned; it imports
    the port itself).  ``linear-esn`` at its published widths and depth,
    float32, AdamW, batch 8 x 1024: the first step's loss and gradients,
    then ``steps`` trainer steps, each on the ``shape`` mesh against the
    unsharded card run from the same seed; B1's and its backward's
    launches counted on this rank, set to 0 just before the sharded run
    and read just after.  Then B3 on DTensor operands: ``smollm-135m`` at
    its published widths and depth, float32, batch 8 x 2048 (path 4's
    shape), the first step's loss and gradients on the mesh against the
    unsharded card step, B3's launches counted in each.  Then kimi-k2's
    expert-parallel MoE block."""
    src = str(Path(__file__).resolve().parent / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovTokens
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import blocks, lm
    from repro_torch.sharding.rules import make_profile
    from repro_torch.train.trainer import TrainConfig, Trainer, \
        loss_and_grads
    from repro_torch.tree import flatten
    counters = {"diag_scan": ops.diag_scan, "diag_scan_bwd": ops.diag_scan_bwd,
                "decode_fused": ops.decode_fused,
                "flash_attention_fwd": ops.flash_attention_fwd}
    mesh = make_lm_mesh(shape, device_type="cuda")
    cfg = dataclasses.replace(get_config("linear-esn"), dtype="float32")
    prof = make_profile(mesh, cfg)
    data = MarkovTokens(vocab=cfg.vocab, batch=8, seq_len=1024)
    out = {"mesh": list(shape), "backend": LM_MESH_BACKEND,
           "params": cfg.param_count()}

    params = lm.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in data.batch_at(0).items()}
    l_p, _, g_p = loss_and_grads(cfg, params, batch, attn_impl="auto")
    g_p = flatten(g_p)
    l_d, _, g_d = loss_and_grads(
        cfg, lm.place_params(params, cfg, prof),
        dist.place(batch, {k: (prof.dp_spec,) + (None,) * (v.ndim - 1)
                           for k, v in batch.items()}, mesh),
        prof=prof, attn_impl="auto")
    g_d = flatten(dist.full(g_d))
    out["first_loss_rel"] = abs(float(l_d) - float(l_p)) / abs(float(l_p))
    out["grad_rel_max"] = max(
        float((g_d[k] - g_p[k]).abs().max())
        / max(float(g_p[k].abs().max()), 1e-30) for k in g_p)
    del params, batch, g_p, g_d
    gc.collect()
    torch.cuda.empty_cache()

    tc = TrainConfig(steps=steps, log_every=0)
    plain = Trainer(cfg, tc, data, device="cuda", attn_impl="auto")
    plain.run(seed=0)
    sharded = Trainer(cfg, tc, data, device="cuda", prof=prof,
                      attn_impl="auto")
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    sharded.run(seed=0)
    torch.cuda.synchronize()
    out["launches"] = {k: c.launches for k, c in counters.items()}
    out["losses"] = sharded.losses
    out["losses_unsharded"] = plain.losses
    out["loss_rel_max"] = max(abs(a - b) / abs(b) for a, b in
                              zip(sharded.losses, plain.losses))
    out["ms_per_step"] = 1e3 * float(np.median(sharded.step_seconds[1:]))
    out["ms_per_step_unsharded"] = 1e3 * float(
        np.median(plain.step_seconds[1:]))
    del plain, sharded
    gc.collect()
    torch.cuda.empty_cache()

    # B3 on the rank's local heads and batch (attention.attention's
    # local_map), with 2048 keys so the flash route is taken.
    scfg = dataclasses.replace(get_config("smollm-135m"), dtype="float32")
    sprof = make_profile(mesh, scfg)
    params = lm.init_params(torch.Generator().manual_seed(2), scfg, "cuda")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in MarkovTokens(
        vocab=scfg.vocab, batch=8, seq_len=2048).batch_at(0).items()}

    def counted(fn):
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        res = fn()
        torch.cuda.synchronize()
        return res, {k: c.launches for k, c in counters.items()}
    (l_p, _, g_p), plain_launches = counted(lambda: loss_and_grads(
        scfg, params, batch, attn_impl="auto"))
    (l_d, _, g_d), launches = counted(lambda: loss_and_grads(
        scfg, lm.place_params(params, scfg, sprof),
        dist.place(batch, {k: (sprof.dp_spec, None) for k in batch}, mesh),
        prof=sprof, attn_impl="auto"))
    g_p, g_d = flatten(g_p), flatten(dist.full(g_d))
    out["smollm"] = {
        "params": scfg.param_count(), "batch": [8, 2048],
        "launches": launches, "launches_unsharded": plain_launches,
        "loss_rel": abs(float(l_d) - float(l_p)) / abs(float(l_p)),
        "grad_rel_max": max(
            float((g_d[k] - g_p[k]).abs().max())
            / max(float(g_p[k].abs().max()), 1e-30) for k in g_p)}
    del params, batch, g_p, g_d
    gc.collect()
    torch.cuda.empty_cache()

    kcfg = dataclasses.replace(get_config("kimi-k2-1t-a32b"), d_model=1024,
                               n_heads=16, n_kv=8, d_ff=4096, n_layers=1,
                               dtype="float32")
    kprof = make_profile(mesh, kcfg)
    gen = torch.Generator().manual_seed(1)
    pm = {k: v.cuda() for k, v in blocks.init_moe(gen, kcfg,
                                                   torch.float32).items()}
    x = torch.randn((KIMI_EP_BATCH, KIMI_EP_SEQ, kcfg.d_model),
                    generator=gen).cuda()
    want, aux = blocks.apply_moe(pm, x, kcfg)
    pm_d = dist.place(pm, blocks.moe_specs(kcfg, kprof), mesh)
    x_d = dist.place(x, (kprof.dp_spec, None, None), mesh)
    got, aux_d = blocks.apply_moe(pm_d, x_d, kcfg, kprof)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        blocks.apply_moe(pm_d, x_d, kcfg, kprof)[0].full_tensor()
    torch.cuda.synchronize()
    ep_ms = (time.perf_counter() - t0) / 3 * 1e3
    t0 = time.perf_counter()
    for _ in range(3):
        blocks.apply_moe(pm, x, kcfg)
    torch.cuda.synchronize()
    out["kimi_ep"] = {
        "experts": kcfg.n_experts, "top_k": kcfg.top_k,
        "moe_ff": kcfg.moe_ff, "d_model": kcfg.d_model,
        "tokens": KIMI_EP_BATCH * KIMI_EP_SEQ,
        "out_rel": float((got.full_tensor() - want).abs().max()
                         / want.abs().max()),
        "load_balance_rel": abs(float(aux_d["load_balance"].full_tensor())
                                - float(aux["load_balance"]))
        / abs(float(aux["load_balance"])),
        "ms": ep_ms,
        "ms_unsharded": (time.perf_counter() - t0) / 3 * 1e3}
    return out


def slice14_phases(launches, m):
    """Phase 29: main path 19, the sharded LM on the card, one rank a
    process (``LM_MESH_BACKEND``), each mesh of ``LM_MESHES`` against the
    unsharded card run."""
    phase(f"29 main path 19: the sharded LM — linear-esn (float32, batch 8 "
          f"x 1024, AdamW, {SHARDED_STEPS} steps) on the meshes {LM_MESHES} "
          f"over {LM_MESH_BACKEND}, against the unsharded card step; "
          f"smollm-135m's step through B3 (batch 8 x 2048); kimi-k2's "
          f"expert-parallel MoE")
    release_cache()
    for shape in LM_MESHES:
        world = shape[0] * shape[1]
        path = f"train_sharded_{shape[0]}x{shape[1]}"
        t0 = time.perf_counter()
        ranks = m.spawn_ranks(sharded_lm_rank, world,
                              backend=LM_MESH_BACKEND,
                              args=(shape, SHARDED_STEPS), timeout=900)
        wall = time.perf_counter() - t0
        n_layers = m.get_config("linear-esn").n_layers
        for r, res in enumerate(ranks):
            want = n_layers * SHARDED_STEPS
            got = {k: res["launches"][k] for k in ("diag_scan",
                                                   "diag_scan_bwd")}
            if got != {"diag_scan": want, "diag_scan_bwd": want}:
                fail(f"{path} rank {r} launched {got}, expected {want} of "
                     f"each ({n_layers} layers x {SHARDED_STEPS} steps)")
            if res["loss_rel_max"] > 1e-5 or res["first_loss_rel"] > 1e-5:
                fail(f"{path} rank {r}: losses {res['losses']} against "
                     f"{res['losses_unsharded']} (1e-5 relative)")
            if res["grad_rel_max"] > LM_TOL:
                fail(f"{path} rank {r}: gradients {res['grad_rel_max']} of "
                     f"the leaf max (LM_TOL {LM_TOL})")
            sm = res["smollm"]
            flash = sm["launches"]["flash_attention_fwd"]
            if not 0 < flash == sm["launches_unsharded"][
                    "flash_attention_fwd"]:
                fail(f"{path} rank {r}: smollm-135m launched B3 {flash} "
                     f"times on the mesh, {sm['launches_unsharded']} "
                     f"unsharded")
            if sm["loss_rel"] > 1e-5 or sm["grad_rel_max"] > LM_TOL:
                fail(f"{path} rank {r}: smollm-135m on the mesh {sm} "
                     f"(loss 1e-5 relative, gradients LM_TOL {LM_TOL})")
            ep = res["kimi_ep"]
            if ep["out_rel"] > MOE_TOL or ep["load_balance_rel"] > 0.2:
                fail(f"{path} rank {r}: kimi's EP MoE {ep}")
        # The path's launches: rank 0's (each rank counts its own).
        launches[path] = ranks[0]["launches"]
        launches[path + "_smollm"] = ranks[0]["smollm"]["launches"]
        print(json.dumps({"sharded_lm": ranks, "wall_s": wall,
                          "launches": launches[path],
                          "launches_smollm": launches[path + "_smollm"]}),
              flush=True)
        print(m.smi_line, flush=True)


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
    # The launcher module; the package binds ``diag_scan`` to the wrapper.
    dsk = importlib.import_module("repro_torch.kernels.diag_scan")
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_local_mesh, spawn_ranks
    from repro_torch.core.params import Readout, stack_params
    from repro_torch.models import blocks, lm
    from repro_torch.serve import AdmissionFull, OpenLoopServer
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
    for stem in ("diag_scan", "decode_fused", "flash_attention"):
        log = build.build_log(stem)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {stem}:", line.strip(), flush=True)
        spills.update(ptxas_spills(log))
    print(json.dumps({"ptxas_functions_with_spills": spills}), flush=True)
    decode_spills = {f: v for f, v in spills.items()
                     if "decode_fused_kernel" in f}
    if decode_spills:
        fail(f"decode_fused instantiations spill: {decode_spills}")
    wide = wide_route_report(build.build_log("flash_attention"))
    print(json.dumps({"flash_attention_d256_route_ptxas": wide}), flush=True)
    if not wide or any(r["spill"] != "0 bytes spill stores, 0 loads"
                       for r in wide.values()):
        fail(f"the head_dim-256 route is missing or spills: {wide}")
    smem = build.library("flash_attention").flash_attention_smem_bytes
    print(json.dumps({"flash_attention_dynamic_smem_bytes": {
        f"{'bf16' if bf16 else 'f32'}_d{d}": smem(bf16, d)
        for bf16 in (0, 1) for d in (32, 64, 128, 256)}}), flush=True)
    copy_bw = copy_bandwidth()
    print(json.dumps({"copy_bytes_per_s": copy_bw}), flush=True)

    phase("3 diag_scan kernel vs plain")
    scan_rows = check_diag_scan(ops, ref, dsk, copy_bw)
    print(json.dumps({"crossover": crossover(dispatch, esn, ESNConfig)}),
          flush=True)

    phase("4 decode_fused kernel vs plain")
    decode_rows = check_decode_fused(ops, ref, dsk, dispatch, esn, ESNConfig,
                                     copy_bw)
    mean_rows = check_mean_cluster(ops, ref, dsk, copy_bw,
                                   len(decode_spills))

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
    # The 16-slot arena (the JAX benchmark's mixed-traffic arena at n=1024).
    res = drive("serve_reservoir_16", lambda: serve.main(SERVE16_ARGS),
                ("diag_scan", "decode_fused"))
    print(json.dumps({"serve_16": res,
                      "launches": launches["serve_reservoir_16"]}),
          flush=True)
    if not res["finite"] or res["sessions"] != 32:
        fail(f"16-slot serving loop: finite={res['finite']}, "
             f"sessions={res['sessions']} (expected 32)")
    print(json.dumps({"engine_vs_cpu_16": engine_vs_cpu(
        esn, ESNConfig, mso_series, ReservoirEngine, slots=16)}), flush=True)

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

    phase("14 main path 6: the LinearESN facade at the serving profile "
          "(n=1024, float64): standard fit, EWT, DPG fit, predict, "
          "generate(128)")
    card = drive("facade", lambda: facade_path(esn, ESNConfig, mso_series),
                 ("diag_scan",))
    print(json.dumps({"facade_vs_cpu": facade_vs_cpu(
        esn, ESNConfig, mso_series, card),
        "launches": launches["facade"]}), flush=True)

    phase("15 main path 7: repro_torch.launch.serve " + " ".join(ENS_ARGS)
          + " --ensemble mean | weighted | independent")
    for ensemble, expect in (("mean", ("diag_scan", "decode_fused")),
                             ("weighted", ("diag_scan",)),
                             ("independent", ("diag_scan", "decode_fused"))):
        path = f"serve_ensemble_{ensemble}"
        argv = ENS_ARGS + ["--ensemble", ensemble]
        if ensemble == "independent":
            argv += ["--sessions", "16"]
        res = drive(path, lambda: serve.main(argv), expect)
        keep = {k: v for k, v in res.items() if k != "continuation"}
        print(json.dumps({path: keep, "launches": launches[path]}),
              flush=True)
        if not res["finite"]:
            fail(f"{path}: outputs are not finite")
        if ensemble != "independent" and not res["rmse_vs_signal"] < 0.1:
            fail(f"{path}: continuation rmse {res['rmse_vs_signal']:.3e} "
                 f"vs the signal")
        want = {"mean": {"fused": 2, "step": 0},
                "weighted": {"fused": 0, "step": 2}}.get(ensemble)
        if want and res["decode_waves_by_route"] != want:
            fail(f"{path}: decode waves by route "
                 f"{res['decode_waves_by_route']}, expected {want}")
    if launches["serve_ensemble_weighted"]["decode_fused"]:
        fail("the weighted ensemble launched B2; it takes the "
             "step-at-a-time path, as in the JAX package")
    # 16 and 32 per-slot members of 525 float64 lanes: B2's mean route
    # spreads them over one thread-block cluster, one launch a wave.
    for slots in (16, 32):
        path = f"serve_ensemble_mean_{slots}_slots"
        argv = ENS_ARGS[:4] + [str(slots)] + ENS_ARGS[5:] + ["--ensemble",
                                                             "mean"]
        res = drive(path, lambda: serve.main(argv),
                    ("diag_scan", "decode_fused"))
        keep = {k: v for k, v in res.items() if k != "continuation"}
        print(json.dumps({path: keep, "launches": launches[path]}),
              flush=True)
        if (not res["finite"] or not res["rmse_vs_signal"] < 0.1
                or res["decode_waves_by_route"] != {"fused": 2, "step": 0}
                or launches[path]["decode_fused"] != 2):
            fail(f"--ensemble mean --slots {slots} at n=1024: {keep}, "
                 f"launches {launches[path]}; expected one B2 launch a "
                 f"wave (2), no step wave, a finite continuation within "
                 f"0.1")
    for ensemble, slots in (("mean", 8), ("weighted", 8), ("mean", 16)):
        name = f"ensemble_{ensemble}_vs_cpu" + (
            f"_{slots}_slots" if slots != 8 else "")
        print(json.dumps({name: ensemble_vs_cpu(
            esn, ESNConfig, mso_series, ReservoirEngine, ensemble, slots)}),
            flush=True)

    phase("16 main path 8: decode-SLO interleave (8 slots, 2 protected "
          "decoders, 4 x 1024-token prompts in 256-token chunks, 8-token "
          "decode waves), observe, profile capture")
    print(json.dumps({"interleave": interleave_path(
        esn, ESNConfig, mso_series, ReservoirEngine, drive),
        "launches": launches["serve_interleave"]}), flush=True)
    cost_path = Path(__file__).resolve().parent / "build" / "costs.json"
    slo_args = SERVE_ARGS + SLO_ARGS + ["--cost-save", str(cost_path)]
    res = drive("serve_slo", lambda: serve.main(slo_args),
                ("diag_scan", "decode_fused"))
    print(json.dumps({"serve_slo": res, "args": SLO_ARGS,
                      "launches": launches["serve_slo"]}), flush=True)
    if not res["finite"] or res["sessions"] != 16 or \
            res["decode_interleave_waves"] < 1:
        fail(f"SLO serving loop: {res}")
    print(json.dumps({"observe_vs_cpu": observe_vs_cpu(
        esn, ESNConfig, mso_series, ReservoirEngine)}), flush=True)
    print(json.dumps({"profile_capture": profile_capture(
        esn, ESNConfig, mso_series, ReservoirEngine)}), flush=True)

    phase("17 main path 9: repro_torch.launch.serve " + " ".join(PAGED_ARGS)
          + " --cold-dir --snapshot; the park.restore rotation, the "
          "pipeline.overlap churn, snapshot / restore")
    paged_argv = PAGED_ARGS + ["--cold-dir", fresh_dir("serve_cold"),
                               "--snapshot", str(PAGED_DIR / "serve_snap")]
    res = drive("serve_paged", lambda: serve.main(paged_argv),
                ("diag_scan", "decode_fused"))
    tiers = res["tiers_after_admission"]
    if (not res["finite"] or res["sessions"] != 32
            or (tiers["host"], tiers["cold"]) != (16, 8)
            or res["demote_waves"] < 3 or res["promote_waves"] < 3):
        fail(f"paged serving loop: {res}")
    t0 = time.perf_counter()
    restored = ReservoirEngine.restore(res["snapshot"], device="cuda")
    restore_ms = (time.perf_counter() - t0) * 1e3
    if restored.store.epoch != 1 or restored.store.pool.rows != 16:
        fail(f"the driver's snapshot restored as {restored.store.stats()}")
    print(json.dumps({"serve_paged": res, "restore_ms": restore_ms,
                      "launches": launches["serve_paged"]}), flush=True)
    print(json.dumps({"park_restore": park_restore_path(
        esn, ESNConfig, mso_series, ReservoirEngine, drive),
        "launches": launches["park_restore"]}), flush=True)
    print(json.dumps({"pipeline_overlap": overlap_path(
        esn, ESNConfig, mso_series, ReservoirEngine, drive),
        "launches": launches["pipeline_overlap"]}), flush=True)
    print(json.dumps({"snapshot_restore": snapshot_path(
        esn, ESNConfig, mso_series, ReservoirEngine)}), flush=True)

    phase("18 main path 10: repro_torch.launch.serve " + " ".join(LEARN_ARGS)
          + " (and --drift-threshold); tenant pools through B2; the facade "
          "replay; a learn snapshot")
    print(json.dumps({"learn_driver": learn_driver_path(
        serve, esn, ESNConfig, drive),
        "launches": {k: launches[k] for k in ("serve_learn",
                                              "serve_learn_growth")}}),
        flush=True)
    p, ro, sig = served_model(esn, ESNConfig, mso_series)
    turns = [(learn, teacher_loop_us(p, ro, sig, ReservoirEngine, learn))
             for learn in (True, False, False, True)]
    print(json.dumps({"teacher_loop_us_per_token": {
        "learn_on": [us for learn, us in turns if learn],
        "learn_off": [us for learn, us in turns if not learn],
        "turns": "on, off, off, on", "torch_add_us": torch_add_us()}}),
        flush=True)
    print(json.dumps({"tenant_pools": tenant_pool_path(
        esn, ESNConfig, mso_series, ReservoirEngine, drive, launches),
        "launches": launches["tenant_pools"]}), flush=True)
    print(json.dumps({"facade_replay": facade_replay_path(drive),
                      "launches": launches["facade_replay"]}), flush=True)
    print(json.dumps({"learn_snapshot": learn_snapshot_path(
        esn, ESNConfig, mso_series, ReservoirEngine)}), flush=True)

    phase("19 main path 11: repro_torch.launch.serve "
          + " ".join(RG_SERVE_ARGS) + " (default arch recurrentgemma-2b, full width and depth, "
          "bfloat16; decode runs no kernel, as in the JAX package)")
    res = drive("serve_recurrentgemma", lambda: serve.main(RG_SERVE_ARGS), ())
    keep = {k: v for k, v in res.items()
            if k not in ("tokens", "step_logits", "last_logits")}
    print(json.dumps({"serve_recurrentgemma": keep,
                      "launches": launches["serve_recurrentgemma"]}),
          flush=True)
    if res["arch"] != "recurrentgemma-2b" or not res["finite"]:
        fail(f"recurrentgemma serve: {keep}")
    if any(launches["serve_recurrentgemma"].values()):
        fail(f"recurrentgemma decode launched a kernel: "
             f"{launches['serve_recurrentgemma']}")
    print(json.dumps({"serve_recurrentgemma_vs_cpu": lm_serve_vs_cpu(
        serve, None, RG_SERVE_ARGS + ["--prompt-len", "16", "--gen", "16"],
        n_layers=3)}), flush=True)

    phase("20 main path 12: repro_torch.launch.train "
          + " ".join(RG_TRAIN_ARGS))
    rg_cut = get_config("recurrentgemma-2b")
    rg_kinds = [rg_cut.block_pattern[i % 3] for i in range(9)]
    train_path(drive, launches, train, "train_recurrentgemma", RG_TRAIN_ARGS,
               RG_TRAIN_STEPS,
               {"diag_scan": rg_kinds.count("rglru"),
                "diag_scan_bwd": rg_kinds.count("rglru"),
                # two 1024-row query chunks a local layer
                "flash_attention_fwd": 2 * rg_kinds.count("local")})
    rg_prof = profile_train_step(train, Trainer, TrainConfig, MarkovTokens,
                                 RG_TRAIN_ARGS)
    print(json.dumps({"profile_train_recurrentgemma_step": rg_prof}),
          flush=True)
    b3 = [k for k in rg_prof.get("port_kernels", ())
          if "flash_attention_fwd_wide_kernel" in k["kernel"]]
    print(json.dumps({"profiled_step_b3_head_dim_256": b3}), flush=True)
    # (the launch count is the counters' check in train_path)
    if not b3:
        fail("path 12's profiled step names no head_dim-256 flash kernel")
    print(json.dumps({"recurrentgemma_trainer_vs_cpu": lm_trainer_vs_cpu(
        lm, loss_and_grads, Trainer, TrainConfig, MarkovTokens, get_config,
        tree, arch="recurrentgemma-2b", batch=1, seq=1024, n_layers=3)}),
        flush=True)

    phase("21 main path 13: repro_torch.launch.train "
          + " ".join(XL_TRAIN_ARGS))
    xl = get_config("xlstm-125m")
    n_slstm = [xl.block_pattern[i % 2] for i in range(xl.n_layers)].count(
        "slstm")
    # each sLSTM layer scans c and n
    train_path(drive, launches, train, "train_xlstm", XL_TRAIN_ARGS,
               TRAIN_STEPS, {"diag_scan": 2 * n_slstm,
                             "diag_scan_bwd": 2 * n_slstm})
    print(json.dumps({"profile_train_xlstm_step": profile_train_step(
        train, Trainer, TrainConfig, MarkovTokens, XL_TRAIN_ARGS)}),
        flush=True)
    print(json.dumps({"xlstm_trainer_vs_cpu": lm_trainer_vs_cpu(
        lm, loss_and_grads, Trainer, TrainConfig, MarkovTokens, get_config,
        tree, arch="xlstm-125m", batch=2, seq=256, n_layers=2)}),
        flush=True)

    phase("22 main path 14: repro_torch.launch.serve "
          + " ".join(XL_SERVE_ARGS))
    res = drive("serve_xlstm", lambda: serve.main(XL_SERVE_ARGS),
                ("diag_scan",))
    print(json.dumps({"serve_xlstm": {k: v for k, v in res.items()
                                      if k not in ("tokens", "step_logits",
                                                   "last_logits")},
                      "launches": launches["serve_xlstm"]}), flush=True)
    if not res["finite"]:
        fail("xlstm serve: the last logits are not finite")
    print(json.dumps({"serve_xlstm_vs_cpu": lm_serve_vs_cpu(
        serve, res, XL_SERVE_ARGS)}), flush=True)

    slice12_phases(drive, launches, types.SimpleNamespace(
        esn=esn, ESNConfig=ESNConfig, mso_series=mso_series,
        ReservoirEngine=ReservoirEngine, OpenLoopServer=OpenLoopServer,
        AdmissionFull=AdmissionFull, get_config=get_config, Trainer=Trainer,
        TrainConfig=TrainConfig, MarkovTokens=MarkovTokens, lm=lm,
        blocks=blocks, tree=tree, loss_and_grads=loss_and_grads,
        train=train, serve=serve))
    slice13_phases(drive, launches, types.SimpleNamespace(
        esn=esn, ESNConfig=ESNConfig, mso_series=mso_series,
        ReservoirEngine=ReservoirEngine, serve=serve, ops=ops,
        make_local_mesh=make_local_mesh, stack_params=stack_params,
        Readout=Readout))
    slice14_phases(launches, types.SimpleNamespace(
        spawn_ranks=spawn_ranks, get_config=get_config, smi_line=smi_line))

    phase("30 summary")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "copy_bound_ms")
    rows = {r["case"]: r for r in scan_rows}
    wave, fit, fwd_train = rows["wave"], rows["fit"], rows["train"]
    row_a = rows["wave-row-a"]
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
             replaces="src/repro/kernels/diag_scan.py:91",
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
                              **{k: fwd_decode[k] for k in scan_keys}},
             per_row_a={"shape": row_a["shape"], "a": "(B, 1, N) static",
                        "max_abs_err": row_a["max_abs_err"],
                        "tol": row_a["tol"],
                        **{k: row_a[k] for k in scan_keys}},
             **gate_rows(rows, scan_keys, "diag_scan", launches)),
        dict(name="diag_scan_bwd", route="cuda",
             source="src/repro_torch/csrc/diag_scan.cu",
             replaces="src/repro/kernels/ops.py:85",
             replaces_note="_bwd runs diag_scan_pallas_raw "
                           "(src/repro/kernels/diag_scan.py:91) on flipped "
                           "arrays, then reduces da and dh0 in XLA",
             **count("diag_scan_bwd"),
             max_abs_err=bwd_train["max_abs_err"], tol=bwd_train["tol"],
             worst_err_over_tol=max(r["err_over_tol"] for r in bwd_rows),
             shape=bwd_train["shape"], dtype="float32",
             **{k: bwd_train[k] for k in scan_keys}, library_ms=None,
             f64={"shape": bwd["train-f64"]["shape"],
                  **{k: bwd["train-f64"][k] for k in scan_keys}},
             **gate_rows(bwd, scan_keys, "diag_scan_bwd", launches)),
        dict(name="decode_fused", route="cuda",
             source="src/repro_torch/csrc/decode_fused.cu",
             replaces="src/repro/kernels/diag_scan.py:181",
             replaces_note="decode_fused_pallas_raw, body _decode_kernel "
                           "(src/repro/kernels/diag_scan.py:110-154)",
             **count("decode_fused"),
             max_abs_err=dec["max_abs_err"], tol=dec["tol"],
             worst_err_over_tol=max(r["err_over_tol"]
                                    for r in decode_rows + mean_rows),
             shape=dec["shape"], dtype="float64",
             **{k: dec[k] for k in keys + (
                 "device_ms", "cuda_launches_per_call", "us_per_step",
                 "warps", "per", "mean_route", "mean_per_slot",
                 "run_decode_fused", "tenant_pool", "shapes")},
             mean_cluster=mean_rows, library_ms=None),
        flash_summary(flash_rows, count("flash_attention_fwd"), keys),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
