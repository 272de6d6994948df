"""Multi-pod dry run of the port: build every (arch x input-shape x mesh)
cell on the production mesh and trace its step once, shapes only; record
per-device memory, FLOPs and the collectives for the roofline report.

The counterpart of ``repro.launch.dryrun``.  JAX lowers and compiles each
cell against 512 placeholder host devices and reads XLA's memory and cost
analyses and the HLO's collectives.  PyTorch has no such compiler, so here
a cell runs under a fake process group of 256 (single pod, (16, 16)) or
512 (multi-pod, (2, 16, 16)) ranks — ``torch.testing._internal.
distributed.fake_pg``, as torchtitan estimates memory — as rank 0, with
every param, optimizer state, batch and cache a DTensor whose local shard
lives on the meta device: nothing is allocated and nothing is sent, and
the big configs (``arctic-480b``, ``kimi-k2-1t-a32b``, ``qwen2-72b``) trace
as easily as the small.  Nothing is downloaded.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun               # sweep
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k --mesh single

Results append to ``artifacts/dryrun_torch.jsonl`` (one JSON object a
cell; ``--resume`` skips cells already there) — never to
``artifacts/dryrun.jsonl``, the JAX package's record.  Each record has the
JAX record's keys:

* ``memory`` (bytes, one device): ``argument_bytes`` — the local shards of
  the step's inputs (``params_bytes``, ``opt_state_bytes``,
  ``batch_bytes``, ``cache_bytes`` beside it); ``output_bytes`` — the
  local outputs; ``peak_bytes`` — the traced peak: the inputs plus the
  largest total of local tensors alive at once while the step runs, each
  storage counted from the op that makes it until its last tensor dies
  (autograd's saved activations included, so remat shows); ``temp_bytes``
  — the peak less the inputs.
* ``cost``: ``flops`` — ``torch.utils.flop_counter.FlopCounterMode`` over
  the rank's local ops (the DTensor-level op over global shapes is not
  counted again); ``bytes_accessed`` — every local op's input and output
  bytes (no fusion: an upper bound); ``transcendentals`` — elements out of
  exp / log / tanh / sigmoid / sqrt / sin / cos-like ops.  The
  hand-written kernels (the B1 scan, B3's forward) run shape-only on meta
  (``kernels.ops.shape_only``), so their products are not in ``flops`` (``--probes`` traces B3's forward
  as PyTorch ops instead: ``attention.UNROLL_SCANS``).
* ``collectives``: from ``torch.distributed.tensor.debug.CommDebugMode``,
  counts and output bytes by kind (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all`` — which carries the pipeline's
  permutes —, ``collective-permute`` stays 0), ``total_bytes``,
  ``n_ops`` and the largest ops.
* ``model``: params, active params and tokens, as JAX's.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ASSIGNED, get_config, shape_cells
from ..kernels import ops
from ..models import attention as attn_mod
from ..sharding import rules
from .mesh import make_production_mesh

__all__ = ["run_cell", "run_probe", "main", "DEFAULT_OUT"]

DEFAULT_OUT = "artifacts/dryrun_torch.jsonl"
#: The JAX package's record, which this driver never writes.
JAX_OUT = "artifacts/dryrun.jsonl"

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_TRANSCENDENTAL = ("exp", "log", "tanh", "sigmoid", "sqrt", "rsqrt", "sin",
                   "cos", "erf", "softplus", "pow", "log_sigmoid")


def _is_dtensor_op(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _shadow(tensors) -> bool:
    """Whether an op is DTensor's sharding propagation: it runs the op once
    on fake tensors of the *global* shapes to learn the output's metadata
    — no rank computes or holds that (the rank's own work is the local op
    that follows)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in tensors)


def _local_tensors(tree):
    from torch.distributed.tensor import DTensor
    out = []
    for v in pytree_leaves(tree):
        if isinstance(v, DTensor):
            v = v.to_local()
        if isinstance(v, torch.Tensor):
            out.append(v)
    return out


def _nbytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


class _LocalFlops(FlopCounterMode):
    """``FlopCounterMode`` counting the rank's local ops only: a DTensor op
    is counted once, by the local ops it desugars into (not at its global
    shapes, nor in its sharding propagation)."""

    def _count_flops(self, func_packet, out, args, kwargs):
        from torch.distributed.tensor import DTensor
        leaves = pytree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in leaves) or _shadow(leaves):
            return out
        return super()._count_flops(func_packet, out, args, kwargs)


def _kind(packet_name: str):
    for key, kind in (("all_gather", "all-gather"),
                      ("allgather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_reduce", "all-reduce"),
                      ("allreduce", "all-reduce"),
                      ("all_to_all", "all-to-all"),
                      ("alltoall", "all-to-all")):
        if key in packet_name:
            return kind
    return None


class _Trace(TorchDispatchMode):
    """Live local bytes (and their peak), bytes touched, transcendental
    elements, and collectives with their output bytes, of the local ops
    run under it (DTensor ops are let through to desugar first)."""

    def __init__(self, base_bytes: int):
        super().__init__()
        self.live, self.peak = base_bytes, base_bytes
        self.refs = {}
        self.touched = 0
        self.transcendentals = 0
        self.comm = {k: 0 for k in COLLECTIVES}
        self.ops = []

    def _drop(self, key):
        entry = self.refs.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self.refs[key]

    def _track(self, t):
        key = t.untyped_storage()._cdata
        if key in self.refs:
            self.refs[key][1] += 1
        else:
            n = t.untyped_storage().nbytes()
            self.refs[key] = [n, 1]
            self.live += n
            self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        ins = [a for a in pytree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in pytree_leaves(out) if isinstance(o, torch.Tensor)]
        if _shadow(ins + outs):
            return out
        name = func._overloadpacket.__name__
        self.touched += sum(t.numel() * t.element_size() for t in ins + outs)
        if any(name == k or name == k + "_" for k in _TRANSCENDENTAL):
            self.transcendentals += sum(o.numel() for o in outs)
        kind = _kind(name)
        if kind is not None and name != "wait_tensor":
            nbytes = sum(o.numel() * o.element_size() for o in outs)
            self.comm[kind] += nbytes
            self.ops.append({"kind": kind, "op": name, "bytes": nbytes})
        for o in outs:
            self._track(o)
        return out


@contextlib.contextmanager
def _fake_world(world: int):
    """A fake process group of ``world`` ranks, this process rank 0."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=world)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def trace_cell(mesh, cfg, cell, *, donate=True):
    """Build ``cell`` on ``mesh`` and trace its step once.  Returns
    ``(meta, memory, cost, collectives, lower_s, trace_s)``."""
    from torch.distributed.tensor.debug import CommDebugMode
    t0 = time.perf_counter()
    placed, meta = rules.lower_cell(mesh, cfg, cell, donate=donate)
    lower_s = time.perf_counter() - t0
    parts = dict(zip({"train": ("params", "opt", "batch"),
                      "prefill": ("params", "batch"),
                      "decode": ("params", "cache", "batch")}[cell.kind],
                     placed.args))
    part_bytes = {k: _nbytes(_local_tensors(v)) for k, v in parts.items()}
    args_bytes = _nbytes([t for v in parts.values()
                          for t in _local_tensors(v)])
    flops, comm = _LocalFlops(display=False), CommDebugMode()
    tr = _Trace(args_bytes)
    del parts
    t0 = time.perf_counter()
    with ops.shape_only(), flops, comm, tr:
        out = placed()
    trace_s = time.perf_counter() - t0
    out_bytes = _nbytes(_local_tensors(out))
    memory = {"argument_bytes": args_bytes, "output_bytes": out_bytes,
              "temp_bytes": tr.peak - args_bytes, "peak_bytes": tr.peak,
              "params_bytes": part_bytes["params"],
              "opt_state_bytes": part_bytes.get("opt", 0),
              "batch_bytes": part_bytes["batch"],
              "cache_bytes": part_bytes.get("cache", 0)}
    cost = {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(tr.touched),
            "transcendentals": float(tr.transcendentals)}
    top = sorted(tr.ops, key=lambda o: -o["bytes"])
    collectives = {"per_kind_bytes": tr.comm,
                   "total_bytes": int(sum(tr.comm.values())),
                   "static_bytes": int(sum(tr.comm.values())),
                   "n_ops": len(tr.ops),
                   "counts": {str(k): v for k, v in
                              comm.get_comm_counts().items()},
                   "top_ops": top[:6]}
    return meta, memory, cost, collectives, lower_s, trace_s


def run_cell(arch: str, shape_name: str, multi_pod: bool, donate=True):
    cfg = get_config(arch)
    cells = {c.name: c for c in shape_cells(cfg)}
    mesh_name = "multi" if multi_pod else "single"
    if shape_name not in cells:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped",
                "reason": "long_500k requires sub-quadratic attention "
                          "(full-attention arch; see DESIGN.md)"}
    cell = cells[shape_name]
    with _fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        meta, memory, cost, collectives, lower_s, trace_s = trace_cell(
            mesh, cfg, cell, donate=donate)
        n_dev = mesh.size()
    return {
        **meta, "mesh": mesh_name, "n_devices": int(n_dev), "status": "ok",
        "lower_s": round(lower_s, 1), "compile_s": round(trace_s, 1),
        "memory": memory, "cost": cost, "collectives": collectives,
        "model": {"params": cfg.param_count(),
                  "active_params": cfg.active_param_count(),
                  "tokens": cell.global_batch * (cell.seq_len
                                                 if cell.kind != "decode"
                                                 else 1)},
    }


def run_probe(arch: str, shape_name: str, n_units: int):
    """Cost probe: the same cell on a shallow unrolled stack (``n_units`` x
    the block pattern, ``scan_layers=False``) with ``UNROLL_SCANS`` on, so
    every attention block's products are counted; two probes (2 and 4
    units) give the per-layer cost by differencing.  Single pod only."""
    cfg = get_config(arch)
    cells = {c.name: c for c in shape_cells(cfg)}
    if shape_name not in cells:
        return None
    pat = len(cfg.block_pattern)
    probe_cfg = dataclasses.replace(
        cfg, n_layers=n_units * pat, scan_layers=False,
        encoder_layers=min(cfg.encoder_layers, n_units)
        if cfg.is_encoder_decoder else 0)
    old_unroll, old_scan = attn_mod.UNROLL_SCANS, rules.SCAN_METHOD
    attn_mod.UNROLL_SCANS, rules.SCAN_METHOD = True, "associative"
    try:
        with _fake_world(256):
            mesh = make_production_mesh(multi_pod=False)
            _, _, cost, _, _, _ = trace_cell(mesh, probe_cfg,
                                             cells[shape_name], donate=False)
    finally:
        attn_mod.UNROLL_SCANS, rules.SCAN_METHOD = old_unroll, old_scan
    return {"arch": arch, "shape": shape_name, "mesh": "single",
            "status": "probe", "probe_units": n_units,
            "probe_layers": n_units * pat,
            "cost": {"flops": cost["flops"],
                     "bytes_accessed": cost["bytes_accessed"]}}


def _refuse_jax_record(path: str) -> None:
    if os.path.normpath(os.path.abspath(path)) == os.path.normpath(
            os.path.abspath(JAX_OUT)):
        raise SystemExit(f"--out {path}: that is the JAX package's dry-run "
                         f"record; the port writes {DEFAULT_OUT}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--include-esn", action="store_true",
                    help="also dry-run the paper's linear-esn LM config")
    ap.add_argument("--probes", action="store_true",
                    help="also run 2/4-unit unrolled cost probes "
                         "(single-pod)")
    args = ap.parse_args(argv)
    _refuse_jax_record(args.out)

    archs = [args.arch] if args.arch else list(ASSIGNED)
    if args.include_esn and "linear-esn" not in archs:
        archs.append("linear-esn")
    shapes = ([args.shape] if args.shape
              else ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                done.add((r["arch"], r["shape"], r["mesh"]))

    n_fail = 0
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for multi in meshes:
                    key = (arch, shape, "multi" if multi else "single")
                    if key in done:
                        continue
                    print(f"[dryrun] {key} ...", flush=True)
                    try:
                        rec = run_cell(arch, shape, multi)
                    except Exception as e:  # a failure here is a bug: record it
                        rec = {"arch": arch, "shape": shape,
                               "mesh": "multi" if multi else "single",
                               "status": "error", "error": repr(e),
                               "traceback": traceback.format_exc()[-2000:]}
                        n_fail += 1
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    extra = ""
                    if rec.get("status") == "ok":
                        extra = (f" trace={rec['compile_s']}s peak="
                                 f"{rec['memory']['peak_bytes'] / 2**30:.2f}"
                                 f"GiB/dev flops={rec['cost']['flops']:.3g}")
                    print(f"[dryrun] {key} -> {rec.get('status')}{extra}",
                          flush=True)
                if args.probes:
                    for n_units in (2, 4):
                        pkey = (arch, shape, f"probe{n_units}")
                        if pkey in done:
                            continue
                        try:
                            rec = run_probe(arch, shape, n_units)
                        except Exception as e:  # recorded, as a cell's
                            rec = {"arch": arch, "shape": shape,
                                   "mesh": f"probe{n_units}",
                                   "status": "error", "error": repr(e)}
                            n_fail += 1
                        if rec is None:
                            continue
                        rec["mesh"] = f"probe{n_units}"
                        f.write(json.dumps(rec) + "\n")
                        f.flush()
                        print(f"[dryrun] {pkey} -> {rec.get('status')}",
                              flush=True)
    print(f"[dryrun] complete, {n_fail} failures", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
