#!/usr/bin/env python3
"""Which process group carries the collectives the sharded LM needs, for
ranks that share one card.

    python3 scripts/probe_process_group.py [--device cuda|cpu] [--hang S]

The sharded LM (``repro_torch``'s DTensor path) runs one process a rank.
This probe starts ranks on the one device (``launch.mesh.spawn_ranks``,
each rank a spawned process over a TCP store on localhost) and runs one
collective at a time on tensors of that device, each in a fresh group, so
a collective that hangs hides no other:

* the classic ``torch.distributed`` calls: ``all_reduce``, ``broadcast``,
  ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_to_all_single``;
* the functional ones (``torch.distributed._functional_collectives``),
  which DTensor's redistribution and the port's ``local_map`` bodies
  (``repro_torch.dist``) call: ``all_reduce``, ``all_gather_tensor``,
  ``reduce_scatter_tensor``, ``permute_tensor``;
* a DTensor ``Shard(0) -> Replicate()`` redistribution over a 1-D mesh.

Cases: gloo at world 2 and 4 (gloo binds the loopback interface), NCCL at
world 1 and 2.  Each rank prints one JSON line when it has joined the
group (``"step": "joined"``) and one when the collective has returned,
with the values it got, the values it should have got and ``"ok"``; a
rank that raises prints the error.  After each collective the probe
prints one summary line: how many ranks joined, how many returned, how
many got the right values, and ``"hung": true`` when some rank had not
returned within ``--hang`` seconds (its processes are then stopped).  The
last line is the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

CLASSIC = ("all_reduce", "broadcast", "all_gather_into_tensor",
           "reduce_scatter_tensor", "all_to_all_single")
FUNCTIONAL = ("funcol.all_reduce", "funcol.all_gather_tensor",
              "funcol.reduce_scatter_tensor", "funcol.permute_tensor",
              "dtensor.redistribute")
CASES = (("gloo", 2), ("gloo", 4), ("nccl", 1), ("nccl", 2))


def emit(rec: dict) -> None:
    """One JSON line to standard output in a single write, so the lines of
    ranks that print at once do not interleave."""
    os.write(1, (json.dumps(rec) + "\n").encode())


def collective(step: str, rank: int, world: int, dev):
    """Run ``step`` on this rank; return ``(got, want)`` as lists."""
    import torch
    import torch.distributed as tdist
    import torch.distributed._functional_collectives as fc
    g = tdist.group.WORLD
    x = torch.full((4,), float(rank + 1), device=dev)
    total = float(world * (world + 1) // 2)
    if step == "all_reduce":
        tdist.all_reduce(x)
        return x.tolist(), [total] * 4
    if step == "broadcast":
        tdist.broadcast(x, 0)
        return x.tolist(), [1.0] * 4
    if step == "all_gather_into_tensor":
        out = torch.empty(4 * world, device=dev)
        tdist.all_gather_into_tensor(out, x)
        return out.tolist(), [float(r + 1) for r in range(world)
                              for _ in range(4)]
    if step == "reduce_scatter_tensor":
        out = torch.empty(4, device=dev)
        tdist.reduce_scatter_tensor(out, x.repeat(world))
        return out.tolist(), [total] * 4
    if step == "all_to_all_single":
        src = torch.arange(world, device=dev, dtype=torch.float32) \
            + 10 * rank
        out = torch.empty_like(src)
        tdist.all_to_all_single(out, src)
        return out.tolist(), [float(10 * r + rank) for r in range(world)]
    if step == "funcol.all_reduce":
        return fc.all_reduce(x, "sum", g).tolist(), [total] * 4
    if step == "funcol.all_gather_tensor":
        return fc.all_gather_tensor(x, 0, g).tolist(), [
            float(r + 1) for r in range(world) for _ in range(4)]
    if step == "funcol.reduce_scatter_tensor":
        return fc.reduce_scatter_tensor(x.repeat(world), "sum", 0,
                                        g).tolist(), [total] * 4
    if step == "funcol.permute_tensor":
        y = fc.permute_tensor(x, [(r + 1) % world for r in range(world)], g)
        return y.tolist(), [float((rank - 1) % world + 1)] * 4
    if step == "dtensor.redistribute":
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard
        mesh = init_device_mesh(dev.type, (world,))
        d = DTensor.from_local(x, mesh, [Shard(0)], run_check=False)
        return d.redistribute(mesh, [Replicate()]).to_local().tolist(), [
            float(r + 1) for r in range(world) for _ in range(4)]
    raise ValueError(step)


def probe_rank(rank: int, world: int, backend: str, step: str,
               device: str) -> bool:
    import torch
    if device == "cuda":
        torch.cuda.set_device(0)
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        "cpu")
    emit({"backend": backend, "world": world, "rank": rank,
          "step": "joined"})
    t0 = time.perf_counter()
    try:
        got, want = collective(step, rank, world, dev)
        if device == "cuda":
            torch.cuda.synchronize()
    except Exception as e:      # reported, then the group is torn down
        emit({"backend": backend, "world": world, "rank": rank,
              "step": step, "error": repr(e)[:300]})
        return False
    emit({"backend": backend, "world": world, "rank": rank, "step": step,
          "ok": got == want, "got": got, "want": want,
          "s": round(time.perf_counter() - t0, 3)})
    return got == want


def run_case(backend: str, world: int, step: str, device: str,
             hang: float) -> dict:
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.perf_counter()
    rec = {"summary": True, "backend": backend, "world": world,
           "step": step, "hung": False, "error": None}
    try:
        oks = spawn_ranks(probe_rank, world, backend=backend,
                          args=(world, backend, step, device), timeout=hang)
        rec["ranks_ok"] = sum(oks)
    except TimeoutError as e:
        rec["hung"], rec["error"] = True, str(e)
    except RuntimeError as e:
        rec["error"] = str(e).strip().splitlines()[-1][:300]
    rec["s"] = round(time.perf_counter() - t0, 1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--hang", type=float, default=45.0,
                    help="seconds a collective may take before it counts "
                         "as hung")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    for backend, world in CASES:
        if backend == "nccl" and args.device != "cuda":
            continue
        for step in CLASSIC + FUNCTIONAL:
            print(json.dumps(run_case(backend, world, step, args.device,
                                      args.hang)), flush=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
