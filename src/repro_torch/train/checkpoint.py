"""Checkpoints in the JAX package's on-disk layout (``train/checkpoint.py``):

    <dir>/step_00000100/
        manifest.json      — {"step", "arrays": {key: {"shape", "dtype"}}}
        shard_0.npz        — every array, keyed by its tree path joined by "/"
        _COMPLETE          — written last (atomicity marker)

A checkpoint is written to ``step_XXXXXXXX.tmp`` and renamed into place,
and only directories holding ``_COMPLETE`` count, so a crash mid-write
leaves the previous checkpoint in charge.  ``keep`` bounds how many stay.
bfloat16 arrays are stored as uint16 with the true dtype in the manifest.
The two packages read each other's checkpoints: the keys, shapes and dtypes
of a trainer state are the same in both.

A sharded state (DTensor leaves, one process a rank) is saved whole, as
JAX's single ``shard_0.npz``: every rank gathers each leaf, rank 0 writes,
and the ranks meet at a barrier before the call returns.  ``restore`` reads
the full arrays on every rank and places each leaf where ``shardings``
says (the elastic re-mesh: any mesh, or one device), by default where its
``like`` leaf lies.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from concurrent.futures import Executor, Future
from typing import Dict, Optional

import numpy as np
import torch

from .. import dist
from ..tree import flatten, unflatten

__all__ = ["save", "save_async", "all_steps", "latest_step", "restore"]


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _to_numpy(t: torch.Tensor):
    """``(array npz can hold, true dtype name)`` of a host copy of ``t``."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _snapshot(tree) -> Dict[str, tuple]:
    """Host copies of every leaf, taken now (the tree may move on); a
    DTensor leaf is gathered whole first (a collective: every rank
    calls)."""
    return {k: _to_numpy(v.full_tensor() if dist.is_dtensor(v) else v)
            for k, v in flatten(tree).items()}


def _sharded(tree) -> bool:
    return any(dist.is_dtensor(v) for v in flatten(tree).values())


def _writer() -> bool:
    """Whether this process writes: rank 0 of an initialised process group,
    or the only process."""
    import torch.distributed as tdist
    return not tdist.is_initialized() or tdist.get_rank() == 0


def _write(ckpt_dir: str, step: int, arrays: Dict[str, tuple],
           keep: int) -> str:
    path = _step_dir(ckpt_dir, step)
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "arrays": {
        k: {"shape": list(a.shape), "dtype": d} for k, (a, d) in arrays.items()}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    np.savez(os.path.join(tmp, "shard_0.npz"),
             **{k: a for k, (a, _) in arrays.items()})
    with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
        f.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
    return path


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Write a checkpoint of ``tree`` now; returns its path.  A sharded tree
    is saved by every rank's call together (see the module docstring)."""
    arrays = _snapshot(tree)
    if not _sharded(tree):
        return _write(ckpt_dir, step, arrays, keep)
    import torch.distributed as tdist
    if _writer():
        _write(ckpt_dir, step, arrays, keep)
    tdist.barrier()
    return _step_dir(ckpt_dir, step)


def save_async(executor: Executor, ckpt_dir: str, step: int, tree, *,
               keep: int = 3) -> Future:
    """Copy ``tree`` to the host now and write it on ``executor``; the
    future's result is the path (read it: it raises if the write failed).
    A sharded tree is saved at once, as :func:`save` does."""
    if _sharded(tree):
        fut = Future()
        fut.set_result(save(ckpt_dir, step, tree, keep=keep))
        return fut
    return executor.submit(_write, ckpt_dir, step, _snapshot(tree), keep)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.match(r"step_(\d+)$", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "_COMPLETE")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like, shardings=None):
    """The checkpoint at ``step`` in the structure of the tree ``like``, in
    the stored dtypes.  Each leaf goes where the matching leaf of
    ``shardings`` says — a ``(DeviceMesh, spec)`` pair places it as a
    DTensor (each rank keeps its slice), a device puts it whole there —
    and without ``shardings`` where its ``like`` leaf lies (a DTensor
    ``like`` leaf: on its mesh, in its placements).  Raises if a key is
    missing or a shape differs."""
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    targets = {} if shardings is None else flatten(shardings)
    flat = {}
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        for key, ref in flatten(like).items():
            if key not in data.files:
                raise KeyError(f"checkpoint {path} has no array {key!r}")
            arr = data[key]
            if manifest["arrays"][key]["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} "
                                 f"!= {tuple(ref.shape)}")
            flat[key] = _put(t, targets.get(key, ref))
    return unflatten(flat)


def _put(t: torch.Tensor, target):
    """``t`` (a full host tensor) where ``target`` says: a ``(mesh,
    spec)`` pair, a DTensor to match, a tensor whose device to take, or a
    device."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(target, tuple):
        mesh, spec = target
        return dist.place(t.to(_mesh_device(mesh)), spec, mesh)
    if dist.is_dtensor(target):
        return distribute_tensor(t.to(target.to_local().device),
                                 target.device_mesh, target.placements,
                                 src_data_rank=None)
    return t.to(target.device if isinstance(target, torch.Tensor)
                else target)


def _mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
