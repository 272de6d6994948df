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
    """Host copies of every leaf, taken now (the tree may move on)."""
    return {k: _to_numpy(v) for k, v in flatten(tree).items()}


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
    """Write a checkpoint of ``tree`` now; returns its path."""
    return _write(ckpt_dir, step, _snapshot(tree), keep)


def save_async(executor: Executor, ckpt_dir: str, step: int, tree, *,
               keep: int = 3) -> Future:
    """Copy ``tree`` to the host now and write it on ``executor``; the
    future's result is the path (read it: it raises if the write failed)."""
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


def restore(ckpt_dir: str, step: int, like):
    """The checkpoint at ``step`` in the structure of the tree ``like``,
    each leaf on its ``like`` leaf's device, in the stored dtype.  Raises if
    a key is missing or a shape differs."""
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
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
            flat[key] = t.to(ref.device)
    return unflatten(flat)
