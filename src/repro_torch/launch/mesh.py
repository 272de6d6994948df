"""Device meshes: the serving arena's grid, and the sharded LM's
``DeviceMesh``.

The counterpart of ``repro.launch.mesh``.  Two kinds of mesh exist because
the two halves of the system run in two ways.  The serving engine is
single-controller, as the JAX engine is: one process submits, flushes and
decodes for the whole mesh, so its :class:`Mesh` is a small grid of
``torch.device`` in that process, axes ``("data", "model")``, holding one
shard of the arena on each device (``sharding.rules.plan_arena``,
``serve.arena.ShardedArena``); no process group is involved.  A device may
repeat in the grid: shards on one device are *logical* shards, the port's
counterpart of JAX's placeholder host devices.

The LM trains and decodes SPMD, as JAX's ``jit`` over a mesh does, but
PyTorch has no single-process partitioner: its counterpart is DTensor over
a ``DeviceMesh`` with one process (rank) a device.  :func:`make_lm_mesh`
builds that mesh over the initialised process group, axes named as JAX's;
:func:`spawn_ranks` starts the ranks of one host (``torch.multiprocessing``,
a TCP store on localhost); :func:`make_production_mesh` is the (16, 16) /
(2, 16, 16) pod mesh the dry run traces against, under a fake process
group of 256 or 512 ranks (no devices, shapes only).
"""
from __future__ import annotations

import dataclasses
import os
import queue
import socket
import time
import traceback
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_local_mesh", "check_mesh", "make_lm_mesh",
           "make_production_mesh", "spawn_ranks"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: a numpy object array of ``torch.device``, shape
    ``(n_data, n_model)``; ``axis_names``: ``("data", "model")``."""
    devices: np.ndarray
    axis_names: Tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of axes {self.axis_names} needs a "
                             f"{len(self.axis_names)}-d device grid, got "
                             f"shape {self.devices.shape}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as JAX's ``dict(zip(mesh.axis_names,
        mesh.devices.shape))``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def home(self) -> torch.device:
        """The first device of the grid: where a sharded engine keeps what
        is not sharded and assembles what it reads back."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        names = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({names}, devices={[str(d) for d in self.devices.flat]})"


def make_local_mesh(n_data: int = 1, n_model: int = 1, *,
                    devices: Optional[Sequence] = None) -> Mesh:
    """A ``(n_data, n_model)`` mesh over ``("data", "model")``.

    ``devices=None`` takes the first ``n_data * n_model`` CUDA devices and
    raises ``ValueError`` when there are fewer.  An explicit ``devices``
    list (row-major over the grid) may repeat a device (logical shards), and
    must hold one device type."""
    n_data, n_model = int(n_data), int(n_model)
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({n_data}, {n_model})")
    need = n_data * n_model
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if need > have:
            raise ValueError(f"a ({n_data}, {n_model}) mesh needs {need} CUDA "
                             f"devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(need)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != need:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {need} devices, "
                         f"got {len(devices)}")
    kinds = {d.type for d in devices}
    if len(kinds) != 1:
        raise ValueError(f"a mesh holds one device type, got "
                         f"{sorted(kinds)}")
    grid = np.empty((n_data, n_model), dtype=object)
    for k, d in enumerate(devices):
        grid[k // n_model, k % n_model] = d
    return Mesh(grid)


def check_mesh(mesh) -> Mesh:
    """``mesh`` if it is a :class:`Mesh`; ``TypeError`` otherwise."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a launch.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh


# --------------------------------------------------------------------------- #
# The sharded LM's DeviceMesh                                                  #
# --------------------------------------------------------------------------- #
def make_lm_mesh(shape: Sequence[int], axes: Optional[Sequence[str]] = None,
                 *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the initialised process group (its
    world size is the product of ``shape``), dims named ``axes`` —
    ``("data", "model")`` for two dims, ``("pod", "data", "model")`` for
    three by default — as JAX's mesh axes."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(n) for n in shape)
    if axes is None:
        axes = {1: ("model",), 2: ("data", "model"),
                3: ("pod", "data", "model")}[len(shape)]
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=tuple(axes))
    # Flattened groups over the batch axes and over the whole mesh: a sum
    # that spans several mesh dims (the gradient of a replicated weight)
    # then takes one all-reduce, the same bits on every rank.
    if len(axes) > 1:
        mesh[tuple(axes)]._flatten()
    if len(axes) > 2:
        mesh[tuple(axes[:2])]._flatten()
    return mesh


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (16, 16) = 256 ranks, axes (data, model).  Multi-pod:
    (2, 16, 16) = 512 ranks, axes (pod, data, model).  Only under a fake
    process group of that world size (``torch.testing._internal.
    distributed.fake_pg``), which the dry run initialises: no device takes
    part, and tensors live on the meta device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_lm_mesh(shape, device_type="cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, backend, port, fn, args, out):
    import torch.distributed as tdist
    try:
        tdist.init_process_group(backend,
                                 init_method=f"tcp://localhost:{port}",
                                 world_size=world, rank=rank)
        out.put((rank, True, fn(rank, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, *, backend: str = "gloo",
                args: tuple = (), timeout: float = 300.0) -> list:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes (``spawn``),
    each rank of one process group over a TCP store on localhost, and
    return the ranks' results in rank order.  ``fn`` and ``args`` must
    pickle (a module-level function).  Gloo binds the loopback interface
    (``GLOO_SOCKET_IFNAME=lo``, unless set), so no network is needed.
    Raises ``RuntimeError`` with the failing rank's traceback, or
    ``TimeoutError`` when the ranks have not all answered within
    ``timeout`` seconds (a hung collective); every process is stopped
    before this returns."""
    import torch.multiprocessing as mp
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, port, fn, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, res = out.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(
                    f"{world - len(results)} of {world} ranks did not answer "
                    f"within {timeout:.0f} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{res}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=10 if len(results) == world else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
