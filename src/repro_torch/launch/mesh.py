"""Device meshes for the sharded slot arena.

The counterpart of ``repro.launch.mesh``.  A :class:`Mesh` is a small grid
of ``torch.device`` in one process, with axes ``("data", "model")``: the
serving engine is single-controller, as the JAX engine is (one process
submits, flushes and decodes for the whole mesh), and keeps one shard of
the arena on each device of the grid (``sharding.rules.plan_arena``,
``serve.arena.ShardedArena``).  No process group is involved.

A device may repeat in the grid: shards on one device are *logical* shards,
the port's counterpart of JAX's placeholder host devices
(``xla_force_host_platform_device_count``).  They run the real sharded code
path, with each shard's own kernel launches, on one GPU or on the CPU.

``make_production_mesh`` (the (16, 16) / (2, 16, 16) TPU pod meshes the
dry run lowers against) is not ported here: it comes with the dry-run
slice (ROADMAP A3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_local_mesh", "check_mesh"]


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
