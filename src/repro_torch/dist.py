"""DTensor plumbing of the sharded LM: the JAX package's ``PartitionSpec``s
as DTensor placements, trees placed on and gathered from a device mesh, and
the collectives that the ``local_map`` bodies (the port's ``shard_map``)
call, each with the backward that JAX's transpose rule gives it.

A spec is a plain tuple with one entry a tensor dim: ``None``, a mesh axis
name, or a tuple of axis names (``("pod", "data")``: the dim split over
both, the first outermost), so ``tuple(PartitionSpec(...))`` and the port's
spec compare as they are.  Placements need a ``DeviceMesh``; specs need
only axis names and sizes, so plans are made without a process group.

Nothing here starts a process group: the caller initialises
``torch.distributed`` (one rank per mesh device) before it builds a mesh.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Sequence, Tuple

import torch

from .tree import tree_map

__all__ = ["mesh_axes", "spec_placements", "place", "full", "is_dtensor",
           "mesh_context", "elementwise", "psum", "pmean", "pmax",
           "psum_scatter", "ppermute", "axis_index", "block_index"]


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order, of a ``DeviceMesh`` or of any mesh
    with ``axis_names`` and ``devices.shape`` (JAX's ``Mesh``, the serving
    ``launch.mesh.Mesh``, a plain stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def spec_placements(spec: Sequence, axis_names: Sequence[str]):
    """DTensor placements, one a mesh dim, of ``spec`` on a mesh whose dims
    are ``axis_names``: ``Shard(d)`` where the spec names the dim's axis at
    tensor dim ``d``, ``Replicate()`` where it names it nowhere.  A tuple
    entry must list its axes in mesh order (DTensor splits a dim over
    several mesh dims outermost first, as JAX does over a tuple's axes)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r}, "
                                 f"which is not in the mesh {tuple(names)}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)}: dim {d} lists {axes} "
                             f"out of the mesh's order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {tuple(spec)} names axis "
                                 f"{names[i]!r} twice")
            out[i] = Shard(d)
    return out


def place(tree, specs, mesh):
    """``tree``'s leaves as DTensors on ``mesh`` by the matching ``specs``
    leaves (``jax.device_put(tree, NamedSharding(mesh, spec))``).  Every
    rank passes the same full tensors (made from one seed, or read from one
    checkpoint); each keeps its own slice and nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    names = mesh.mesh_dim_names

    def one(v, spec):
        return distribute_tensor(v, mesh, spec_placements(spec, names),
                                 src_data_rank=None)
    return tree_map(one, tree, specs)


def full(tree):
    """Every DTensor leaf of ``tree`` gathered to its full tensor (a plain
    tensor on the rank's device); other leaves as they are."""
    return tree_map(lambda v: v.full_tensor() if is_dtensor(v) else v, tree)


def mesh_context(mesh):
    """The context a sharded forward runs in: plain tensors made inside it
    (positions, masks, constants) count as replicated on the mesh.  A null
    context without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def elementwise(fn, x):
    """``fn(x)`` for an element-wise ``fn``; on a DTensor, on each rank's own
    shard (``local_map``, placements and gradient placements kept), for an
    op DTensor has no rule for (``log_sigmoid``'s backward)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = [Replicate() if isinstance(p, Partial) else p
          for p in x.placements]
    return local_map(fn, out_placements=pl, in_placements=(pl,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)


# --------------------------------------------------------------------------- #
# Collectives for local_map bodies                                             #
# --------------------------------------------------------------------------- #
def _dims(mesh, axes) -> Tuple[int, ...]:
    names = mesh.mesh_dim_names
    return tuple(names.index(a) for a in axes)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along mesh axis ``axis``
    (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def block_index(mesh, axes) -> int:
    """This rank's block of a dim split over the mesh axes ``axes`` (the
    first outermost, as ``spec_placements`` splits a dim over several)."""
    idx = 0
    for a in axes:
        idx = idx * mesh_axes(mesh)[a] + mesh.get_local_rank(a)
    return idx


def _all_reduce(x, op: str, mesh, axes):
    """All-reduce over the mesh axes ``axes``, one axis after another.
    Every rank of a group ends with the same bits after each step, so
    ranks that meet in a later group reduce equal values in equal order:
    the result is bit-identical on every rank of the product of groups."""
    from torch.distributed import _functional_collectives as funcol
    for d in _dims(mesh, axes):
        x = funcol.wait_tensor(funcol.all_reduce(x, op, (mesh, d)))
    return x


class _PSum(torch.autograd.Function):
    """Forward: sum over ``axes``.  Backward: the identity — the output is
    replicated over ``axes``, so each rank's partial term takes the whole
    cotangent (JAX's transpose of ``psum`` under ``shard_map``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, mean):
        ctx.scale = 1.0 / math.prod(mesh_axes(mesh)[a] for a in axes) \
            if mean else 1.0
        y = _all_reduce(x, "sum", mesh, axes)
        return y * ctx.scale if mean else y

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1.0 else g), None, None, None


def psum(x, mesh, axes):
    """``jax.lax.psum(x, axes)`` inside a ``local_map`` body."""
    return _PSum.apply(x, mesh, tuple(axes), False) if axes else x


def pmean(x, mesh, axes):
    """``jax.lax.pmean(x, axes)`` inside a ``local_map`` body."""
    return _PSum.apply(x, mesh, tuple(axes), True) if axes else x


def pmax(x, mesh, axes):
    """``jax.lax.pmax(x, axes)`` (no gradient)."""
    return _all_reduce(x, "max", mesh, tuple(axes)) if axes else x


def psum_scatter(x, mesh, axis: str, dim: int = 0):
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
    the sum over ``axis``, rank ``i`` keeping the ``i``-th block of ``dim``;
    its backward gathers the blocks (JAX's transpose)."""
    from torch.distributed import _functional_collectives as funcol
    (d,) = _dims(mesh, (axis,))
    return funcol.wait_tensor(
        funcol.reduce_scatter_tensor_autograd(x, "sum", dim, (mesh, d)))


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _permute(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, None


def _permute(x, mesh, axis, shift):
    from torch.distributed import _functional_collectives as funcol
    n = mesh_axes(mesh)[axis]
    (d,) = _dims(mesh, (axis,))
    # permute_tensor's src_dst[i] is the rank of the group that rank i sends
    # to; it splits dim 0 by element counts, so it takes a flat tensor.
    src_dst = [(i + shift) % n for i in range(n)]
    return funcol.wait_tensor(funcol.permute_tensor(
        x.reshape(-1).contiguous(), src_dst, (mesh, d))).reshape(x.shape)


def ppermute(x, mesh, axis: str, shift: int = 1):
    """``jax.lax.ppermute`` by a cyclic ``shift`` along ``axis``: rank ``i``
    sends ``x`` to rank ``i + shift``.  Differentiable: the backward is the
    reverse shift."""
    return _Permute.apply(x, mesh, axis, shift)
