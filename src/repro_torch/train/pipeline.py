"""GPipe-style pipeline parallelism over a mesh axis (the JAX package's
``train/pipeline.py``; the multi-pod ``pod`` axis option).

SPMD formulation: every stage runs the same program; a microbatch ripples
through the stages by a cyclic shift of +1 on the pipeline axis once a
tick, for ``n_micro + n_stages - 1`` ticks.  Stage 0 takes microbatch t at
tick t; stage S-1 emits microbatch t's result at tick t + S - 1.  The
shift (``dist.ppermute``) is differentiable — its backward is the reverse
shift, JAX's transpose — so training composes with autograd.

``pipeline_apply`` pipelines any per-stage function ``stage_fn(
stage_params, x) -> x`` whose per-stage params carry a leading stage dim
split over the pipeline axis.  It is a ``local_map`` body (JAX's
``shard_map``): each rank runs its own stage.
"""
from __future__ import annotations

import torch

from .. import dist
from ..tree import flatten, unflatten

__all__ = ["pipeline_apply"]


def pipeline_apply(stage_fn, stage_params, x_micro, *, mesh, axis="pod"):
    """Run ``x_micro`` through ``n_stages`` sequential ``stage_fn``s,
    pipelined over its microbatches.

    ``stage_fn``: ``(stage_params_local, x (mb, ...)) -> y (mb, ...)``;
    ``stage_params``: a DTensor, or a tree of them, on the ``DeviceMesh``
    ``mesh``, each leaf (n_stages, ...) split over ``axis``; ``x_micro``: a DTensor
    (n_micro, mb, ...), replicated.  Returns the (n_micro, mb, ...)
    outputs, replicated.

    Gradients: a stage's params get exact gradients on their own rank;
    ``x_micro``'s gradient is stage 0's, partial over ``axis``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    names = mesh.mesh_dim_names
    n_stages = dist.mesh_axes(mesh)[axis]
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    keys = list(flatten(stage_params))
    rep = [Replicate()] * len(names)
    staged = [Shard(0) if a == axis else Replicate() for a in names]
    x_grad = [Partial() if a == axis else Replicate() for a in names]

    def shard_fn(x_micro, *leaves):
        local = {k: v[0] for k, v in zip(keys, leaves)}
        sp = unflatten(local) if isinstance(stage_params, dict) else \
            local[""]
        stage = dist.axis_index(mesh, axis)
        first = torch.tensor(stage == 0, device=x_micro.device)
        last = torch.tensor(stage == n_stages - 1, device=x_micro.device)
        x_in = torch.zeros_like(x_micro[0])
        outs = []
        # Every rank builds the same graph (selects, not branches), so each
        # shift's backward runs on every rank of the axis.
        for t in range(ticks):
            # Stage 0 takes a fresh microbatch, the others their
            # predecessor's output.
            x = torch.where(first, x_micro[min(t, n_micro - 1)], x_in)
            y = stage_fn(sp, x)
            x_in = dist.ppermute(y, mesh, axis, 1)   # S-1 -> 0 is unused
            if t >= n_stages - 1:
                outs.append(torch.where(last, y, torch.zeros_like(y)))
        # Only the last stage's outputs are real: a masked sum broadcasts
        # them (a source may appear once in a permutation).
        return dist.psum(torch.stack(outs), mesh, (axis,))

    run = local_map(shard_fn, out_placements=rep,
                    in_placements=(rep,) + (staged,) * len(keys),
                    in_grad_placements=(x_grad,) + (staged,) * len(keys),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(x_micro, *flatten(stage_params).values())
