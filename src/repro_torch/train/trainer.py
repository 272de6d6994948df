"""Training loop of the port (the JAX package's ``train/trainer.py``):

* checkpoint/restart: atomic checkpoints every K steps, resume from the
  latest on start (the data pipeline is stateless in ``step``, so a restart
  continues bit-exactly);
* preemption: SIGTERM sets a flag; the loop writes a final checkpoint and
  stops after the current step;
* gradient accumulation over ``accum`` microbatches;
* optional int8 gradient compression with error feedback.

The state is the JAX trainer's tree — ``params``, ``opt`` (``m``, ``v``,
``step``), ``ef`` and ``step`` — so a checkpoint that either package writes
restores in the other.  On a CUDA device every reservoir scan and its
gradient, and every flash-attention forward, run through the hand-written
kernels (``kernels.ops``).  Keyword arguments of :class:`Trainer` beyond the
device and ``prof`` (``attn_impl``, ``remat``) go to ``lm.forward``.

``prof`` (a ``ShardProfile`` over a ``DeviceMesh``; every rank of the
process group runs the same loop) trains on the mesh: the params, their
state and each batch are DTensors placed by ``lm.param_specs`` and the
batch axes, each gradient is reduced to its param's placements, and
checkpoints hold full tensors, so they restore onto any mesh or one device
(``checkpoint.restore(..., shardings=)``).
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from .. import dist, resolve_device
from ..models import lm
from ..tree import flatten, tree_map, unflatten
from . import checkpoint as ckpt_mod
from . import compression
from . import optimizer as opt_mod

__all__ = ["TrainConfig", "loss_and_grads", "make_step_fn", "Trainer"]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    ckpt_async: bool = False
    log_every: int = 10
    accum: int = 1               # gradient-accumulation microbatches
    compress_grads: bool = False
    lr: float = 3e-3
    optimizer: str = "adamw"


def loss_and_grads(cfg_arch, params, batch, **fwd_kw):
    """``(loss, metrics, grads)`` of ``lm.loss_fn`` at ``params``; ``grads``
    has the params' tree.  The token embeddings of an untied model fed
    ``embeds`` are the one leaf the loss cannot reach: they get zeros, as
    ``jax.grad`` gives.  Any other leaf cut off from the loss raises.
    ``params`` are not modified.  DTensor gradients come back in their
    params' placements (a partial sum over the batch axes is summed: the
    data-parallel gradient reduction); the loss and metrics come back
    whole (plain tensors)."""
    flat = flatten(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    loss, metrics = lm.loss_fn(unflatten(leaves), cfg_arch, batch, **fwd_kw)
    fed_embeds = cfg_arch.input_mode == "embeddings" and "embeds" in batch
    unreached = ({"embed"} if fed_embeds and not cfg_arch.tie_embeddings
                 else set())
    reached = [k for k in leaves if k not in unreached]
    # The backward, like the forward, may meet plain constants on a mesh.
    with dist.mesh_context(loss.device_mesh if dist.is_dtensor(loss)
                           else None):
        grads = dict(zip(reached, torch.autograd.grad(
            loss, [leaves[k] for k in reached])))
    grads.update({k: torch.zeros_like(leaves[k]) for k in unreached})
    if dist.is_dtensor(loss):
        grads = {k: g.redistribute(leaves[k].device_mesh,
                                   leaves[k].placements)
                 for k, g in grads.items()}
        # The loss and metrics whole on every rank (a DTensor scalar may be
        # a partial mean, which .item() would read as this rank's term).
        loss, metrics = loss.full_tensor(), dist.full(metrics)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten({k: grads[k] for k in leaves}))


def make_step_fn(cfg_arch, train_cfg: TrainConfig, opt, prof=None,
                 **fwd_kw):
    """``step_fn(params, opt_state, ef_state, batch) -> (params, opt_state,
    ef_state, loss, metrics)``; ``prof``: the sharding profile (None: one
    device)."""
    fwd_kw = dict(fwd_kw, prof=prof or lm.NULL_PROFILE)
    def step_fn(params, opt_state, ef_state, batch):
        if train_cfg.accum > 1:
            # Mean of the microbatches' gradients and losses.
            n = train_cfg.accum
            mbs = [tree_map(lambda x: x.reshape((n, x.shape[0] // n)
                                                + tuple(x.shape[1:]))[i],
                            batch) for i in range(n)]
            loss, grads = 0.0, None
            for mb in mbs:
                l, _, g = loss_and_grads(cfg_arch, params, mb, **fwd_kw)
                loss = loss + l
                grads = g if grads is None else tree_map(
                    torch.add, grads, g)
            grads = tree_map(lambda g: g / n, grads)
            loss, metrics = loss / n, {}
        else:
            loss, metrics, grads = loss_and_grads(cfg_arch, params, batch,
                                                  **fwd_kw)
        if train_cfg.compress_grads:
            grads, ef_state = compression.compress_decompress_ef(
                grads, ef_state)
        updates, opt_state = opt.update(grads, opt_state, params)
        del grads               # freed before the new params are built
        params = opt_mod.apply_updates(params, updates)
        return params, opt_state, ef_state, loss, metrics

    return step_fn


class Trainer:
    """The training loop; ``device`` ``None`` means the GPU (on a mesh:
    this rank's device); ``prof`` a sharding profile (see the module
    docstring)."""

    def __init__(self, cfg_arch, train_cfg: TrainConfig, data, device=None,
                 prof=None, **fwd_kw):
        self.cfg_arch = cfg_arch
        self.tc = train_cfg
        self.data = data
        self.device = resolve_device(device)
        self.prof = prof or lm.NULL_PROFILE
        self.opt = opt_mod.make_optimizer(train_cfg.optimizer, lr=train_cfg.lr)
        self._stop = False
        self.step_fn = make_step_fn(cfg_arch, train_cfg, self.opt, self.prof,
                                    **fwd_kw)
        self.losses: list = []
        self.step_seconds: list = []      # host wall time of each step

    # ---------------------------------------------------------------- state
    def init_state(self, seed=0):
        gen = torch.Generator().manual_seed(seed)
        params = lm.init_params(gen, self.cfg_arch, self.device)
        return self.state_of(params)

    def state_of(self, params):
        """A fresh trainer state around ``params`` (a full tree: on a mesh it
        is placed by ``lm.param_specs``)."""
        if self.prof.mesh is not None:
            params = lm.place_params(params, self.cfg_arch, self.prof)
        ef = (compression.init_ef(params) if self.tc.compress_grads else
              {"_": torch.zeros((), device=self.device)})
        return {"params": params, "opt": self.opt.init(params), "ef": ef,
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device)}

    def maybe_restore(self, state):
        if not self.tc.ckpt_dir:
            return state, 0
        last = ckpt_mod.latest_step(self.tc.ckpt_dir)
        if last is None:
            return state, 0
        return ckpt_mod.restore(self.tc.ckpt_dir, last, state), int(last)

    def batch_at(self, step):
        """The data's batch at ``step`` on the device; on a mesh each leaf
        split over the batch axes on dim 0."""
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in self.data.batch_at(step).items()}
        if self.prof.mesh is None:
            return batch
        specs = {k: (self.prof.dp_spec,) + (None,) * (v.ndim - 1)
                 for k, v in batch.items()}
        return dist.place(batch, specs, self.prof.mesh)

    def _on_sigterm(self, signum, frame):
        self._stop = True

    # ---------------------------------------------------------------- loop
    def run(self, seed=0, start_state=None):
        state = start_state or self.init_state(seed)
        state, start = self.maybe_restore(state)
        main = threading.current_thread() is threading.main_thread()
        old = signal.signal(signal.SIGTERM, self._on_sigterm) if main else None
        saver = ThreadPoolExecutor(1) if self.tc.ckpt_async else None
        pending = []
        try:
            t0 = time.perf_counter()
            for step in range(start, self.tc.steps):
                t_step = time.perf_counter()
                batch = self.batch_at(step)
                p, o, ef, loss, _ = self.step_fn(
                    state["params"], state["opt"], state["ef"], batch)
                state = {"params": p, "opt": o, "ef": ef,
                         "step": torch.tensor(step + 1, dtype=torch.int32,
                                              device=self.device)}
                self.losses.append(float(loss))     # waits for the step
                self.step_seconds.append(time.perf_counter() - t_step)
                if self.tc.log_every and (step + 1) % self.tc.log_every == 0:
                    dt = (time.perf_counter() - t0) / max(len(self.losses), 1)
                    print(f"step {step + 1} loss {float(loss):.4f} "
                          f"({dt * 1e3:.0f} ms/step)", flush=True)
                if (self.tc.ckpt_dir and self.tc.ckpt_every
                        and (step + 1) % self.tc.ckpt_every == 0):
                    if saver is None:
                        ckpt_mod.save(self.tc.ckpt_dir, step + 1, state,
                                      keep=self.tc.ckpt_keep)
                    else:
                        pending.append(ckpt_mod.save_async(
                            saver, self.tc.ckpt_dir, step + 1, state,
                            keep=self.tc.ckpt_keep))
                if self._stop:   # preemption: final checkpoint + clean exit
                    break
        finally:
            if old is not None:
                signal.signal(signal.SIGTERM, old)
            if saver is not None:
                saver.shutdown(wait=True)
        for fut in pending:
            fut.result()
        if self.tc.ckpt_dir:
            last = int(state["step"])
            if ckpt_mod.latest_step(self.tc.ckpt_dir) != last:
                ckpt_mod.save(self.tc.ckpt_dir, last, state,
                              keep=self.tc.ckpt_keep)
        return state
