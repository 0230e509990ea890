"""Generic fault-tolerant training loop (repro's ``train/train_loop.py``
in PyTorch).

Composes: a model loss fn + an optimizer + a checkpoint manager +
optional gradient compression. ``loss_fn(params, batch)`` takes a param
tree of leaf tensors (``train/tree``); the step differentiates it with
autograd, then updates params and optimizer state in place
(``train/optimizer``). Every reduction of the step runs in a fixed order
on the card (the backward kernels use no atomics), so a run resumed from
a checkpoint repeats the uninterrupted run bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from . import grad_compress
from .checkpoint import CheckpointManager
from .optimizer import Optimizer
from .tree import leaves, unflatten


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0
    ef_state: Any = None          # error-feedback accumulators (optional)


def grad_accum_value_and_grad(loss_fn: Callable, accum: int = 1,
                              mesh=None, specs=None) -> Callable:
    """(params, batch) -> (loss, grads) of ``loss_fn(params, batch)``:
    grads a tree like ``params`` (each in its param's dtype, zeros where
    the loss does not reach a leaf, as ``jax.grad`` gives). With
    ``accum`` > 1 the batch is cut into ``accum`` microbatches as repro
    cuts it: microbatch j is rows j::accum of every array (repro splits B
    as (B/accum, accum) and swaps the axes). Each one's gradient is added
    into the params' ``.grad`` in the param dtype, and loss and grads are
    multiplied by 1/accum at the end.

    On one rank of a ``mesh`` (params and batch this rank's blocks,
    ``specs`` the params' executed spec tree), the loss stays the global
    mean: the returned loss is the mean over the data-parallel axes of
    the ranks' local losses (the model axis computes the same one). Each
    rank differentiates its share of that mean, its local loss over the
    world size (the collectives' backwards sum the shares,
    ``launch/collectives``), and each leaf's gradient is then summed
    over every mesh axis its spec does not name (``reduce_grads``): over
    a data-parallel axis that is the mean of the ranks' local-mean
    gradients; a leaf that the forward all-gathers over "data" (the MoE
    experts) names "data", and has its sum from the gather's backward
    alone. Nothing is summed twice."""
    share = 1.0
    if mesh is not None:
        from ..launch.mesh import axis_size
        share = 1.0 / axis_size(mesh, mesh.mesh_dim_names)

    def fn(params, batch):
        named = leaves(params)
        for _, p in named:
            p.requires_grad_(True)
            p.grad = None
        total = None
        for j in range(accum):
            mb = batch if accum == 1 else {k: v[j::accum]
                                           for k, v in batch.items()}
            loss = loss_fn(params, mb)
            (loss if mesh is None else loss * share).backward()
            total = loss.detach() if total is None else \
                total + loss.detach()
        grads = []
        with torch.no_grad():
            for _, p in named:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                p.grad = None
                if accum > 1:
                    g.mul_(1.0 / accum)
                grads.append(g)
        if accum > 1:
            total = total * (1.0 / accum)
        grads = unflatten(params, grads)
        if mesh is not None:
            from ..launch.collectives import all_reduce_mean
            from ..launch.mesh import dp_axes
            with torch.no_grad():
                grads = reduce_grads(grads, specs, mesh)
                total = all_reduce_mean(total, mesh, dp_axes(mesh))
        return total, grads

    return fn


def reduce_grads(grads, specs, mesh):
    """Each leaf's gradient summed over the mesh axes its spec (a
    ``launch/sharding.P``) does not name, in place (an all-reduce; the
    ZeRO-1 optimizer then reads its block of it, ``train/zero``)."""
    from ..launch.collectives import all_reduce_sum_
    from ..launch.sharding import replicated_axes

    out = []
    for (_, g), (_, spec) in zip(leaves(grads), leaves(specs)):
        axes = replicated_axes(spec, mesh)
        out.append(all_reduce_sum_(g.contiguous(), mesh, axes) if axes
                   else g)
    return unflatten(grads, out)


def grad_norm(grads) -> torch.Tensor:
    """sqrt of the fp32 sum over leaves of each leaf's sum of squares."""
    total = None
    for _, g in leaves(grads):
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    compress: bool = False) -> Callable:
    """loss_fn(params, batch) -> scalar. Returns
    step(params, opt_state, ef_state, batch, step) ->
    (params, opt_state, ef_state, metrics), params and opt_state updated
    in place."""
    vg = grad_accum_value_and_grad(loss_fn)

    def step_fn(params, opt_state, ef_state, batch, step):
        loss, grads = vg(params, batch)
        if compress:
            grads, ef_state = grad_compress.compress_decompress(
                grads, ef_state)
        with torch.no_grad():
            params, opt_state = optimizer.update(grads, opt_state, params,
                                                 step)
            gnorm = grad_norm(grads)
        return params, opt_state, ef_state, {"loss": loss,
                                             "grad_norm": gnorm}

    return step_fn


class Trainer:
    def __init__(self, loss_fn: Callable, optimizer: Optimizer,
                 params: Any, checkpoint_dir: Optional[str] = None,
                 compress_grads: bool = False,
                 checkpoint_every: int = 100, keep_last: int = 3,
                 async_checkpoint: bool = True):
        self.optimizer = optimizer
        self.state = TrainState(
            params=params, opt_state=optimizer.init(params),
            ef_state=(grad_compress.init_state(params)
                      if compress_grads else None))
        self.compress = compress_grads
        self.step_fn = make_train_step(loss_fn, optimizer, compress_grads)
        self.ckpt = (CheckpointManager(checkpoint_dir, keep_last)
                     if checkpoint_dir else None)
        self.checkpoint_every = checkpoint_every
        self.async_checkpoint = async_checkpoint
        self.history: list[dict] = []

    # -- restart-resume -------------------------------------------------
    def try_restore(self) -> bool:
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        tree = {"params": self.state.params,
                "opt_state": self.state.opt_state}
        restored, step, _ = self.ckpt.restore(tree)
        self.state.params = restored["params"]
        self.state.opt_state = restored["opt_state"]
        self.state.step = step
        return True

    def run(self, batches, n_steps: Optional[int] = None,
            log_every: int = 10) -> list[dict]:
        t0 = time.perf_counter()
        for i, batch in enumerate(batches):
            if n_steps is not None and i >= n_steps:
                break
            s = self.state
            new_p, new_o, new_e, metrics = self.step_fn(
                s.params, s.opt_state, s.ef_state, batch, s.step)
            s.params, s.opt_state, s.ef_state = new_p, new_o, new_e
            s.step += 1
            if s.step % log_every == 0 or i == 0:
                rec = {"step": s.step,
                       "loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "wall_s": time.perf_counter() - t0}
                self.history.append(rec)
            if self.ckpt and s.step % self.checkpoint_every == 0:
                self.checkpoint()
        if self.ckpt:
            self.ckpt.wait()
        return self.history

    def checkpoint(self) -> None:
        assert self.ckpt is not None
        self.ckpt.save(self.state.step,
                       {"params": self.state.params,
                        "opt_state": self.state.opt_state},
                       blocking=not self.async_checkpoint)
