"""Training loop: grad-accumulation microbatching, ``make_train_step``, a
gradient hook, metrics.

The counterpart of ``repro.train.loop``.  A train state is the tree
``{"params": ..., "opt_state": ...}`` (``repro``'s pytree, so checkpoints
cross the packages); its parameter leaves are tensors that require grad,
and a step updates them in place.  PyTorch runs eagerly, so there is no
jit: a Python loop over the microbatches takes the place of
``lax.scan``.  Sharded state (``DTensor`` leaves, ``launch.steps.
shard_cell``) runs the same step: the loss is replicated before its grad
is taken, the accumulated grads follow their parameters' placements, and
the reported loss is this rank's replica.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..core import tree as tree_mod
from ..models import sharding_utils as su
from . import optimizer as opt_mod


def _grads_of(loss_fn: Callable, params, batch):
    """(loss, grads tree): the gradient of ``loss_fn(params, batch)[0]``
    with respect to every parameter leaf (zeros where it is unused)."""
    loss, _ = loss_fn(params, batch)
    sharded = su.is_dtensor(loss)
    if sharded:  # a DTensor loss is replicated before its grad is taken
        from torch.distributed.tensor import Replicate

        loss = loss.redistribute(loss.device_mesh, [Replicate()] * loss.device_mesh.ndim)
    leaves = tree_mod.leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    loss = loss.detach()
    return (loss.to_local() if sharded else loss), tree_mod.unflatten(params, grads)


def make_train_step(
    loss_fn: Callable,
    opt_cfg: opt_mod.OptimizerConfig,
    *,
    grad_accum: int = 1,
    compress_fn: Optional[Callable] = None,
):
    """Build ``step(state, batch) -> (state, metrics)``.

    ``grad_accum`` > 1 expects batch leaves shaped [accum, ...] and runs
    the microbatches one after another, accumulating float32 grads (one
    parameter-sized buffer).  ``compress_fn`` maps grads -> grads before
    the optimizer (a gradient-compression hook).  The state's tensors are
    updated in place and returned.
    """

    def step(state, batch):
        params = state["params"]
        if grad_accum > 1:
            acc = tree_mod.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            losses = []
            for i in range(grad_accum):
                mb = tree_mod.tree_map(lambda x: x[i], batch)
                loss, grads = _grads_of(loss_fn, params, mb)
                tree_mod.tree_map(
                    lambda a, g: a.copy_(a + opt_mod.follow(g, a).to(torch.float32) / grad_accum),
                    acc, grads)
                losses.append(loss)
            grads = acc
            loss = torch.stack(losses).mean()
        else:
            loss, grads = _grads_of(loss_fn, params, batch)
        if compress_fn is not None:
            grads = compress_fn(grads)
        new_params, new_opt, om = opt_mod.update(grads, state["opt_state"], params, opt_cfg)
        return {"params": new_params, "opt_state": new_opt}, {"loss": loss, **om}

    return step


def init_state(params, opt_cfg: opt_mod.OptimizerConfig) -> dict:
    return {"params": params, "opt_state": opt_mod.init(params, opt_cfg)}


def train(
    state: dict,
    step_fn: Callable,
    batches,
    *,
    hooks=(),
    log_every: int = 10,
) -> tuple[dict, list[dict]]:
    """Simple loop: iterate batches, run hooks (checkpoint/fault)."""
    history = []
    t0 = time.time()
    for i, batch in enumerate(batches):
        state, metrics = step_fn(state, batch)
        for h in hooks:
            state = h(i, state) or state
        if i % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["wall"] = time.time() - t0
            history.append(m)
    return state, history
