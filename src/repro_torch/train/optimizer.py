"""Optimizers: AdamW (configurable state dtype), Adafactor (factored second
moment) and SGD, with global-norm clipping and a warmup-cosine schedule.

The counterpart of ``repro.train.optimizer``, formula for formula:
bias correction from an int32 step, decoupled weight decay on matrices
only, ``state_dtype`` for the moments, Adafactor's factored moments.
``torch.optim.AdamW`` is not used: it decays every parameter and has no
such schedule.  Parameters and state are trees (``core.tree``) shaped as
``repro``'s pytrees, so a checkpoint's keys are ``repro``'s.  ``update``
writes the new values into the parameter and state tensors in place,
under ``torch.no_grad()``, and returns the same trees.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..core import tree as tree_mod
from ..models import sharding_utils as su


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor | sgd
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Any = torch.float32   # bf16 halves the moments' memory
    min_lr_ratio: float = 0.1


#: elements of a leaf AdamW updates at a time: its float32 temporaries stay
#: a few times this, whatever the leaf's size (a 5M x 256 table's would be
#: ~25 GB); the update is elementwise, so the chunks give the same bits
UPDATE_CHUNK = 1 << 26


def _row_chunks(*ts):
    """Views of ``ts`` (one shape) over runs of leading rows, each at most
    ``UPDATE_CHUNK`` elements (or one row); the whole tensors if small."""
    first = ts[0]
    if first.ndim == 0 or first.numel() <= UPDATE_CHUNK:
        yield ts
        return
    rows = max(UPDATE_CHUNK // (first.numel() // first.shape[0]), 1)
    for i in range(0, first.shape[0], rows):
        yield tuple(t[i:i + rows] for t in ts)


def schedule(step, cfg: OptimizerConfig) -> torch.Tensor:
    """Learning rate at ``step`` (int or int32 tensor): linear warmup, then
    cosine decay to ``min_lr_ratio``; float32, on the step's device."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step.to(torch.float32) / float(max(cfg.warmup_steps, 1)), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(
        sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree_mod.leaves(tree))
    )


def clip_by_global_norm(grads, max_norm):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_mod.tree_map(lambda g: g * scale, grads), gn


def init(params, cfg: OptimizerConfig) -> dict:
    first = tree_mod.leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if cfg.name == "adamw":
        def zeros(p):
            return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

        return {"m": tree_mod.tree_map(zeros, params),
                "v": tree_mod.tree_map(zeros, params), "step": step}
    if cfg.name == "adafactor":
        def factored(p):
            if p.ndim >= 2:
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=cfg.state_dtype, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=cfg.state_dtype,
                                      device=p.device),
                }
            return {"v": torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)}

        return {"f": tree_mod.tree_map(factored, params), "step": step}
    if cfg.name == "sgd":
        return {"step": step}
    raise ValueError(cfg.name)


def follow(g, p):
    """Grad ``g`` placed as its parameter ``p`` (a DTensor grad may come
    out ``Partial``: this is its reduction), else ``g`` itself."""
    if su.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


@torch.no_grad()
def update(grads, state: dict, params, cfg: OptimizerConfig):
    """One step in place: returns (params, state, metrics), the same trees
    as given, holding the new values.

    Each grad is taken to float32 and clipped as its leaf is updated
    (``clip_by_global_norm``'s product, leaf by leaf; AdamW also a run of
    rows at a time, ``UPDATE_CHUNK``), so the update never holds a float32
    copy of the whole grads tree (bfloat16 grads: twice their size).

    Sharded parameters (``DTensor``s, the moments placed as their
    parameters by ``launch.shardings.lm_state_sharding``) are updated on
    each rank's shards: the grads are first placed as their parameters
    (:func:`follow`), the global norm is taken over the DTensors, and the
    update runs on ``to_local()`` of parameter, grad and moments, where
    slicing leading rows is the rank's own (a ``Shard(0)`` DTensor's rows
    would split unevenly).
    """
    if cfg.name not in ("adamw", "adafactor", "sgd"):
        raise ValueError(cfg.name)
    if not any(su.is_dtensor(p) for p in tree_mod.leaves(params)):
        return params, state, _update(grads, state, params, cfg, global_norm(grads))
    if cfg.name == "adafactor":
        raise ValueError("adafactor: its factored moments are replicated by the sharding "
                         "rules; a sharded update needs AdamW or SGD")
    grads = tree_mod.tree_map(follow, grads, params)
    gn = global_norm(grads).full_tensor()

    def local(t):
        return t.to_local() if su.is_dtensor(t) else t

    metrics = _update(tree_mod.tree_map(local, grads), tree_mod.tree_map(local, state),
                      tree_mod.tree_map(local, params), cfg, gn)
    return params, state, metrics


def _update(grads, state: dict, params, cfg: OptimizerConfig, gn) -> dict:
    """``update`` on plain tensors, given the grads' global norm ``gn``."""
    state["step"].add_(1)
    step = state["step"]
    lr = schedule(step, cfg)
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)

        def f32(g):
            return g.to(torch.float32) * scale
    else:
        def f32(g):
            return g.to(torch.float32)

    if cfg.name == "adamw":
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)

        def upd(p, g, m, v):
            g = f32(g)
            m.copy_(b1 * m.to(torch.float32) + (1 - b1) * g)
            v.copy_(b2 * v.to(torch.float32) + (1 - b2) * g * g)
            mh = m.to(torch.float32) / bc1
            vh = v.to(torch.float32) / bc2
            d = mh / (torch.sqrt(vh) + cfg.eps)
            if p.ndim >= 2:  # decoupled weight decay on matrices only
                d = d + cfg.weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr * d)

        tree_mod.tree_map(lambda *leaf: [upd(*c) for c in _row_chunks(*leaf)],
                          params, grads, state["m"], state["v"])
    elif cfg.name == "adafactor":
        eps = 1e-30

        def upd(p, g, f):
            g = f32(g)
            g32 = g * g + eps
            if p.ndim >= 2:
                vr = 0.95 * f["vr"].to(torch.float32) + 0.05 * g32.mean(-1)
                vc = 0.95 * f["vc"].to(torch.float32) + 0.05 * g32.mean(-2)
                denom = (
                    vr[..., :, None]
                    * vc[..., None, :]
                    / torch.clamp(vr.mean(-1)[..., None, None], min=eps)
                )
                d = g / torch.sqrt(denom + eps)
                f["vr"].copy_(vr)
                f["vc"].copy_(vc)
            else:
                v = 0.95 * f["v"].to(torch.float32) + 0.05 * g32
                d = g / torch.sqrt(v + eps)
                f["v"].copy_(v)
            p.copy_(p.to(torch.float32) - lr * d)

        tree_mod.tree_map(upd, params, grads, state["f"])
    else:
        tree_mod.tree_map(lambda p, g: p.copy_(p.to(torch.float32) - lr * f32(g)), params, grads)
    return {"lr": lr, "grad_norm": gn}
