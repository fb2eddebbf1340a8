"""Sharded walk-image traversal (DESIGN.md §14).

The port of ``repro.kernels.slot_walk.sharded``.  The walk image shards by
tile range: each shard owns a contiguous vertex block's packed tiles and
runs the SAME scatter-free blocked step
(``ops.make_blocked_step``) the single-device engine uses — intra-tile
cumsum (the ``tile_cumsum`` kernel on the card), TwoSum-compensated
inter-tile scan, ``P[hi] - P[lo]`` interval reads.  Shard cuts align to
block boundaries by construction (a vertex's block lives wholly inside its
owner's slot space), so the inter-tile base scan cancels within each shard.
The only exchange per walk step is the frontier: every shard emits its own
``[B, rows_max]`` visits slice, and the slices join along dim 1 into the
next ``[B, v_pad]`` frontier.  Two walk programs share the step:

* ``make_sharded_walk`` — one rank a shard (``launch.mesh.Mesh``): each
  rank steps its own shard and a ``torch.distributed`` ``all_gather`` of
  the owned slices, concatenated in rank order, is the next frontier,
  replicated on every rank.  Each rank receives ``(S-1)·rows_max·B·4``
  bytes a step (:func:`model_bytes_per_step`); :data:`EXCHANGE` counts
  what the exchange really received, and its host time.
* ``make_local_walk`` — every shard's step looped on one device, joined by
  ``torch.cat``: the same step and the same per-shard prefix bound, so the
  two programs agree bit for bit.

Two choices differ from ``repro``'s jitted programs, neither in the math:

* each shard's step reads its OWN ``dst`` buffer (``repro`` stacks every
  shard's ``dst`` into one ``[S, cap_e]`` array, a copy of the payload
  after every apply) and its own ``[lo, hi)`` over the rows it owns, so a
  step's interval reads cover ``rows_max`` rows, not the padded vertex
  space;
* each shard walks its own quantized bump prefix (``e_his``) instead of
  the mesh-wide maximum that keeps ``repro``'s jit shapes shared.  The
  slots past a shard's bump are SENTINEL and gather 0.0, and a prefix
  position depends only on the tiles before it, so the result is the same
  bit for bit.

A quarantined shard (``None`` operands) runs no step at all: its rows read
exact zeros, as ``repro``'s ``lo == hi == 0`` mask gives them.  On a mesh
its rank still enters every exchange, sending zeros.

``repro`` proves its byte count from the lowered jaxpr; here the program's
own exchange is the evidence.
"""
from __future__ import annotations

import functools
import time

import torch
import torch.distributed as dist

from . import ops as _ops

#: What the mesh walk's frontier exchanges did in this process: steps,
#: bytes this rank received (every part but its own) and the host seconds
#: spent inside ``all_gather``.
EXCHANGE = {"steps": 0, "bytes": 0, "host_s": 0.0}


def _shard_step(dst_l, lo_l, hi_l, v_pad: int, e_hi: int, backend: str = "auto"):
    """This shard's blocked step: [B, v_pad] frontier -> [B, len(lo_l)]
    visits of the rows it owns (``lo_l``/``hi_l`` are their intervals in
    the shard's own slot space)."""
    gidx_p = _ops._prep_gidx(dst_l, v_pad, e_hi)
    return _ops.make_blocked_step(gidx_p, lo_l, hi_l, v_pad, backend=backend)


@functools.lru_cache(maxsize=256)
def make_local_walk(steps: int, n_shards: int, rows_max: int, cap_e: int, e_his: tuple,
                    nwalks: int, backend: str = "auto"):
    """Single-device emulation of the sharded walk, same math shard by shard.

    Returns ``walk(dsts, los, his, vis)``: per shard its ``dst`` buffer and
    the ``[rows_max]`` intervals of its owned rows (all three ``None`` for
    a quarantined shard), ``vis`` the [B, v_pad] frontier; -> [B, v_pad]
    after ``steps`` steps.  Each step runs every healthy shard's step on
    the full frontier and joins the owned slices.
    """
    v_pad = n_shards * rows_max
    if len(e_his) != n_shards:
        raise ValueError(f"make_local_walk: {len(e_his)} prefix bounds for {n_shards} shards")

    def walk(dsts, los, his, vis):
        fns = [
            None if d is None else _shard_step(d, lo, hi, v_pad, e_his[s], backend)
            for s, (d, lo, hi) in enumerate(zip(dsts, los, his))
        ]
        b = vis.shape[0]
        zero = torch.zeros((b, rows_max), dtype=torch.float32, device=vis.device)
        for _ in range(steps):
            vis = torch.cat([zero if f is None else f(vis) for f in fns], dim=1)
        return vis

    return walk


def make_sharded_walk(mesh, steps: int, n_shards: int, rows_max: int, cap_e: int, e_hi: int,
                      nwalks: int, backend: str = "auto"):
    """This rank's program of the mesh walk: ``walk(dst, lo, hi, vis)``.

    ``dst`` is this rank's shard buffer and ``lo``/``hi`` the ``[rows_max]``
    intervals of its owned rows (all three ``None`` when the shard is
    quarantined: the rank then sends zeros); ``e_hi`` its own quantized bump
    bound; ``vis`` the ``[B, v_pad]`` frontier, the same on every rank.
    Each step runs this shard's blocked step and all_gathers the owned
    slices over ``mesh.group``; -> the ``[B, v_pad]`` frontier after
    ``steps`` steps, replicated.  Every rank of the mesh must call it with
    the same ``steps`` and ``vis`` shape.
    """
    v_pad = n_shards * rows_max
    if mesh.size != n_shards:
        raise ValueError(f"make_sharded_walk: mesh of {mesh.size} ranks for {n_shards} shards")
    del cap_e, nwalks  # shapes follow from the operands

    def walk(dst, lo, hi, vis):
        step = None if dst is None else _shard_step(dst, lo, hi, v_pad, e_hi, backend)
        b = vis.shape[0]
        parts = [torch.empty((b, rows_max), dtype=torch.float32, device=vis.device)
                 for _ in range(n_shards)]
        zero = torch.zeros((b, rows_max), dtype=torch.float32, device=vis.device)
        for _ in range(steps):
            own = zero if step is None else step(vis).contiguous()
            t0 = time.perf_counter()
            dist.all_gather(parts, own, group=mesh.group)
            EXCHANGE["host_s"] += time.perf_counter() - t0
            EXCHANGE["steps"] += 1
            EXCHANGE["bytes"] += (n_shards - 1) * own.numel() * own.element_size()
            vis = torch.cat(parts, dim=1)
        return vis

    return walk


def model_bytes_per_step(n_shards: int, rows_max: int, nwalks: int) -> int:
    """The |V|·4 frontier model: bytes each rank receives per step."""
    return (n_shards - 1) * rows_max * max(nwalks, 1) * 4
