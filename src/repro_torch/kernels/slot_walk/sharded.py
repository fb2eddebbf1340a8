"""Sharded walk-image traversal, local mode (DESIGN.md §14).

The port of ``repro.kernels.slot_walk.sharded``'s single-device half.  The
walk image shards by tile range: each shard owns a contiguous vertex
block's packed tiles and runs the SAME scatter-free blocked step
(``ops.make_blocked_step``) the single-device engine uses — intra-tile
cumsum (the ``tile_cumsum`` kernel on the card), TwoSum-compensated
inter-tile scan, ``P[hi] - P[lo]`` interval reads.  Shard cuts align to
block boundaries by construction (a vertex's block lives wholly inside its
owner's slot space), so the inter-tile base scan cancels within each shard.
The only exchange per walk step is the frontier: every shard emits its own
``[B, rows_max]`` visits slice, and joining the slices along dim 1 stands
in for ``repro``'s ``all_gather``.

``make_local_walk`` loops the per-shard step closures on one device.  Two
choices differ from ``repro``'s jitted program, neither in the math:

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
exact zeros, as ``repro``'s ``lo == hi == 0`` mask gives them.

The multi-device walk (``make_sharded_walk`` over ``torch.distributed``)
and the collective-bytes model are not ported yet (``ROADMAP.md`` §1
item 3).
"""
from __future__ import annotations

import functools

import torch

from . import ops as _ops


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
