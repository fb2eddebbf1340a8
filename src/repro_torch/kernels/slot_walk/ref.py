"""Walk oracles: full-buffer masked gather + segment sum.

``slot_walk_reference`` is the plain PyTorch full-buffer walk: every slot
of the buffer is re-masked each step, so dead SENTINEL lanes and stale
``slot_rows`` contribute nothing.  ``slot_walk_host`` is the numpy walk
over any operand form the dispatcher routes.  Tests compare the tiled
engine against these and against the dense numpy oracle in
``core.traversal``.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import util

SENTINEL = int(util.SENTINEL)


def slot_walk_reference(dst: torch.Tensor, slot_rows: torch.Tensor,
                        steps: int, num_vertices: int,
                        normalize: bool = False) -> torch.Tensor:
    valid = (dst != SENTINEL) & (slot_rows < num_vertices)
    safe_dst = torch.where(valid, dst.clamp(0, num_vertices - 1), 0).to(torch.int64)
    rows = torch.where(valid, slot_rows, num_vertices).to(torch.int64)
    visits = torch.ones(num_vertices, dtype=torch.float32, device=dst.device)
    for _ in range(steps):
        vals = torch.where(valid, visits[safe_dst], 0.0)
        nxt = torch.zeros(num_vertices + 1, dtype=torch.float32, device=dst.device)
        visits = nxt.index_add_(0, rows, vals)[:num_vertices]
        if normalize:
            visits = visits / torch.clamp(visits.max(), min=1.0)
    return visits


def slot_walk_host(dst, slot_rows, steps: int, num_vertices: int, *,
                   edges_hi=None, block_lo=None, block_hi=None,
                   normalize: bool = False, visits0=None) -> np.ndarray:
    """Pure-numpy walk over rows-carrying buffers or [lo, hi) intervals.

    Per-step f32 rounding of the bincount accumulation differs from the
    device formulations (host sums are sequential), so results are
    reference-accurate, not bit-identical.
    """
    d_full = util.host(dst)
    e = d_full.shape[0] if edges_hi is None else min(int(edges_hi), d_full.shape[0])
    d = d_full[:e].astype(np.int64)
    nv = int(num_vertices)
    if block_lo is not None and block_hi is not None:
        # fold the interval geometry into a per-slot owner plane
        lo = np.clip(util.host(block_lo).astype(np.int64), 0, e)
        hi = np.clip(util.host(block_hi).astype(np.int64), 0, e)
        deg = np.maximum(hi - lo, 0)
        rows = np.full(e, nv, np.int64)
        total = int(deg.sum())
        if total:
            first = np.cumsum(deg) - deg
            idx = np.repeat(lo, deg) + (np.arange(total) - np.repeat(first, deg))
            rows[idx] = np.repeat(np.arange(deg.shape[0], dtype=np.int64), deg)
    else:
        rows = util.host(slot_rows)[:e].astype(np.int64)
    valid = (d != SENTINEL) & (rows >= 0) & (rows < nv)
    gidx = np.where(valid, np.clip(d, 0, nv - 1), 0)
    seg = np.where(valid, rows, nv)
    if visits0 is None:
        vis = np.ones((1, nv), np.float32)
    else:
        vis = util.host(visits0).astype(np.float32).reshape(-1, nv)
    for _ in range(int(steps)):
        vals = np.where(valid[None, :], vis[:, gidx], np.float32(0.0))
        nxt = np.empty_like(vis)
        for b in range(vis.shape[0]):
            nxt[b] = np.bincount(
                seg, weights=vals[b], minlength=nv + 1
            )[:nv].astype(np.float32)
        if normalize:
            nxt = nxt / np.maximum(nxt.max(axis=1, keepdims=True), 1.0)
        vis = nxt.astype(np.float32)
    return vis if visits0 is not None else vis[0]
