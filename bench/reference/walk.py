"""Plain reference of the reverse walk, and the numbers ``correct`` reads.

The walk is the paper's count walk on the out-edges, weights unused:
``next[u] = Σ_{(u,v)∈E} cur[v]``; with ``normalize`` each step divides a
walk by ``max(max(next), 1)``.  It runs one walk at a time with
``index_add_`` in the dtype given: float64 for the reference, bfloat16 for
the control that stands in for a lower-precision program.  This file
imports nothing of the program.
"""
from __future__ import annotations

import torch


def walk(rows: torch.Tensor, cols: torch.Tensor, n: int, visits0: torch.Tensor,
         steps: int, *, normalize: bool, dtype=torch.float64) -> torch.Tensor:
    """visits0 [B, n] (any dtype) -> [B, n] in ``dtype``, one row at a time."""
    out = []
    for v0 in visits0:
        v = v0.to(rows.device, dtype)
        for _ in range(steps):
            v = torch.zeros(n, dtype=dtype, device=rows.device).index_add_(0, rows, v[cols])
            if normalize:
                v = v / torch.clamp(v.max(), min=1.0)
        out.append(v)
    return torch.stack(out)


def walk_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest gap of a walk from the reference, as a share of the
    reference's largest visit count, worst row of a [B, n] batch."""
    ref = ref.to(torch.float64)
    gap = (got.to(ref.device, torch.float64) - ref).abs().amax(dim=-1)
    scale = ref.abs().amax(dim=-1).clamp(min=1e-300)
    worst = (gap / scale).max()
    return float("inf") if torch.isnan(worst) else float(worst)


def walk_l1(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Summed gap of a walk from the reference, as a share of the
    reference's summed visits, worst row of a [B, n] batch: unlike
    ``walk_gap`` it weighs every vertex, the many with small counts too."""
    ref = ref.to(torch.float64)
    gap = (got.to(ref.device, torch.float64) - ref).abs().sum(dim=-1)
    scale = ref.abs().sum(dim=-1).clamp(min=1e-300)
    worst = (gap / scale).max()
    return float("inf") if torch.isnan(worst) else float(worst)


def walk_readings(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The walk numbers ``correct`` compares for one judged walk."""
    return {"walk_gap": walk_gap(got, want), "walk_l1": walk_l1(got, want)}


def edges_wrong(rows, cols, wgt, ref) -> int:
    """Edges in which the program's graph and the reference's differ: keys
    on one side only, plus shared keys whose weights differ in any bit."""
    keys = rows.to(ref.device, torch.int64) * ref.n + cols.to(ref.device, torch.int64)
    w = wgt.to(ref.device, torch.float32)
    if keys.shape == ref.keys.shape and torch.equal(keys, ref.keys):
        return int((w.view(torch.int32) != ref.wgt.view(torch.int32)).sum())
    # a key out of order or repeated is wrong in itself
    unordered = int((keys[1:] <= keys[:-1]).sum()) if keys.shape[0] > 1 else 0
    keys, order = torch.sort(keys)
    w = w[order]
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    keys, w = keys[first], w[first]
    pos = torch.searchsorted(ref.keys, keys).clamp(max=max(ref.m - 1, 0))
    hit = ref.keys[pos] == keys if ref.m else torch.zeros_like(keys, dtype=torch.bool)
    both = int(hit.sum())
    bad_w = int((w[hit].view(torch.int32) != ref.wgt[pos[hit]].view(torch.int32)).sum())
    return unordered + (keys.shape[0] - both) + (ref.m - both) + bad_w
