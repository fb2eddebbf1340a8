"""k-step reverse walk (paper Alg 13): visits = Aᵀᵏ · 1̄ computed directly on
the out-edge representation (visits1[u] = Σ_{(u,v)∈E} visits0[v]).

``reverse_walk_flat`` is the seed baseline (gather + segment sum over the
FULL slot-buffer capacity, re-masking every dead SENTINEL lane per step);
``reverse_walk_slotted`` walks the arena's live prefix through the
``kernels/slot_walk`` tile engine (the ``slot_walk_partials`` rank-tile
step without intervals); ``reverse_walk_image`` walks a canonical
``core.walk_image.WalkImage`` through the same engine.  float32 counts: 42 steps on
large graphs overflow; the paper benchmarks wall-time, not values.
"""
from __future__ import annotations

import numpy as np
import torch

from . import util

SENTINEL = int(util.SENTINEL)


def reverse_walk_flat(dst: torch.Tensor, slot_rows: torch.Tensor, steps: int,
                      num_vertices: int, normalize: bool = False) -> torch.Tensor:
    """Reverse walk over a flat slotted edge buffer (DiGraph payload).

    Empty slots carry ``dst == SENTINEL`` and are masked; ``slot_rows``
    maps each slot to its owning vertex.
    """
    valid = dst != SENTINEL
    safe_dst = torch.where(valid, dst, 0).to(torch.int64)
    safe_row = torch.where(
        valid & (slot_rows < num_vertices), slot_rows, num_vertices
    ).to(torch.int64)
    visits = torch.ones(num_vertices, dtype=torch.float32, device=dst.device)
    for _ in range(steps):
        vals = torch.where(valid, visits[safe_dst], 0.0)
        nxt = torch.zeros(num_vertices + 1, dtype=torch.float32, device=dst.device)
        visits = nxt.index_add_(0, safe_row, vals)[:num_vertices]
        if normalize:
            visits = visits / torch.clamp(visits.max(), min=1.0)
    return visits


def reverse_walk_slotted(dst: torch.Tensor, slot_rows: torch.Tensor, steps: int,
                         num_vertices: int, *, edges_hi: int | None = None,
                         backend: str = "auto", block_lo=None, block_hi=None,
                         normalize: bool = False, visits0=None) -> torch.Tensor:
    """Reverse walk via the slot_walk tile engine (DESIGN.md §6).

    Same semantics as ``reverse_walk_flat`` but only the ``edges_hi``-slot
    arena prefix is processed, in 128-slot tiles.  Without block intervals
    each step is the ``slot_walk_partials`` rank-tile reduction (the CUDA
    kernel for ``backend="cuda"``, its plain version for ``"torch"``,
    ``"auto"`` by device); with them, the scatter-free prefix-sum step.
    ``visits0`` [B, num_vertices] walks B vectors together -> [B, V].
    """
    from ..kernels.slot_walk import ops as _slot_ops  # lazy: avoid import cycle

    return _slot_ops.slot_walk(
        dst, slot_rows, steps, num_vertices, edges_hi=edges_hi,
        backend=backend, block_lo=block_lo, block_hi=block_hi,
        normalize=normalize, visits0=visits0,
    )


def reverse_walk_image(image, steps: int, *, backend: str = "auto",
                       normalize: bool = False, visits0=None) -> torch.Tensor:
    """Reverse walk over a canonical walk image (DESIGN.md §11)."""
    from ..kernels.slot_walk import ops as _slot_ops  # lazy: avoid import cycle

    return _slot_ops.slot_walk_image(
        image, steps, backend=backend, normalize=normalize, visits0=visits0,
    )


def reverse_walk_dense_oracle(adj, steps: int) -> np.ndarray:
    """Numpy oracle: Aᵏ · 1̄ over the 0/1 out-adjacency (tests only)."""
    a = (np.asarray(adj) != 0).astype(np.float64)
    v = np.ones(a.shape[0])
    for _ in range(steps):
        v = a @ v
    return v
