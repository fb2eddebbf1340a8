"""Segment sum of row-sorted edge values.

The counterpart of ``repro.kernels.edge_segment_sum.ops``.  On the card
(``backend="cuda"``) the ``edge_segment_runs`` kernels read the edges in
place and write each row once; the plain version (``backend="torch"``) is
``repro``'s formulation: the edges padded to whole tiles as ``repro`` pads
them, per-rank tile partials, and a fold of the live ranks.  The columns
are never padded: ``repro``'s ``d_tile`` (a Pallas VMEM tile) and its
power-of-two column padding have no counterpart.  ``auto`` picks by the
tensors' device.
"""
from __future__ import annotations

import torch

from ...core import util
from . import kernel as _kernel
from . import ref as _ref

EB = _kernel.EB  # edges per tile


def edge_segment_sum(rows: torch.Tensor, vals: torch.Tensor, *, num_segments: int,
                     backend: str = "auto") -> torch.Tensor:
    """Segment sum of row-sorted edges: rows [E] ascending, vals [E, D] ->
    [num_segments, D] f32.  Rows outside [0, num_segments) are dropped."""
    if util.resolve_backend(backend, vals.device) == "cuda":
        return _kernel.edge_segment_runs_op(rows, vals, int(num_segments))
    return _kernel.edge_segment_sum_torch(rows, vals, num_segments)


def edge_segment_sum_reference(rows, vals, *, num_segments: int) -> torch.Tensor:
    return _ref.segment_sum_reference(rows, vals, num_segments)
