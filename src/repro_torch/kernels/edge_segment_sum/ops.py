"""Segment sum of row-sorted edge values: pad to tiles, reduce each tile,
fold the tiles' live ranks into rows.

The counterpart of ``repro.kernels.edge_segment_sum.ops``.  The edges are
padded to whole tiles as ``repro`` pads them; the columns are not: the
kernel takes any width, so ``repro``'s ``d_tile`` (a Pallas VMEM tile) and
its power-of-two column padding have no counterpart.  The tile reduction is
the ``edge_segment_partials`` CUDA kernel (``backend="cuda"``) or its plain
PyTorch version (``backend="torch"``); ``auto`` picks by the tensors' device.
"""
from __future__ import annotations

import torch

from ...core import util
from . import kernel as _kernel
from . import ref as _ref

EB = _kernel.EB  # edges per tile


def _pad(rows: torch.Tensor, vals: torch.Tensor, num_segments: int):
    """Tile the edges: rows [T, EB] int32 (pad and dropped rows -> sink),
    vals [T, EB, D] f32 (pad edges 0)."""
    e, d = vals.shape
    t = -(-e // EB)
    sink = num_segments
    rows_p = torch.full((t * EB,), sink, dtype=torch.int32, device=vals.device)
    rows_p[:e] = torch.clamp(rows, max=sink)
    vals_p = torch.zeros((t * EB, d), dtype=torch.float32, device=vals.device)
    vals_p[:e] = vals
    return rows_p.reshape(t, EB), vals_p.reshape(t, EB, d)


def _fold_live(part: torch.Tensor, rank_rows: torch.Tensor,
               num_segments: int) -> torch.Tensor:
    """Seam fold: add the tiles' per-rank partials into their rows.

    Only live ranks (``rank_rows < sink``) are folded.  ``repro`` folds
    every rank with ``segment_sum(min(rank, sink), num_segments + 1)``;
    most ranks are unused, and an ``index_add_`` of those would pile its
    atomics onto the one sink row.
    """
    rank = rank_rows.reshape(-1)
    sel = torch.nonzero(rank < num_segments).squeeze(1)
    out = torch.zeros((num_segments, part.shape[-1]), dtype=torch.float32,
                      device=part.device)
    return out.index_add_(0, rank.index_select(0, sel),
                          part.reshape(-1, part.shape[-1]).index_select(0, sel))


def edge_segment_sum(rows: torch.Tensor, vals: torch.Tensor, *, num_segments: int,
                     backend: str = "auto") -> torch.Tensor:
    """Segment sum of row-sorted edges: rows [E] ascending, vals [E, D] ->
    [num_segments, D] f32.  Rows >= num_segments are dropped."""
    backend = util.resolve_backend(backend, vals.device)
    partials = (_kernel.edge_segment_partials if backend == "cuda"
                else _kernel.edge_segment_partials_torch)
    e, d = vals.shape
    if e == 0:
        return torch.zeros((num_segments, d), dtype=torch.float32, device=vals.device)
    part, rank = partials(*_pad(rows, vals, num_segments), num_segments)
    return _fold_live(part, rank, num_segments)


def edge_segment_sum_reference(rows, vals, *, num_segments: int) -> torch.Tensor:
    return _ref.segment_sum_reference(rows, vals, num_segments)
