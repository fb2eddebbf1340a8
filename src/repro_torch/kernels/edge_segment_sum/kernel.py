"""The edge segment sum's kernels.

``edge_segment_runs`` sums row-sorted edge values into their rows in place
(``csrc/edge_segment_sum.cu``): one warp per 128-edge tile of the flat
arrays stores each run that owns its row alone straight into the output,
and a second launch folds the runs that cross tile seams, in edge order.
It replaces the TPU kernel
``repro/kernels/edge_segment_sum/kernel.py::edge_segment_partials`` (one
one-hot rank MXU matmul per padded tile and d-tile) with the padding and
the rank fold around it.

Its plain version is the TPU formulation, ``edge_segment_sum_torch``: pad
the edges to whole tiles (``pad``), reduce each tile to per-rank partials
(``edge_segment_partials_torch``), fold the live ranks (``fold_live``).  It
sums in float32, or in float64 for float64 values (so a gradient check can
run through it).
The wrapper launches the CUDA kernels for CUDA tensors and uses the plain
version only for CPU tensors; its ``launches`` attribute counts its
launches (one a call: both kernels).

``edge_segment_runs_op`` is the wrapper as a ``torch.library`` custom op
(``repro_torch::edge_segment_runs``), the form the model sites call: its
body is the wrapper (the ``ctypes`` launch), its fake body gives the
output's shape to fake tensors (the dry run), and its flop formula is the
kernel's operation count, E·D adds (``chip_smoke.py``'s bound).
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build
from ..slot_walk.kernel import EB, tile_ranks  # 128 edges a tile


def edge_segment_partials_torch(rows: torch.Tensor, vals: torch.Tensor, sink: int):
    """Per-tile run sums: run flags, cumsum to ranks, ``scatter_add`` per tile.

    ``rows`` [T, EB] int32 edge rows, ascending (pad edges carry ``sink``);
    ``vals`` [T, EB, Dp] f32.  A run is a maximal stretch of equal rows
    inside a tile; its rank is its index among the tile's runs.  Returns
    (partials [T, EB, Dp] f32, rank_rows [T, EB] int32): each run's sum at
    its rank (0 for unused ranks) and its row (``sink`` for unused ranks and
    rows outside [0, sink)).
    """
    rank, rank_rows = tile_ranks(rows, sink)
    partials = torch.zeros_like(vals, dtype=_acc(vals))
    partials.scatter_add_(1, rank[:, :, None].expand(vals.shape), vals)
    return partials, rank_rows


def _acc(vals: torch.Tensor) -> torch.dtype:
    """The plain version's sum type: float64 for float64 values, else float32."""
    return torch.float64 if vals.dtype == torch.float64 else torch.float32


def pad(rows: torch.Tensor, vals: torch.Tensor, num_segments: int):
    """Tile the edges: rows [T, EB] int32 (pad and dropped rows -> sink),
    vals [T, EB, D] f32 (pad edges 0)."""
    e, d = vals.shape
    t = -(-e // EB)
    sink = num_segments
    rows_p = torch.full((t * EB,), sink, dtype=torch.int32, device=vals.device)
    rows_p[:e] = torch.clamp(rows, max=sink)
    vals_p = torch.zeros((t * EB, d), dtype=_acc(vals), device=vals.device)
    vals_p[:e] = vals
    return rows_p.reshape(t, EB), vals_p.reshape(t, EB, d)


def fold_live(part: torch.Tensor, rank_rows: torch.Tensor,
              num_segments: int) -> torch.Tensor:
    """Seam fold: add the tiles' per-rank partials into their rows.

    Only live ranks (``rank_rows < sink``) are folded.  ``repro`` folds
    every rank with ``segment_sum(min(rank, sink), num_segments + 1)``;
    most ranks are unused, and an ``index_add_`` of those would pile its
    atomics onto the one sink row.
    """
    rank = rank_rows.reshape(-1)
    sel = torch.nonzero(rank < num_segments).squeeze(1)
    out = torch.zeros((num_segments, part.shape[-1]), dtype=part.dtype,
                      device=part.device)
    return out.index_add_(0, rank.index_select(0, sel),
                          part.reshape(-1, part.shape[-1]).index_select(0, sel))


def edge_segment_sum_torch(rows: torch.Tensor, vals: torch.Tensor,
                           num_segments: int) -> torch.Tensor:
    """Plain version: ``pad``, the tile partials, ``fold_live``."""
    e, d = vals.shape
    if e == 0:
        return torch.zeros((num_segments, d), dtype=_acc(vals), device=vals.device)
    part, rank = edge_segment_partials_torch(*pad(rows, vals, num_segments), num_segments)
    return fold_live(part, rank, num_segments)


def rows_int32(rows: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Edge rows as the kernel reads them: int32, contiguous.

    Wider rows are clamped to [-1, num_segments] first, so a row outside
    int32 stays dropped; the clamp keeps the rows ascending.
    """
    if rows.dtype != torch.int32:
        rows = torch.clamp(rows, -1, num_segments).to(torch.int32)
    return rows.contiguous()


def edge_segment_runs(rows: torch.Tensor, vals: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Segment sum of row-sorted edges: rows [E] ascending, vals [E, D] ->
    [num_segments, D] f32.  Rows outside [0, num_segments) are dropped.

    The same inputs give the same output bit for bit on every call: each
    row's sum is taken over its edges in order, no atomics.
    """
    num_segments = int(num_segments)
    if vals.device.type == "cpu":
        return edge_segment_sum_torch(rows, vals, num_segments)
    if not 0 <= num_segments < 2**31 - 1:
        raise ValueError(f"num_segments must fit int32, got {num_segments}")
    rows = rows_int32(rows, num_segments)
    vals = vals.contiguous()
    _build.require(rows, "rows", torch.int32, 1)
    _build.require(vals, "vals", torch.float32, 2)
    e, d = vals.shape
    if rows.shape[0] != e:
        raise ValueError(f"rows [{e}] expected for vals {tuple(vals.shape)}, "
                         f"got {tuple(rows.shape)}")
    if d == 0:
        raise ValueError("vals: no columns")
    out = torch.zeros((num_segments, d), dtype=torch.float32, device=vals.device)
    if e == 0:
        return out
    seams = torch.empty((-(-e // EB), 2, d), dtype=torch.float32, device=vals.device)
    vec4 = d % 4 == 0 and vals.data_ptr() % 16 == 0
    lib = _build.library()
    _build.check(
        lib.repro_edge_segment_sum(
            rows.data_ptr(), vals.data_ptr(), e, d, num_segments, int(vec4),
            out.data_ptr(), seams.data_ptr(), _build.stream(vals),
        ),
        "edge_segment_runs",
    )
    edge_segment_runs.launches += 1
    return out


edge_segment_runs.launches = 0


@torch.library.custom_op("repro_torch::edge_segment_runs", mutates_args=())
def edge_segment_runs_op(rows: torch.Tensor, vals: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """``edge_segment_runs`` as a custom op."""
    return edge_segment_runs(rows, vals, num_segments)


@edge_segment_runs_op.register_fake
def _(rows, vals, num_segments):
    return vals.new_empty((num_segments, vals.shape[1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.edge_segment_runs)
def _(rows_shape, vals_shape, num_segments, out_shape=None, **kwargs) -> int:
    return vals_shape[0] * vals_shape[1]
