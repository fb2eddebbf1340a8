"""The edge segment sum's tile kernel.

``edge_segment_partials`` reduces each 128-edge tile of row-sorted edge
values to per-rank run sums, D columns wide (``csrc/edge_segment_partials.cu``).
It replaces the TPU kernel
``repro/kernels/edge_segment_sum/kernel.py::edge_segment_partials`` (one
one-hot rank MXU matmul per tile and d-tile).

The wrapper launches the CUDA kernel for CUDA tensors and uses its plain
PyTorch version (``edge_segment_partials_torch``) only for CPU tensors; its
``launches`` attribute counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import _build
from ..slot_walk.kernel import EB, tile_ranks  # 128 edges a tile


def edge_segment_partials_torch(rows: torch.Tensor, vals: torch.Tensor, sink: int):
    """Plain version: run flags, cumsum to ranks, ``scatter_add`` per tile.

    ``rows`` [T, EB] int32, ``vals`` [T, EB, Dp] f32 -> (partials [T, EB, Dp]
    f32, rank_rows [T, EB] int32).
    """
    rank, rank_rows = tile_ranks(rows, sink)
    partials = torch.zeros_like(vals, dtype=torch.float32)
    partials.scatter_add_(1, rank[:, :, None].expand(vals.shape), vals)
    return partials, rank_rows


def edge_segment_partials(rows: torch.Tensor, vals: torch.Tensor, sink: int):
    """Per-tile run sums of row-sorted edges: (rows, vals, sink) -> (partials, rank_rows).

    ``rows`` [T, EB] int32 edge rows, ascending (pad edges carry ``sink``);
    ``vals`` [T, EB, Dp] f32 edge values.  A run is a maximal stretch of
    equal rows inside a tile; its rank is its index among the tile's runs
    (slot 0 always starts one).  ``partials[t, k]`` holds the sum of run k's
    values (0 for unused ranks) and ``rank_rows[t, k]`` its row, or ``sink``
    for unused ranks and rows outside [0, sink).
    """
    sink = int(sink)
    if rows.device.type == "cpu":
        return edge_segment_partials_torch(rows, vals, sink)
    _build.require(rows, "rows", torch.int32, 2)
    _build.require(vals, "vals", torch.float32, 3)
    t = rows.shape[0]
    if rows.shape[1] != EB or tuple(vals.shape[:2]) != tuple(rows.shape):
        raise ValueError(
            f"rows [T, {EB}] and vals [T, {EB}, Dp] expected, got "
            f"{tuple(rows.shape)} and {tuple(vals.shape)}")
    if not 0 <= sink < 2**31:
        raise ValueError(f"sink must fit int32, got {sink}")
    dp = vals.shape[2]
    if dp == 0:
        raise ValueError("vals: no columns")
    v = 4 if dp % 4 == 0 else 1  # the kernel's vector width
    partials = torch.empty_like(vals)
    rank_rows = torch.empty_like(rows)
    if t == 0:
        return partials, rank_rows
    if rows.data_ptr() % 16 or vals.data_ptr() % (4 * v):  # vector loads
        raise ValueError("rows and vals: data pointers not aligned for vector loads")
    lib = _build.library()
    _build.check(
        lib.repro_edge_segment_partials(
            rows.data_ptr(), vals.data_ptr(), t, dp, sink,
            partials.data_ptr(), rank_rows.data_ptr(), _build.stream(vals),
        ),
        "edge_segment_partials",
    )
    edge_segment_partials.launches += 1
    return partials, rank_rows


edge_segment_partials.launches = 0
