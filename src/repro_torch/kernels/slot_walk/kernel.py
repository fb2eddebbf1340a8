"""tile_cumsum: the intra-tile prefix level of the interval walk step.

``tile_cumsum`` launches the hand-written CUDA kernel
(``csrc/tile_cumsum.cu``) for CUDA tensors and uses its plain PyTorch
version, ``tile_cumsum_torch``, only for CPU tensors.  It replaces the
TPU kernel ``repro/kernels/slot_walk/kernel.py::tile_cumsum`` (one
triangular MXU matmul per tile).  ``tile_cumsum.launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from .. import _build

#: slots per tile
EB = 128


def tile_cumsum_torch(vals: torch.Tensor) -> torch.Tensor:
    """Plain version: inclusive cumsum along each [EB] tile."""
    return torch.cumsum(vals, dim=-1)


def tile_cumsum(vals: torch.Tensor) -> torch.Tensor:
    """Per-tile inclusive prefix sum: vals [N, EB] f32 -> [N, EB] f32."""
    if vals.device.type == "cpu":
        return tile_cumsum_torch(vals)
    _build.require(vals, "vals", torch.float32, 2)
    if vals.shape[1] != EB:
        raise ValueError(f"vals: tiles must be {EB} wide, got {vals.shape[1]}")
    if vals.data_ptr() % 16:  # the kernel loads float4 vectors
        raise ValueError("vals: data pointer not 16-byte aligned")
    out = torch.empty_like(vals)
    if vals.shape[0] == 0:
        return out
    lib = _build.library()
    _build.check(
        lib.repro_tile_cumsum(
            vals.data_ptr(), out.data_ptr(), vals.shape[0], _build.stream(vals)
        ),
        "tile_cumsum",
    )
    tile_cumsum.launches += 1
    return out


tile_cumsum.launches = 0
