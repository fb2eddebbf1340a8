"""bsr_spmm: Y = A @ X with A in 128x128 block-sparse rows.

``bsr_spmm`` launches the hand-written CUDA kernel (``csrc/bsr_spmm.cu``)
for CUDA tensors and uses its plain PyTorch version, ``bsr_spmm_torch``,
only for CPU tensors.  It replaces the TPU kernel
``repro/kernels/bsr_spmm/kernel.py::bsr_spmm`` (a grid over row-blocks,
d-tiles and ``max_blocks_per_row`` block slots, one MXU matmul per stored
block).  The CUDA kernel loops over each row-block's real block count, so
it takes no ``max_blocks_per_row``.  ``bsr_spmm.launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from .. import _build

#: block size the CUDA kernel is written for
BLOCK = 128
#: d-tiles the CUDA kernel is instantiated for
D_TILES = (8, 16, 32, 64, 128)


def bsr_spmm_torch(row_ptr: torch.Tensor, block_cols: torch.Tensor,
                   blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version: gather X per block, ``torch.bmm``, ``index_add_``
    into the row-blocks."""
    n_row_blocks = row_ptr.shape[0] - 1
    nnzb = block_cols.shape[0]
    b = blocks.shape[-1]
    d = x.shape[1]
    xb = x.reshape(-1, b, d).index_select(0, block_cols.to(torch.int64))
    prod = torch.bmm(blocks[:nnzb], xb)  # [nnzb, b, d]
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    owner = torch.repeat_interleave(
        torch.arange(n_row_blocks, device=x.device), counts, output_size=nnzb)
    y = torch.zeros((n_row_blocks, b, d), dtype=torch.float32, device=x.device)
    return y.index_add_(0, owner, prod).reshape(n_row_blocks * b, d)


def bsr_spmm(row_ptr: torch.Tensor, block_cols: torch.Tensor,
             blocks: torch.Tensor, x: torch.Tensor, *, d_tile: int = 128) -> torch.Tensor:
    """Y = A @ X: row_ptr [R+1] int32, block_cols [nnzb] int32, blocks
    [>= nnzb, B, B] f32, x [C*B, D] f32 with D % d_tile == 0 -> [R*B, D]."""
    if x.device.type == "cpu":
        return bsr_spmm_torch(row_ptr, block_cols, blocks, x)
    _build.require(row_ptr, "row_ptr", torch.int32, 1)
    _build.require(block_cols, "block_cols", torch.int32, 1)
    _build.require(blocks, "blocks", torch.float32, 3)
    _build.require(x, "x", torch.float32, 2)
    if blocks.shape[1:] != (BLOCK, BLOCK):
        raise ValueError(f"blocks: expected [nnzb, {BLOCK}, {BLOCK}], got {tuple(blocks.shape)}")
    if blocks.shape[0] < block_cols.shape[0]:
        raise ValueError("blocks: fewer tiles than block_cols entries")
    if d_tile not in D_TILES:
        raise ValueError(f"d_tile must be one of {D_TILES}, got {d_tile}")
    d = x.shape[1]
    if d % d_tile or x.shape[0] % BLOCK:
        raise ValueError(
            f"x: expected [C*{BLOCK}, D] with D % {d_tile} == 0, got {tuple(x.shape)}")
    if blocks.data_ptr() % 16 or x.data_ptr() % 16:  # 16-byte vector loads
        raise ValueError("blocks and x: data pointers not 16-byte aligned")
    n_row_blocks = row_ptr.shape[0] - 1
    y = torch.empty((n_row_blocks * BLOCK, d), dtype=torch.float32, device=x.device)
    if n_row_blocks == 0 or d == 0:
        return y
    lib = _build.library()
    _build.check(
        lib.repro_bsr_spmm(
            row_ptr.data_ptr(), block_cols.data_ptr(), blocks.data_ptr(),
            x.data_ptr(), y.data_ptr(), n_row_blocks, d, d_tile, _build.stream(x),
        ),
        "bsr_spmm",
    )
    bsr_spmm.launches += 1
    return y


bsr_spmm.launches = 0
