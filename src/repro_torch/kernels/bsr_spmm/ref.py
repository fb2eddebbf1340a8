"""Plain oracles for block-sparse SpMM (Y = A @ X), for the tests."""
from __future__ import annotations

import numpy as np
import torch

from ...core import util


def bsr_to_dense(row_ptr, block_cols, blocks, n_rows: int, n_cols: int) -> np.ndarray:
    """Reassemble the dense matrix from BSR parts (host/numpy, tests)."""
    bl = util.host(blocks)
    b = bl.shape[-1]
    out = np.zeros((n_rows, n_cols), np.float32)
    rp = util.host(row_ptr)
    bc = util.host(block_cols)
    for r in range(rp.shape[0] - 1):
        for s in range(rp[r], rp[r + 1]):
            c = bc[s]
            out[r * b: (r + 1) * b, c * b: (c + 1) * b] = bl[s]
    return out


def spmm_reference(row_ptr, block_cols, blocks, x: torch.Tensor) -> torch.Tensor:
    """Dense-equivalent SpMM oracle: per-row-block accumulation of tile
    products, one row-block at a time."""
    b = blocks.shape[-1]
    x_blk = x.to(torch.float32).reshape(-1, b, x.shape[-1])
    rp = util.host(row_ptr)
    bc = util.host(block_cols)
    rows = []
    for r in range(rp.shape[0] - 1):
        acc = torch.zeros((b, x.shape[-1]), dtype=torch.float32, device=x.device)
        for s in range(int(rp[r]), int(rp[r + 1])):
            acc = acc + blocks[s].to(torch.float32) @ x_blk[int(bc[s])]
        rows.append(acc)
    return torch.cat(rows, dim=0)
