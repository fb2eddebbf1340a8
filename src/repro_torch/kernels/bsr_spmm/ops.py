"""CSR -> BSR conversion and the SpMM / reverse-walk entry points.

The counterpart of ``repro.kernels.bsr_spmm.ops``.  The index arrays are
computed with numpy exactly as ``repro`` computes them, so ``row_ptr``,
``block_cols``, ``blocks``, ``n_rows`` and ``max_blocks_per_row`` come out
bit-identical; the dense tiles are filled on the CSR's device with one
``index_put_`` instead of in host memory (a road graph of 2^24 vertices
holds ~393K tiles, 25.8 GB).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core import alloc, util
from ...core import csr as csr_mod
from . import kernel as _kernel
from . import ref as _ref


@dataclasses.dataclass(frozen=True)
class BSR:
    row_ptr: torch.Tensor     # [R+1] int32
    block_cols: torch.Tensor  # [NNZB] int32
    blocks: torch.Tensor      # [max(NNZB, 1), B, B] f32
    n_rows: int               # padded row count (R*B)
    n_cols: int               # padded col count
    max_blocks_per_row: int
    block_size: int


def csr_to_bsr(c: csr_mod.CSR, *, block_size: int = 128,
               weighted: bool = False) -> BSR:
    """Re-block a CSR adjacency into dense B×B tiles on the CSR's device.

    Pads rows/cols to a block multiple; ``max_blocks_per_row`` is the
    pow-2 bucket of the largest row-block (CP2AA policy), as in ``repro``.
    The CSR must hold each (row, dst) pair once (``from_coo``'s dedup):
    a pair stored twice would write one tile entry twice, in no defined
    order on the card.
    """
    b = block_size
    n_pad = -(-c.n // b) * b
    nb = n_pad // b
    o = util.host(c.offsets).astype(np.int64)
    dst = util.host(c.dst).astype(np.int64)
    wgt = (
        util.host(c.wgt).astype(np.float32)
        if (weighted and c.wgt is not None)
        else np.ones(c.m, np.float32)
    )
    rows = np.repeat(np.arange(c.n, dtype=np.int64), np.diff(o))
    key = (rows // b) * nb + dst // b
    uniq = np.unique(key)
    nnzb = uniq.shape[0]
    blk_of_edge = np.searchsorted(uniq, key)
    counts = np.bincount(uniq // nb, minlength=nb)
    row_ptr = np.zeros(nb + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    maxb = alloc.next_pow2(max(int(counts.max(initial=1)), 1))

    dev = c.device
    blocks = torch.zeros((max(nnzb, 1), b, b), dtype=torch.float32, device=dev)
    flat = (blk_of_edge * b + rows % b) * b + dst % b
    blocks.view(-1).index_put_(
        (torch.from_numpy(flat).to(dev),), torch.from_numpy(wgt).to(dev))
    return BSR(
        row_ptr=torch.from_numpy(row_ptr.astype(np.int32)).to(dev),
        block_cols=torch.from_numpy((uniq % nb).astype(np.int32)).to(dev),
        blocks=blocks,
        n_rows=n_pad,
        n_cols=n_pad,
        max_blocks_per_row=int(maxb),
        block_size=b,
    )


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``x`` as a contiguous f32 [rows, cols] panel, zero-padded."""
    if tuple(x.shape) == (rows, cols) and x.dtype == torch.float32:
        return x.contiguous()
    x_p = torch.zeros((rows, cols), dtype=torch.float32, device=x.device)
    x_p[: x.shape[0], : x.shape[1]] = x
    return x_p


def spmm(bsr: BSR, x: torch.Tensor, *, d_tile: int | None = None,
         backend: str = "auto") -> torch.Tensor:
    """Y = A @ X through the ``bsr_spmm`` kernel; pads X/D to block multiples.

    ``backend`` is ``"auto"`` (the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors), ``"cuda"`` or ``"torch"`` (the plain version
    on either device).  The default d-tile is ``repro``'s, raised to the
    kernel's smallest (8) for narrower X; the padding is sliced off.
    """
    backend = util.resolve_backend(backend, x.device)
    d = x.shape[-1]
    dt = d_tile or min(128, max(8, alloc.next_pow2(d)))
    x_p = _pad(x, bsr.n_cols, -(-d // dt) * dt)
    if backend == "cuda":
        y = _kernel.bsr_spmm(bsr.row_ptr, bsr.block_cols, bsr.blocks, x_p, d_tile=dt)
    else:
        y = _kernel.bsr_spmm_torch(bsr.row_ptr, bsr.block_cols, bsr.blocks, x_p)
    return y[: x.shape[0], :d]


def spmm_reference(bsr: BSR, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X through the per-row-block oracle (tests)."""
    x_p = _pad(x, bsr.n_cols, x.shape[-1])
    y = _ref.spmm_reference(bsr.row_ptr, bsr.block_cols, bsr.blocks, x_p)
    return y[: x.shape[0]]


def reverse_walk_bsr(bsr: BSR, steps: int, n: int, *,
                     backend: str = "auto") -> torch.Tensor:
    """Paper Alg 13 as iterated BSR SpMM: visits = A^k 1̄.

    The visits vector rides in column 0 of an [N, 8] panel, as in
    ``repro``, so every step is one ``bsr_spmm`` launch at d-tile 8.
    """
    v = torch.zeros((n, 8), dtype=torch.float32, device=bsr.row_ptr.device)
    v[:, 0] = 1.0
    for _ in range(steps):
        v = spmm(bsr, v, d_tile=8, backend=backend)
    return v[:, 0]
