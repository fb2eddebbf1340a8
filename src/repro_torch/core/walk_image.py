"""WalkImage — the traversal-image layer (DESIGN.md §11/§12).

A representation lowers to ONE canonical device traversal image: a packed
edge buffer (``dst``/``wgt``/``rows``, SENTINEL on dead slots) plus
per-vertex ``[lo, hi)`` block intervals — exactly the operand set the
``kernels/slot_walk`` engine consumes.

This slice ports the part that arena-backed (``shared=True``) images use:
``DiGraph``'s arena *is* its image, so the wrap aliases the live buffers
and the rep's own update engine keeps them current.  The queue / patch /
``walk_flush`` / ``seal`` maintenance of ``repro``'s non-shared images is
not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import alloc, util

SENTINEL = util.SENTINEL
#: Build-time live fraction below which an image build strips the source
#: layout's slack entirely (caps == degrees, occupancy 1.0).
DENSE_THRESHOLD = 0.55


@dataclasses.dataclass
class WalkImage:
    """Packed traversal image + host block geometry (one per owner rep)."""

    # device payload
    dst: torch.Tensor   # int32 [cap_e], SENTINEL on dead slots
    wgt: torch.Tensor   # f32   [cap_e]
    rows: torch.Tensor  # int32 [cap_e] slot owner (stale allowed on dead)
    # host block geometry (CP2AA classes, or exact degrees when dense)
    starts: np.ndarray  # int64 [>= nv], -1 = no block
    caps: np.ndarray    # int64 [>= nv]
    degs: np.ndarray    # int64 [>= nv]
    nv: int             # vertices the walk covers (visits length)
    bump: int           # first never-allocated slot
    live: int           # live edges in the image
    #: True when dst/wgt/rows alias the owner's own arena (DiGraph)
    shared: bool = False
    base_occupancy: float = 1.0
    # device [lo, hi) interval cache
    _blocks: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def cap_e(self) -> int:
        return int(self.dst.shape[0])

    @property
    def occupancy(self) -> float:
        """Live-edge fraction of the image's allocated slot prefix."""
        return self.live / max(int(self.bump), 1)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_csr_arrays(cls, offsets, dst, wgt, nv: int, *, device,
                        engine: str = "auto", dense: Optional[bool] = None,
                        min_cap_e: int = 0) -> "WalkImage":
        """Build a slack-padded OR dense image from CSR-ordered arrays.

        CP2AA block placement on host, one ``arena_image`` fill for the
        device payload.  ``dense=None`` strips the slack when the CP2AA
        layout's live fraction would fall below ``DENSE_THRESHOLD``.
        ``cap_e`` keeps >= 25% bump headroom either way.
        """
        from ..kernels.csr_build import ops as _cb_ops

        o = util.host(offsets).astype(np.int64)
        nv = int(nv)
        deg = np.diff(o)
        m = int(o[-1]) if o.shape[0] else 0
        caps = np.where(deg > 0, alloc.edge_capacities(deg), 0)
        total = int(caps.sum())
        if dense is None:
            dense = m > 0 and m < DENSE_THRESHOLD * total
        if dense:
            caps = deg.copy()
            total = m
        csum = np.cumsum(caps)
        starts = np.where(caps > 0, csum - caps, -1)
        cap_e = alloc.pow2_with_headroom(total, 1.0 if dense else 0.25)
        cap_e = max(cap_e, int(min_cap_e))
        w = wgt if wgt is not None else np.ones(m, np.float32)
        dst_d, wgt_d, rows_d = _cb_ops.arena_image(
            o, dst[:m], w[:m], starts, caps, cap_e, nv,
            total=total, device=device, engine=engine,
        )
        return cls(
            dst=dst_d, wgt=wgt_d, rows=rows_d,
            starts=starts.astype(np.int64), caps=caps.astype(np.int64),
            degs=deg.astype(np.int64), nv=nv, bump=total, live=m,
            base_occupancy=m / max(total, 1),
        )

    @classmethod
    def from_blocks(cls, dst, wgt, rows, starts, caps, degs, nv: int,
                    bump: int, live: int, *, shared: bool = False) -> "WalkImage":
        """Wrap pre-blocked device buffers (the DiGraph arena)."""
        return cls(
            dst=dst, wgt=wgt, rows=rows,
            starts=np.asarray(starts, np.int64),
            caps=np.asarray(caps, np.int64),
            degs=np.asarray(degs, np.int64),
            nv=int(nv), bump=int(bump), live=int(live), shared=shared,
            base_occupancy=int(live) / max(int(bump), 1),
        )

    # ------------------------------------------------------------------
    # walking
    # ------------------------------------------------------------------
    def edges_hi(self) -> int:
        """Bump prefix bound, quantized to cap_e/8 (<= 8 sizes per capacity)."""
        q = max(self.cap_e // 8, 128)
        return min(-(-max(int(self.bump), 1) // q) * q, self.cap_e)

    def device_blocks(self):
        """Device [lo, hi) interval tensors, memoized until the next update."""
        if self._blocks is None:
            starts = self.starts[: self.nv]
            has_block = starts >= 0
            lo = np.where(has_block, starts, 0).astype(np.int32)
            hi = np.where(has_block, starts + self.degs[: self.nv], 0).astype(np.int32)
            dev = self.dst.device
            self._blocks = (torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev))
        return self._blocks

    def walk(self, steps: int, *, backend: str = "auto",
             normalize: bool = False, visits0=None) -> torch.Tensor:
        """k-step reverse walk over the image via the slot_walk engine.

        ``visits0`` may be a ``[B, num_vertices]`` stack of initial visit
        vectors — all B walks then share each step.
        """
        from ..kernels.slot_walk import ops as _sw_ops

        return _sw_ops.slot_walk_image(
            self, steps, backend=backend, normalize=normalize, visits0=visits0,
        )
