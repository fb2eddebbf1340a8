"""Vector2D — the paper's Fig. 1 strawman: per-vertex host arrays.

Stands in for the PetGraph/SNAP class of representations (per-vertex
containers, allocation on every touched row, no slack).  Intentionally
allocation-heavy: every touched row reallocates (np.union1d / setdiff1d),
every clone reallocates every row — the baseline the paper's Figure 1
motivates CP2AA with.  Only its walk image lives on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from . import csr as csr_mod, edgebatch, updates, util, walk_image


class Vector2D:
    def __init__(self, rows: list, wrows: list, n: int, m: int, *, device="cuda"):
        self.rows = rows
        self.wrows = wrows
        self.n = n
        self.m = m
        self.device = util.resolve_device(device)
        # cached walk image (DESIGN.md §11): even the strawman's walks ride
        # the shared engine — its *update* path stays allocation-heavy.
        self._image: walk_image.WalkImage | None = None

    @classmethod
    def from_csr(cls, c: csr_mod.CSR, *, device="cuda") -> "Vector2D":
        o = util.host(c.offsets).astype(np.int64)
        d = np.ascontiguousarray(util.host(c.dst))
        w = np.ascontiguousarray(
            util.host(c.wgt) if c.wgt is not None else np.ones(c.m, np.float32)
        )
        # one np.split instead of n fancy-index copies; rows are views of
        # one backing buffer, which is safe because updates always REPLACE
        # a row array (union1d / boolean keep), never write into it
        cuts = o[1:-1]
        rows = np.split(d, cuts) if c.n else []
        wrows = np.split(w, cuts) if c.n else []
        return cls(list(rows), list(wrows), int(c.n), int(c.m), device=device)

    def _reserve(self, n: int) -> None:
        while len(self.rows) < n:
            self.rows.append(np.empty(0, np.int32))
            self.wrows.append(np.empty(0, np.float32))
        self.n = max(self.n, n)

    def add_edges(self, batch: edgebatch.EdgeBatch, *, inplace: bool = True):
        g, dm = self.apply(updates.plan_update(inserts=batch), inplace=inplace)
        return g, dm

    def remove_edges(self, batch: edgebatch.EdgeBatch, *, inplace: bool = True):
        g, dm = self.apply(updates.plan_update(deletes=batch), inplace=inplace)
        return g, -dm

    def apply(self, plan: updates.UpdatePlan, *, inplace: bool = True):
        """Mixed plan, one reallocation per touched row (the point)."""
        g = self if inplace else self.clone()
        if plan.n_ops == 0:
            return g, 0
        plan.validate()  # corrupt plans (WAL replay) fail loudly (§13)
        if plan.n_ins:
            g._reserve(plan.max_insert_vertex() + 1)
        dm = 0
        for u, fi, ct in zip(plan.rows, plan.run_first, plan.run_count):
            if u >= len(g.rows):  # delete-only run at an unseen row
                continue
            run_d = plan.q_dst[fi: fi + ct]
            run_w = plan.q_wgt[fi: fi + ct]
            run_del = plan.q_del[fi: fi + ct]
            old, oldw = g.rows[u], g.wrows[u]
            if run_del.any():
                keep = ~np.isin(old, run_d[run_del])
                old, oldw = old[keep], oldw[keep]  # fresh allocation
            ins_d, ins_w = run_d[~run_del], run_w[~run_del]
            if ins_d.shape[0]:
                new = np.union1d(old, ins_d).astype(np.int32)  # fresh again
                neww = np.zeros(new.shape[0], np.float32)
                neww[np.searchsorted(new, old)] = oldw
                neww[np.searchsorted(new, ins_d)] = ins_w  # batch weight wins
            else:
                new, neww = old, oldw
            dm += new.shape[0] - g.rows[u].shape[0]
            g.rows[u], g.wrows[u] = new, neww
        g.m += dm
        if g._image is not None:
            g._image.queue(plan)
        return g, dm

    def clone(self) -> "Vector2D":
        return Vector2D(
            [r.copy() for r in self.rows],
            [w.copy() for w in self.wrows],
            self.n,
            self.m,
            device=self.device,
        )

    def snapshot(self) -> "Vector2D":
        return self.clone()  # no cheap snapshot in this class — the point

    # -- durable state (checkpoint/restore, DESIGN.md §13) ---------------
    def state_tree(self) -> dict:
        lens = np.array([r.shape[0] for r in self.rows], np.int64)
        return {
            "row_lens": lens,
            "dst_flat": (
                np.concatenate(self.rows) if self.rows else np.empty(0, np.int32)
            ).astype(np.int32),
            "wgt_flat": (
                np.concatenate(self.wrows) if self.wrows else np.empty(0, np.float32)
            ).astype(np.float32),
            "n": np.int64(self.n),
            "m": np.int64(self.m),
        }

    @classmethod
    def from_state_tree(cls, t: dict, *, device="cuda") -> "Vector2D":
        lens = np.asarray(t["row_lens"], np.int64)
        bounds = np.cumsum(lens)[:-1]
        d = np.asarray(t["dst_flat"], np.int32)
        w = np.asarray(t["wgt_flat"], np.float32)
        rows = [a.copy() for a in np.split(d, bounds)] if lens.shape[0] else []
        wrows = [a.copy() for a in np.split(w, bounds)] if lens.shape[0] else []
        return cls(rows, wrows, int(t["n"]), int(t["m"]), device=device)

    def _flat(self):
        """One ragged host flatten: (offsets [n + 1] int64, dst, wgt)."""
        offsets = np.zeros(self.n + 1, np.int64)
        if self.m == 0:
            return offsets, np.empty(0, np.int32), np.empty(0, np.float32)
        np.cumsum([r.shape[0] for r in self.rows], out=offsets[1:])
        return (offsets, np.concatenate(self.rows).astype(np.int32),
                np.concatenate(self.wrows).astype(np.float32))

    def to_csr(self) -> csr_mod.CSR:
        """CSR on the graph's device (rows are sorted and unique)."""
        offsets, dst, wgt = self._flat()
        dev = self.device
        return csr_mod.CSR(
            offsets=torch.from_numpy(offsets.astype(np.int32)).to(dev),
            dst=torch.from_numpy(dst).to(dev),
            wgt=torch.from_numpy(wgt).to(dev),
            n=self.n,
            m=int(dst.shape[0]),
        )

    def to_walk_image(self, *, backend: str = "auto") -> walk_image.WalkImage:
        """Cached walk image: one ragged host flatten at build time (the
        locality penalty of per-vertex arrays), then incrementally patched
        on the device — repeat walks never re-flatten the rows."""
        img = self._image
        if img is not None and img.flush(backend=backend):
            return img
        offsets, dst, wgt = self._flat()
        self._image = img = walk_image.WalkImage.from_csr_arrays(
            offsets, dst, wgt, self.n, device=self.device
        )
        return img

    def walk_occupancy(self) -> float:
        return self.to_walk_image().occupancy

    def reverse_walk(self, steps: int, *, backend: str = "auto",
                     normalize: bool = False, visits0=None) -> torch.Tensor:
        # fused flush→walk: one host wait per stream round (§12)
        return walk_image.reverse_walk_via_image(
            self, steps, backend=backend, normalize=normalize, visits0=visits0)

    def to_edge_sets(self) -> list[set[int]]:
        return [set(np.asarray(r).tolist()) for r in self.rows]
