"""SortedCOO — the cuGraph-analogue representation (DESIGN.md §3).

cuGraph applies batch updates by sort-merging the batch with the existing
edge list and rebuilding the graph.  Here: a (src, dst)-lexsorted COO with
SENTINEL padding to a pow-2 capacity on the device; *every update builds a
new instance* (there is no in-place path — exactly cuGraph's behaviour).
Insert, delete and mixed batches all run through one galloping merge
(``_merge``) fed by the shared ``UpdatePlan`` layer (DESIGN.md §9).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import alloc, csr as csr_mod, edgebatch, updates, util, walk_image

SENTINEL = int(util.SENTINEL)


def _merge(gs, gd, gw, ds, dd, is_, id_, iw, out_cap: int):
    """Mixed delete+insert rebuild as a GALLOPING merge (DESIGN.md §12).

    The base is (src, dst)-lexsorted with a SENTINEL tail and both batch
    halves arrive sorted from the UpdatePlan, so the merged order is fully
    determined by binary-search ranks plus prefix counts — no re-sort of
    the whole edge list:

      * deletes:  one packed-key search marks dead base slots,
      * upserts:  inserts whose key exists overwrite the weight (in a copy
        of the weights: the old instance keeps its own),
      * placement: output slot ``o`` holds the r-th surviving base entry
        (r = o − #new-inserts-before-o) or the matching new insert.  Only
        the [B]-sized batch is ever sorted (by output slot).

    The plan guarantees one op per key, so deletes and inserts never fight
    and all new-insert keys are distinct.  Returns (src, dst, wgt, m).
    """
    dev = gs.device
    glive = gs != SENTINEL
    _, hit = util.searchsorted_2d(ds, dd, gs, gd)
    keep = glive & ~hit
    ilive = is_ != SENTINEL
    pos_i, found_i = util.searchsorted_2d(gs, gd, is_, id_)
    is_new = ilive & ~found_i
    up = ilive & found_i
    gw = gw.clone()
    gw[pos_i[up]] = iw[up]  # weight upsert
    keep_idx = torch.nonzero(keep).squeeze(1)  # the r-th surviving base slot
    n_keep = int(keep_idx.shape[0])
    kcum0 = torch.zeros(gs.shape[0] + 1, dtype=torch.int64, device=dev)
    kcum0[1:] = torch.cumsum(keep, 0)
    ins_rank = torch.cumsum(is_new, 0) - is_new.to(torch.int64)
    # output slot of each new insert: surviving base entries before its key
    # + new inserts before it in the (sorted) batch
    o_i = torch.where(is_new, kcum0[pos_i] + ins_rank, out_cap)
    srt, order = torch.sort(o_i, stable=True)  # [B] tiny sort
    s_srt, d_srt, w_srt = is_[order], id_[order], iw[order]
    m = n_keep + int(is_new.sum())
    out_s = torch.full((out_cap,), SENTINEL, dtype=torch.int32, device=dev)
    out_d = torch.full((out_cap,), SENTINEL, dtype=torch.int32, device=dev)
    out_w = torch.zeros(out_cap, dtype=torch.float32, device=dev)
    if m:  # slots >= m are the SENTINEL tail: neither inserts nor survivors
        o = torch.arange(m, dtype=torch.int64, device=dev)
        idx = torch.searchsorted(srt, o)
        safe_i = idx.clamp(max=srt.shape[0] - 1)
        from_ins = srt[safe_i] == o
        j = (keep_idx[(o - idx).clamp(0, n_keep - 1)] if n_keep
             else torch.zeros_like(o))
        out_s[:m] = torch.where(from_ins, s_srt[safe_i], gs[j])
        out_d[:m] = torch.where(from_ins, d_srt[safe_i], gd[j])
        out_w[:m] = torch.where(from_ins, w_srt[safe_i], gw[j])
    return out_s, out_d, out_w, m


@dataclasses.dataclass
class SortedCOO:
    src: torch.Tensor
    dst: torch.Tensor
    wgt: torch.Tensor
    n: int
    m: int
    # cached walk image (DESIGN.md §11), migrated to the successor
    # instance on apply() so update/walk streams never rebuild it
    _image: Optional[walk_image.WalkImage] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def capacity(self) -> int:
        return int(self.src.shape[0])

    @classmethod
    def from_csr(cls, c: csr_mod.CSR, *, device="cuda") -> "SortedCOO":
        from ..kernels.csr_build import ops as _cb_ops

        dev = util.resolve_device(device)
        cap = alloc.next_pow2(max(c.m, 2))
        w = c.wgt if c.wgt is not None else torch.ones(c.m, dtype=torch.float32)
        src, dst, wgt = _cb_ops.flat_image(c.offsets, c.dst, w, cap, device=dev)
        return cls(src, dst, wgt, int(c.n), int(c.m))

    # -- updates (always a new instance, cuGraph semantics) --------------
    def add_edges(self, batch: edgebatch.EdgeBatch, *, inplace: bool = False):
        g, dm = self.apply(updates.plan_update(inserts=batch), inplace=inplace)
        return g, dm

    def remove_edges(self, batch: edgebatch.EdgeBatch, *, inplace: bool = False):
        g, dm = self.apply(updates.plan_update(deletes=batch), inplace=inplace)
        return g, -dm

    def apply(self, plan: updates.UpdatePlan, *, inplace: bool = False):
        """Mixed delete+insert rebuild in one merge (net ΔM)."""
        del inplace  # rebuild-only representation
        if plan.n_ops == 0:
            return self, 0
        plan.validate()  # corrupt plans (WAL replay) fail loudly (§13)
        ins = plan.insert_batch()
        dele = plan.delete_batch()
        n = max(self.n, plan.max_insert_vertex() + 1)
        out_cap = alloc.next_pow2(max(self.m + plan.n_ins, 2))
        dev = self.device
        ds, dd, is_, id_, iw = (torch.from_numpy(a).to(dev) for a in (
            dele.src, dele.dst, ins.src, ins.dst, ins.wgt))
        s, d, w, m = _merge(self.src, self.dst, self.wgt, ds, dd, is_, id_, iw, out_cap)
        g = SortedCOO(s, d, w, n, m)
        # the successor inherits the walk image + queues the plan on it;
        # this handle's arrays are rebuilt anyway (cuGraph semantics), so
        # it rebuilds its image lazily if walked again.
        img, self._image = self._image, None
        if img is not None:
            img.queue(plan)
            g._image = img
        return g, m - self.m

    # -- export / queries -------------------------------------------------
    def clone(self) -> "SortedCOO":
        return SortedCOO(
            *util.fused_copy(self.src, self.dst, self.wgt), self.n, self.m
        )

    def snapshot(self) -> "SortedCOO":
        # no update writes these buffers in place: sharing them is isolation
        return dataclasses.replace(self, _image=None)

    # -- durable state (checkpoint/restore, DESIGN.md §13) ---------------
    def state_tree(self) -> dict:
        return {
            "src": util.host(self.src),
            "dst": util.host(self.dst),
            "wgt": util.host(self.wgt),
            "n": np.int64(self.n),
            "m": np.int64(self.m),
        }

    @classmethod
    def from_state_tree(cls, t: dict, *, device="cuda") -> "SortedCOO":
        dev = util.resolve_device(device)

        def payload(key, dtype):
            return torch.from_numpy(np.array(t[key], dtype=dtype)).to(dev)

        return cls(payload("src", np.int32), payload("dst", np.int32),
                   payload("wgt", np.float32), int(t["n"]), int(t["m"]))

    def to_csr(self) -> csr_mod.CSR:
        return csr_mod.from_sorted(self.src[: self.m], self.dst[: self.m],
                                   self.wgt[: self.m], self.n)

    def to_walk_image(self, *, backend: str = "auto") -> walk_image.WalkImage:
        """Cached walk image: patched per queued plan, rebuilt on demand.

        The (src, dst)-sorted buffer is already CSR-ordered, so the build
        reads offsets off one ``searchsorted`` and reuses the ingest
        engine's slack-padded arena fill.
        """
        img = self._image
        if img is not None and img.flush(backend=backend):
            return img
        ids = torch.arange(self.n + 1, dtype=torch.int32, device=self.device)
        offsets = torch.searchsorted(self.src[: self.m], ids)
        self._image = img = walk_image.WalkImage.from_csr_arrays(
            offsets, self.dst, self.wgt, self.n, device=self.device
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
        return self.to_csr().to_edge_sets()
