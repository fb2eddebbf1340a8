"""LazyCSR — the SuiteSparse:GraphBLAS-analogue representation.

GraphBLAS handles dynamic updates with *zombies* (deleted entries marked in
place) and *pending tuples* (insertions buffered unsorted), consolidating
lazily when an operation needs the assembled matrix.  Here:

  * base CSR (offsets/dst/wgt) + ``dead`` mask  — zombies,
  * pow-2 ring of pending COO tuples           — pending insertions,
  * ``assemble()``                              — the consolidation phase
    (sort-merge of live base + deduped pending), triggered by export.

Updates are therefore O(batch); walks splice the zombies and pending runs
into the cached walk image instead of assembling — exactly the trade the
paper measures for GraphBLAS.

The zombie masks and the pending ring are written in place, so a snapshot
seals them and the next write copies only the buffers it writes
(``util.cow_detach``); the base arrays are never written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import alloc, csr as csr_mod, edgebatch, updates, util, walk_image

SENTINEL = int(util.SENTINEL)
#: pending-ring capacity after a build or an assemble
PENDING_CAP = 16


def _assemble(base_rows, base_dst, base_wgt, dead, ps, pd, pw, pdead, p_n: int,
              out_cap: int):
    """Live base + live pending, (src, dst)-sorted, duplicates resolved to
    the LATEST pending tuple -> (src, dst, wgt, m), ``out_cap`` slots."""
    lane = torch.arange(ps.shape[0], device=ps.device)
    p_live = (lane < p_n) & ~pdead & (ps != SENTINEL)
    # reverse pending so the *latest* duplicate wins dedup-keep-first
    ps_r, pd_r, pw_r, pl_r = ps.flip(0), pd.flip(0), pw.flip(0), p_live.flip(0)
    s = torch.cat([torch.where(pl_r, ps_r, SENTINEL), torch.where(dead, SENTINEL, base_rows)])
    d = torch.cat([torch.where(pl_r, pd_r, SENTINEL), torch.where(dead, SENTINEL, base_dst)])
    w = torch.cat([pw_r, base_wgt])
    order = util.lexsort2(s, d)
    s, d, w = s[order], d[order], w[order]
    dup = ~util.coo_dedup_mask(s, d)
    s = torch.where(dup, SENTINEL, s)
    d2 = torch.where(dup, SENTINEL, d)
    order = util.lexsort2(s, d2)
    s, d2, w = s[order], d2[order], w[order]
    m = int((s != SENTINEL).sum())
    return s[:out_cap], d2[:out_cap], w[:out_cap], m


@dataclasses.dataclass
class LazyCSR:
    # assembled base (flat COO-with-row-ids view of a CSR; rows sorted)
    base_rows: torch.Tensor
    base_dst: torch.Tensor
    base_wgt: torch.Tensor
    offsets: np.ndarray          # host offsets into base (valid when clean)
    dead: torch.Tensor           # bool, zombie mask over base slots
    # pending ring
    p_src: torch.Tensor
    p_dst: torch.Tensor
    p_wgt: torch.Tensor
    p_dead: torch.Tensor
    p_n: int
    n: int
    m: int                       # live-edge count (exact when clean)
    n_zombies: int
    dirty: bool
    # per-buffer seal-on-snapshot (DESIGN.md §10): zombie marking detaches
    # only the masks, pending appends only the ring — the (large) base
    # arrays are never written in place and therefore never copied.
    _sealed: set = dataclasses.field(default_factory=set)
    # cached walk image (DESIGN.md §11): patched per applied plan, so
    # walks skip assemble() entirely — consolidation only serves to_csr.
    _image: Optional[walk_image.WalkImage] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    #: every device buffer participating in snapshot sharing
    _PAYLOAD = (
        "base_rows", "base_dst", "base_wgt", "dead",
        "p_src", "p_dst", "p_wgt", "p_dead",
    )

    @property
    def device(self) -> torch.device:
        return self.base_dst.device

    @staticmethod
    def _empty_ring(dev):
        return (torch.full((PENDING_CAP,), SENTINEL, dtype=torch.int32, device=dev),
                torch.full((PENDING_CAP,), SENTINEL, dtype=torch.int32, device=dev),
                torch.zeros(PENDING_CAP, dtype=torch.float32, device=dev),
                torch.zeros(PENDING_CAP, dtype=torch.bool, device=dev))

    @classmethod
    def from_csr(cls, c: csr_mod.CSR, *, device="cuda") -> "LazyCSR":
        from ..kernels.csr_build import ops as _cb_ops

        dev = util.resolve_device(device)
        cap = alloc.next_pow2(max(c.m, 2))
        w = c.wgt if c.wgt is not None else torch.ones(c.m, dtype=torch.float32)
        base_rows, base_dst, base_wgt = _cb_ops.flat_image(c.offsets, c.dst, w, cap,
                                                            device=dev)
        p_src, p_dst, p_wgt, p_dead = cls._empty_ring(dev)
        return cls(
            base_rows=base_rows,
            base_dst=base_dst,
            base_wgt=base_wgt,
            offsets=util.host(c.offsets).astype(np.int64),
            dead=torch.zeros(cap, dtype=torch.bool, device=dev),
            p_src=p_src, p_dst=p_dst, p_wgt=p_wgt, p_dead=p_dead,
            p_n=0,
            n=int(c.n),
            m=int(c.m),
            n_zombies=0,
            dirty=False,
        )

    @property
    def sealed(self) -> bool:
        return bool(self._sealed)

    def _detach(self, *names: str) -> None:
        """Copy ONLY the named snapshot-shared buffers."""
        util.cow_detach(self, self._sealed, names or self._PAYLOAD)

    # -- updates ----------------------------------------------------------
    def add_edges(self, batch: edgebatch.EdgeBatch, *, inplace: bool = True):
        g, dm = self.apply(updates.plan_update(inserts=batch), inplace=inplace)
        return g, dm

    def remove_edges(self, batch: edgebatch.EdgeBatch, *, inplace: bool = True):
        g, dm = self.apply(updates.plan_update(deletes=batch), inplace=inplace)
        return g, -dm

    def apply(self, plan: updates.UpdatePlan, *, inplace: bool = True):
        """Mixed batch: mark zombies first, then buffer pending inserts.

        GraphBLAS semantics are inherently split — deletions become
        zombies in the assembled base, insertions wait in the pending ring
        — so a mixed plan drives both halves from its split views.
        Returns the *lazy* net ΔM estimate (exact after assemble()).
        """
        if plan.n_ops == 0:
            return self, 0
        plan.validate()  # corrupt plans (WAL replay) fail loudly (§13)
        g = self if inplace else self.clone()
        dm = 0
        if plan.n_del:
            dm -= g._mark_deletes(*plan.delete_arrays())
        if plan.n_ins:
            dm += g._append_pending(plan.insert_batch())
        g.dirty = True
        if g._image is not None:
            g._image.queue(plan)  # zombies + pending splice into the image
        return g, dm

    def _mark_deletes(self, s: np.ndarray, d: np.ndarray) -> int:
        """Zombie-mark (s, d) pairs in base + pending; returns #newly dead."""
        # zombie masks are the only buffers this writes (per-buffer COW)
        self._detach("dead", *(("p_dead",) if self.p_n > 0 else ()))
        dev = self.device
        s64 = s.astype(np.int64)
        nrow = self.offsets.shape[0] - 1
        valid = s64 < nrow
        lo = np.where(valid, self.offsets[np.minimum(s64, nrow - 1)], 0)
        hi = np.where(valid, self.offsets[np.minimum(s64 + 1, nrow)], 0)
        pos, found = util.binsearch_window(
            self.base_dst, torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev),
            torch.from_numpy(d.astype(np.int32)).to(dev))
        # a zombie slot must not match again: re-deleting a dead edge is a
        # no-op for the count
        already = self.dead[pos.clamp(0, self.dead.shape[0] - 1)]
        newly = found & ~already
        self.dead[pos[newly]] = True
        nz = int(newly.sum())
        self.n_zombies += nz
        if self.p_n > 0:
            # flip the search: every pending tuple (duplicates included)
            # checks its own membership in the (sorted) deletion batch
            _, hit = util.searchsorted_2d(
                torch.from_numpy(s.astype(np.int32)).to(dev),
                torch.from_numpy(d.astype(np.int32)).to(dev), self.p_src, self.p_dst)
            self.p_dead |= hit & (self.p_src != SENTINEL)
        self.m -= nz
        return nz

    def _append_pending(self, batch: edgebatch.EdgeBatch) -> int:
        """Ring-buffer the insert batch; returns the lazy ΔM estimate."""
        dev = self.device
        need = self.p_n + batch.capacity
        if need > self.p_src.shape[0]:
            pad = alloc.next_pow2(need) - self.p_src.shape[0]
            self.p_src = torch.cat([self.p_src, torch.full(
                (pad,), SENTINEL, dtype=torch.int32, device=dev)])
            self.p_dst = torch.cat([self.p_dst, torch.full(
                (pad,), SENTINEL, dtype=torch.int32, device=dev)])
            self.p_wgt = torch.cat([self.p_wgt, torch.zeros(pad, dtype=torch.float32,
                                                            device=dev)])
            self.p_dead = torch.cat([self.p_dead, torch.zeros(pad, dtype=torch.bool,
                                                              device=dev)])
            # ring growth produced fresh buffers; any snapshot keeps the old
            self._sealed -= {"p_src", "p_dst", "p_wgt", "p_dead"}
        else:
            # only the pending ring is written (per-buffer COW)
            self._detach("p_src", "p_dst", "p_wgt")
        at, cap = self.p_n, batch.capacity
        self.p_src[at:at + cap] = torch.from_numpy(batch.src).to(dev)
        self.p_dst[at:at + cap] = torch.from_numpy(batch.dst).to(dev)
        self.p_wgt[at:at + cap] = torch.from_numpy(batch.wgt).to(dev)
        self.p_n += cap
        self.n = max(self.n, batch.max_vertex() + 1)
        return batch.n

    # -- consolidation (GraphBLAS "wait") ----------------------------------
    def assemble(self) -> None:
        if not self.dirty:
            return
        out_cap = alloc.next_pow2(max(self.base_dst.shape[0] + self.p_n, 2))
        s, d, w, m = _assemble(
            self.base_rows, self.base_dst, self.base_wgt, self.dead,
            self.p_src, self.p_dst, self.p_wgt, self.p_dead, self.p_n, out_cap,
        )
        dev = self.device
        self.base_rows, self.base_dst, self.base_wgt = s, d, w
        self.m = m
        self.dead = torch.zeros(s.shape[0], dtype=torch.bool, device=dev)
        if m:
            self.n = max(self.n, int(s[m - 1]) + 1)  # sources ascend
        offsets = torch.searchsorted(
            s[:m], torch.arange(self.n + 1, dtype=torch.int32, device=dev))
        self.offsets = util.host(offsets).astype(np.int64)
        self.p_src, self.p_dst, self.p_wgt, self.p_dead = self._empty_ring(dev)
        self.p_n = 0
        self.n_zombies = 0
        self.dirty = False
        self._sealed.clear()  # fresh buffers, nothing shared

    # -- export / queries ---------------------------------------------------
    def clone(self) -> "LazyCSR":
        copies = util.fused_copy(*(getattr(self, n) for n in self._PAYLOAD))
        return dataclasses.replace(
            self,
            offsets=self.offsets.copy(),
            _sealed=set(),
            _image=None,  # images are handle-private (patched in place)
            **dict(zip(self._PAYLOAD, copies)),
        )

    def snapshot(self) -> "LazyCSR":
        """GraphBLAS-style lazy copy: share buffers until the next write.

        Per-buffer COW keeps the base arrays shared forever — updates only
        ever detach the zombie masks or the pending ring.
        """
        self._sealed = set(self._PAYLOAD)
        return dataclasses.replace(
            self,
            offsets=self.offsets.copy(),
            _sealed=set(self._PAYLOAD),
            _image=None,  # images are handle-private (patched in place)
        )

    # -- durable state (checkpoint/restore, DESIGN.md §13) ---------------
    def state_tree(self) -> dict:
        t = {k: util.host(getattr(self, k)) for k in self._PAYLOAD}
        t["offsets"] = self.offsets.copy()
        t.update(p_n=np.int64(self.p_n), n=np.int64(self.n), m=np.int64(self.m),
                 n_zombies=np.int64(self.n_zombies), dirty=np.int64(int(self.dirty)))
        return t

    @classmethod
    def from_state_tree(cls, t: dict, *, device="cuda") -> "LazyCSR":
        dev = util.resolve_device(device)
        dtypes = dict(base_rows=np.int32, base_dst=np.int32, base_wgt=np.float32,
                      dead=bool, p_src=np.int32, p_dst=np.int32, p_wgt=np.float32,
                      p_dead=bool)
        return cls(
            **{k: torch.from_numpy(np.array(t[k], dtype=dt)).to(dev)
               for k, dt in dtypes.items()},
            offsets=np.asarray(t["offsets"], np.int64).copy(),
            p_n=int(t["p_n"]),
            n=int(t["n"]),
            m=int(t["m"]),
            n_zombies=int(t["n_zombies"]),
            dirty=bool(int(t["dirty"])),
        )

    def to_csr(self) -> csr_mod.CSR:
        self.assemble()
        return csr_mod.from_sorted(self.base_rows[: self.m], self.base_dst[: self.m],
                                   self.base_wgt[: self.m], self.n)

    def to_walk_image(self, *, backend: str = "auto") -> walk_image.WalkImage:
        """Cached walk image: zombie masking and pending-run splicing ride
        the generic patch engine, so a *dirty* LazyCSR walks without paying
        assemble() — the GraphBLAS consolidation only remains on the export
        path (``to_csr``).  The build itself consolidates once so the base
        arrays are CSR-ordered.
        """
        img = self._image
        if img is not None and img.flush(backend=backend):
            return img
        self.assemble()
        self._image = img = walk_image.WalkImage.from_csr_arrays(
            self.offsets, self.base_dst, self.base_wgt, self.n, device=self.device
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
