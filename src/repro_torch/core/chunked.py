"""ChunkedGraph — the Aspen-analogue representation (DESIGN.md §3).

Aspen stores adjacency in purely-functional C-trees: elements chunked into
arrays, updates copy only the path/chunks they touch, snapshots are a root
pointer.  The device analogue: an **append-only page store**.

  * pages_dst/pages_wgt: [P_CAP, PAGE] device tensors (the chunk pool),
  * page_table:          host per-vertex page-id arrays,
  * updates write merged rows to *fresh* pages (bump allocation) and swap
    the affected page_table rows — old pages keep their contents, so a
    previously-taken snapshot (a copy of the old table) stays valid:
    O(touched-rows) update, O(#vertices) host snapshot.
  * ``vacuum()`` is the garbage-collection analogue (Aspen's reference
    counting): rewrites live pages compactly.

The page pool is written in place, so a snapshot seals it and the next
page write on either handle copies it first (``util.cow_detach``); pool
growth concatenates into fresh buffers and unseals for free.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import alloc, csr as csr_mod, edgebatch, updates, util, walk_image

SENTINEL = int(util.SENTINEL)
PAGE = 64  # edges per page (Aspen chunks are ~dozens of ints)
#: Most [A, K, W] equality-tensor elements one merge pass builds; a larger
#: width group merges in row chunks (the rows are independent).
EQ_ELEMS_MAX = 1 << 27


def _apply_rows(row_d, row_w, b_d, b_w, b_del, k_new: int):
    """Mixed merge of batch runs [A, K] into page rows [A, W].

    Delete ops mask their row hits to SENTINEL; insert ops concatenate
    *ahead* of the row so the stable sort + dedup-keep-first pass
    implements weight upsert — one program for insert, delete and mixed
    plans (the UpdatePlan guarantees one op per key).  Returns the merged
    rows cut to ``k_new`` lanes and their counts.
    """
    a, w = row_d.shape
    k = b_d.shape[1]
    step = max(EQ_ELEMS_MAX // max(k * w, 1), 1)
    if a > step:
        parts = [_apply_rows(row_d[i:i + step], row_w[i:i + step], b_d[i:i + step],
                             b_w[i:i + step], b_del[i:i + step], k_new)
                 for i in range(0, a, step)]
        return tuple(torch.cat(p) for p in zip(*parts))
    bdel = b_del != 0
    eq = b_d[:, :, None] == row_d[:, None, :]  # [A, K, W]
    killed = (eq & bdel[:, :, None]).any(dim=1)
    del eq
    row_d2 = torch.where(killed, SENTINEL, row_d)
    ins_d = torch.where(bdel, SENTINEL, b_d)
    keys = torch.cat([ins_d, row_d2], dim=1)
    vals = torch.cat([b_w, row_w], dim=1)
    order = torch.argsort(keys, dim=1, stable=True)
    keys = torch.gather(keys, 1, order)
    vals = torch.gather(vals, 1, order)
    keys, vals, counts = util.dedup_sorted_rows(keys, vals)
    return keys[:, :k_new], vals[:, :k_new], counts


def _gather_pages(pages_d, pages_w, page_ids):
    """Rows of pages [A, npages] -> flat rows [A, npages * PAGE]; page id -1
    reads as SENTINEL / 0."""
    ok = page_ids >= 0
    safe = page_ids.clamp(0, pages_d.shape[0] - 1)
    d = torch.where(ok[:, :, None], pages_d[safe], SENTINEL)
    w = torch.where(ok[:, :, None], pages_w[safe], 0.0)
    a = page_ids.shape[0]
    return d.reshape(a, -1), w.reshape(a, -1)


def _write_pages(pages_d, pages_w, owners, page_ids, rows_d, rows_w, row_ids):
    """Write flat rows [A, npages * PAGE] into their pages, in place; page
    id -1 drops the lanes."""
    a, npages = page_ids.shape
    ok = (page_ids >= 0).reshape(-1)
    tgt = page_ids.reshape(-1)[ok]
    pages_d[tgt] = rows_d.reshape(a * npages, PAGE)[ok]
    pages_w[tgt] = rows_w.reshape(a * npages, PAGE)[ok]
    owners[tgt] = row_ids[:, None].expand(a, npages).reshape(-1)[ok]


def _pad2(a: np.ndarray, rows: int, fill) -> np.ndarray:
    out = np.full((rows,) + a.shape[1:], fill, a.dtype)
    out[: a.shape[0]] = a
    return out


@dataclasses.dataclass
class ChunkedGraph:
    pages_dst: torch.Tensor       # [P_CAP, PAGE]
    pages_wgt: torch.Tensor       # [P_CAP, PAGE]
    page_owner: torch.Tensor      # [P_CAP] vertex id (CAP_V = dead)
    page_table: list              # per-vertex page-id arrays (host)
    degrees: np.ndarray
    n: int
    m: int
    next_page: int
    # per-buffer seal-on-snapshot (DESIGN.md §10): names of device buffers
    # shared with a snapshot.  Page writes detach the page pool; growing
    # the pool concatenates into fresh buffers and unseals for free.
    _sealed: set = dataclasses.field(default_factory=set)
    # cached walk image (DESIGN.md §11): the flat page gather, patched
    # incrementally instead of being reconstructed on every walk.
    _image: Optional[walk_image.WalkImage] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    _PAYLOAD = ("pages_dst", "pages_wgt", "page_owner")

    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.pages_dst.device

    @property
    def cap_v(self) -> int:
        return self.degrees.shape[0]

    @property
    def p_cap(self) -> int:
        return int(self.pages_dst.shape[0])

    @classmethod
    def from_csr(cls, c: csr_mod.CSR, *, device="cuda") -> "ChunkedGraph":
        """Vectorized page-pool build (DESIGN.md §10): the csr_build
        shifted-offset fill quantized to PAGE-sized blocks — a handful of
        numpy passes and three copies to the device regardless of n."""
        from ..kernels.csr_build import ops as _cb_ops

        dev = util.resolve_device(device)
        degrees = util.host(c.degrees).astype(np.int64)
        npages = -(-degrees // PAGE)
        total_pages = int(npages.sum())
        p_cap = alloc.next_pow2(max(total_pages, 2))
        ww = c.wgt if c.wgt is not None else np.ones(c.m, np.float32)
        page_base = np.cumsum(npages) - npages
        pages_d, pages_w, owner = _cb_ops.pages_image_host(
            c.offsets, c.dst, ww, page_base, npages, PAGE, p_cap, int(c.n)
        )
        bounds = np.cumsum(npages)
        all_ids = np.arange(total_pages, dtype=np.int64)
        table = np.split(all_ids, bounds[:-1]) if c.n else []
        return cls(
            pages_dst=torch.from_numpy(pages_d).to(dev),
            pages_wgt=torch.from_numpy(pages_w).to(dev),
            page_owner=torch.from_numpy(owner).to(dev),
            page_table=list(table),
            degrees=degrees.copy(),
            n=int(c.n),
            m=int(c.m),
            next_page=total_pages,
        )

    # ------------------------------------------------------------------
    def _reserve_vertices(self, n_needed: int) -> None:
        if n_needed <= len(self.page_table):
            return
        for _ in range(n_needed - len(self.page_table)):
            self.page_table.append(np.empty(0, np.int64))
        deg = np.zeros(n_needed, np.int64)
        deg[: self.degrees.shape[0]] = self.degrees
        self.degrees = deg
        self.n = max(self.n, n_needed)

    def _alloc_pages(self, count: int) -> np.ndarray:
        if self.next_page + count > self.p_cap:
            padp = alloc.next_pow2(self.next_page + count) - self.p_cap
            dev = self.device
            self.pages_dst = torch.cat([self.pages_dst, torch.full(
                (padp, PAGE), SENTINEL, dtype=torch.int32, device=dev)])
            self.pages_wgt = torch.cat([self.pages_wgt, torch.zeros(
                (padp, PAGE), dtype=torch.float32, device=dev)])
            self.page_owner = torch.cat([self.page_owner, torch.full(
                (padp,), self.cap_v, dtype=torch.int32, device=dev)])
            self._sealed.clear()  # grown pool = fresh buffers
        ids = np.arange(self.next_page, self.next_page + count, dtype=np.int64)
        self.next_page += count
        return ids

    # ------------------------------------------------------------------
    @property
    def sealed(self) -> bool:
        return bool(self._sealed)

    def _detach(self, *names: str) -> None:
        """COW: copy the named snapshot-shared buffers."""
        util.cow_detach(self, self._sealed, names or self._PAYLOAD)

    def _apply_plan(self, plan: updates.UpdatePlan) -> int:
        if plan.n_ops == 0:
            return 0
        plan.validate()  # corrupt plans (WAL replay) fail loudly (§13)
        if plan.n_ins:
            self._reserve_vertices(plan.max_insert_vertex() + 1)
        # shared out-of-range filter (delete-only runs at unseen rows)
        sel = np.nonzero(plan.rows_in_range(len(self.page_table)))[0]
        if sel.shape[0] == 0:
            return 0
        dev = self.device
        rows = plan.rows[sel]
        deg_old = self.degrees[rows]
        ins_count = plan.ins_count[sel]
        total_dm = 0
        # bucket rows by pow-2 page count of the merged row (upper bound)
        pages_new = np.maximum(-(-(deg_old + ins_count) // PAGE), 1)
        pclass = updates.next_pow2_vec(pages_new)
        for pc in np.unique(pclass):
            pc = int(pc)
            gsel = np.nonzero(pclass == pc)[0]
            r = rows[gsel]
            a_pad = alloc.next_pow2(max(r.shape[0], 1))
            # gather current rows
            tbl = np.full((a_pad, pc), -1, np.int64)
            for i, u in enumerate(r):
                ids = self.page_table[u]
                tbl[i, : ids.shape[0]] = ids[:pc]
            row_d, row_w = _gather_pages(self.pages_dst, self.pages_wgt,
                                         torch.from_numpy(tbl).to(dev))
            # the group's batch runs, built from the plan's op stream (K
            # floored at 4, as the walk-image groups are)
            kb = max(alloc.next_pow2(int(plan.run_count[sel[gsel]].max())), 4)
            b_d, b_w, b_l = (torch.from_numpy(x).to(dev)
                             for x in plan.run_tiles(sel[gsel], kb, a_pad))
            n = r.shape[0]
            new_d, new_w, cnts = _apply_rows(row_d, row_w, b_d, b_w, b_l, pc * PAGE)
            cnts = util.host(cnts).astype(np.int64)[:n]
            # functional write: fresh pages for every touched row
            need_pages = np.maximum(-(-cnts // PAGE), 1)
            new_tbl = np.full((a_pad, pc), -1, np.int64)
            for i, u in enumerate(r):
                ids = self._alloc_pages(int(need_pages[i]))
                self.page_table[u] = ids
                new_tbl[i, : ids.shape[0]] = ids
            rr = _pad2(r.astype(np.int32), a_pad, self.cap_v)
            # detach at the write site, AFTER _alloc_pages: pool growth
            # concatenates into fresh buffers and unseals for free, so a
            # growing post-snapshot batch pays no COW copy at all
            self._detach()
            _write_pages(self.pages_dst, self.pages_wgt, self.page_owner,
                         torch.from_numpy(new_tbl).to(dev), new_d, new_w,
                         torch.from_numpy(rr).to(dev))
            dm = int((cnts - self.degrees[r]).sum())
            self.degrees[r] = cnts
            total_dm += dm
        self.m += total_dm
        if self._image is not None:
            self._image.queue(plan)  # the flat walk view patches lazily
        return total_dm

    def add_edges(self, batch: edgebatch.EdgeBatch, *, inplace: bool = True):
        g = self if inplace else self.snapshot()
        dm = g._apply_plan(updates.plan_update(inserts=batch))
        return g, dm

    def remove_edges(self, batch: edgebatch.EdgeBatch, *, inplace: bool = True):
        g = self if inplace else self.snapshot()
        dm = g._apply_plan(updates.plan_update(deletes=batch))
        return g, -dm

    def apply(self, plan: updates.UpdatePlan, *, inplace: bool = True):
        """Mixed delete+insert batch in one pass; returns (graph, net ΔM)."""
        g = self if inplace else self.snapshot()
        return g, g._apply_plan(plan)

    # ------------------------------------------------------------------
    def snapshot(self) -> "ChunkedGraph":
        """Aspen acquire_version(): O(#vertices) host metadata, zero device.

        Seals the shared payload; the next page write on either handle
        pays one detach copy (copy-on-write), while pool growth unseals
        for free.
        """
        self._sealed = set(self._PAYLOAD)
        return dataclasses.replace(
            self,
            page_table=list(self.page_table),
            degrees=self.degrees.copy(),
            _sealed=set(self._PAYLOAD),
            _image=None,  # images are handle-private (patched in place)
        )

    def clone(self) -> "ChunkedGraph":
        copies = util.fused_copy(*(getattr(self, n) for n in self._PAYLOAD))
        return dataclasses.replace(
            self,
            page_table=[ids.copy() for ids in self.page_table],
            degrees=self.degrees.copy(),
            _sealed=set(),
            _image=None,
            **dict(zip(self._PAYLOAD, copies)),
        )

    # -- durable state (checkpoint/restore, DESIGN.md §13) ---------------
    def state_tree(self) -> dict:
        lens = np.array([ids.shape[0] for ids in self.page_table], np.int64)
        flat = (
            np.concatenate(self.page_table)
            if self.page_table
            else np.empty(0, np.int64)
        ).astype(np.int64)
        return {
            "pages_dst": util.host(self.pages_dst),
            "pages_wgt": util.host(self.pages_wgt),
            "page_owner": util.host(self.page_owner),
            "table_lens": lens,
            "table_flat": flat,
            "degrees": self.degrees.copy(),
            "n": np.int64(self.n),
            "m": np.int64(self.m),
            "next_page": np.int64(self.next_page),
        }

    @classmethod
    def from_state_tree(cls, t: dict, *, device="cuda") -> "ChunkedGraph":
        dev = util.resolve_device(device)
        lens = np.asarray(t["table_lens"], np.int64)
        flat = np.asarray(t["table_flat"], np.int64)
        bounds = np.cumsum(lens)[:-1]
        table = [a.copy() for a in np.split(flat, bounds)] if lens.shape[0] else []

        def payload(key, dtype):
            return torch.from_numpy(np.array(t[key], dtype=dtype)).to(dev)

        return cls(
            pages_dst=payload("pages_dst", np.int32),
            pages_wgt=payload("pages_wgt", np.float32),
            page_owner=payload("page_owner", np.int32),
            page_table=table,
            degrees=np.asarray(t["degrees"], np.int64).copy(),
            n=int(t["n"]),
            m=int(t["m"]),
            next_page=int(t["next_page"]),
        )

    def vacuum(self) -> None:
        """GC: rebuild the page store with only live pages (Aspen refcount GC)."""
        fresh = ChunkedGraph.from_csr(self.to_csr(), device=self.device)
        self.__dict__.update(fresh.__dict__)

    def _table_lens(self) -> np.ndarray:
        return np.array([ids.shape[0] for ids in self.page_table[: self.n]], np.int64)

    def _live_gather(self, lens: np.ndarray):
        """(degrees, per-live-edge flat pool index on the device) of THIS
        version's rows, whose page lists have lengths ``lens``: edge j of
        row u lives at ``page_ids[j // PAGE] * PAGE + j % PAGE``."""
        table = self.page_table[: self.n]
        degs = self.degrees[: self.n]
        m = int(degs.sum())
        dev = self.device
        if m == 0:
            return degs, torch.zeros(0, dtype=torch.int64, device=dev)
        live = torch.from_numpy(np.concatenate([ids for ids in table if ids.shape[0]])).to(dev)
        degs_t = torch.from_numpy(degs).to(dev)
        lens_t = torch.from_numpy(lens).to(dev)
        row_first = torch.repeat_interleave(torch.cumsum(degs_t, 0) - degs_t, degs_t,
                                            output_size=m)
        e_local = torch.arange(m, dtype=torch.int64, device=dev) - row_first
        page_rank = torch.repeat_interleave(torch.cumsum(lens_t, 0) - lens_t, degs_t,
                                            output_size=m) + e_local // PAGE
        return degs, live[page_rank] * PAGE + e_local % PAGE

    def to_csr(self) -> csr_mod.CSR:
        """Compact CSR export (on the graph's device): one gather of every
        row's live prefix out of its pages (rows are sorted)."""
        degs, gidx = self._live_gather(self._table_lens())
        dev = self.device
        offsets = np.zeros(self.n + 1, np.int64)
        np.cumsum(degs, out=offsets[1:])
        return csr_mod.CSR(
            offsets=torch.from_numpy(offsets.astype(np.int32)).to(dev),
            dst=self.pages_dst.reshape(-1)[gidx],
            wgt=self.pages_wgt.reshape(-1)[gidx],
            n=self.n,
            m=int(offsets[-1]),
        )

    def to_walk_image(self, *, backend: str = "auto") -> walk_image.WalkImage:
        """Cached walk image: one flat gather of THIS version's pages.

        Liveness is version-local (superseded pages stay in the pool for
        older snapshots), so the build gathers the current page_table into
        a packed buffer whose blocks are the rows' page runs — PAGE-
        quantized slack that the patch engine then maintains incrementally,
        so repeat walks and update/walk streams never reconstruct the flat
        view again.
        """
        img = self._image
        if img is not None and img.flush(backend=backend):
            return img
        self._image = img = self._build_image()
        return img

    def _build_image(self) -> walk_image.WalkImage:
        dev = self.device
        lens = self._table_lens()
        total_pages = int(lens.sum())
        if total_pages == 0:
            nv = max(self.n, 1)
            return walk_image.WalkImage.from_blocks(
                torch.full((2,), SENTINEL, dtype=torch.int32, device=dev),
                torch.zeros(2, dtype=torch.float32, device=dev),
                torch.full((2,), self.n, dtype=torch.int32, device=dev),
                np.full(nv, -1, np.int64), np.zeros(nv, np.int64), np.zeros(nv, np.int64),
                self.n, 0, 0,
            )
        degs = self.degrees[: self.n]
        m = int(degs.sum())
        # dense image compaction (DESIGN.md §12): the PAGE-quantized gather
        # builds at ~0.3 occupancy on typical degree mixes, and a 42-step
        # walk re-reads every dead lane per step — when the slack
        # dominates, strip it and walk live edges only.
        if m and m < walk_image.DENSE_THRESHOLD * total_pages * PAGE:
            return self._build_dense_image(lens, m)
        live = np.concatenate(
            [ids for ids in self.page_table[: self.n] if ids.shape[0]]
        )
        bump = total_pages * PAGE
        cap_pages = alloc.pow2_with_headroom(total_pages)
        live_p = np.full(cap_pages, -1, np.int64)
        live_p[:total_pages] = live
        own_p = np.full(cap_pages, self.n, np.int32)
        own_p[:total_pages] = np.repeat(np.arange(self.n, dtype=np.int32), lens)
        pages_d, pages_w = _gather_pages(self.pages_dst, self.pages_wgt,
                                         torch.from_numpy(live_p).to(dev)[:, None])
        csum = np.cumsum(lens)
        starts = np.where(lens > 0, (csum - lens) * PAGE, -1)
        return walk_image.WalkImage.from_blocks(
            pages_d.reshape(-1),
            pages_w.reshape(-1),
            torch.from_numpy(np.repeat(own_p, PAGE)).to(dev),
            starts,
            lens * PAGE,
            self.degrees[: self.n].copy(),
            self.n, bump, int(self.m),
        )

    def _build_dense_image(self, lens: np.ndarray, m: int) -> walk_image.WalkImage:
        """Dense walk image: PAGE tails stripped, blocks = exact degrees.

        One per-live-edge gather index into the flat page pool packs the
        pool into a CSR-ordered buffer with occupancy 1.0 — the patch
        engine then maintains it incrementally, relocating grown rows into
        the 100% bump reserve dense layouts take (every insert-touched row
        relocates).
        """
        degs, gidx = self._live_gather(lens)
        dev = self.device
        cap_e = alloc.pow2_with_headroom(m, 1.0)  # dense: deep bump reserve
        dst_d = torch.full((cap_e,), SENTINEL, dtype=torch.int32, device=dev)
        wgt_d = torch.zeros(cap_e, dtype=torch.float32, device=dev)
        rows = torch.full((cap_e,), self.n, dtype=torch.int32, device=dev)
        dst_d[:m] = self.pages_dst.reshape(-1)[gidx]
        wgt_d[:m] = self.pages_wgt.reshape(-1)[gidx]
        rows[:m] = torch.repeat_interleave(
            torch.arange(self.n, dtype=torch.int32, device=dev),
            torch.from_numpy(degs).to(dev), output_size=m)
        dcs = np.cumsum(degs)
        starts = np.where(degs > 0, dcs - degs, -1)
        return walk_image.WalkImage.from_blocks(
            dst_d, wgt_d, rows,
            starts, degs.copy(), degs.copy(),
            self.n, m, m,
        )

    def walk_occupancy(self) -> float:
        return self.to_walk_image().occupancy

    def reverse_walk(self, steps: int, *, backend: str = "auto",
                     normalize: bool = False, visits0=None) -> torch.Tensor:
        # fused flush→walk: one host wait per stream round (§12)
        return walk_image.reverse_walk_via_image(
            self, steps, backend=backend, normalize=normalize, visits0=visits0)

    def to_edge_sets(self) -> list[set[int]]:
        return self.to_csr().to_edge_sets()
