"""DiGraph — the paper's representation (Alg 1/2) on PyTorch tensors.

Layout (SoA, DESIGN.md §2):
  host metadata : degrees / capacities / block starts / exists  (numpy)
  device payload: dst[CAP_E] int32, wgt[CAP_E] f32, slot_rows[CAP_E] int32

Each vertex owns a contiguous *block* of edge slots whose size is a CP2AA
power-of-2 class (``alloc.edge_capacity``).  Blocks are handed out by the
host-side ``ArenaLayout`` (free lists + bump pointer) over one flat device
buffer.  Rows are ascending with SENTINEL padding.

Updates flow through the shared batch-update engine (DESIGN.md §9):
``core/updates.py`` canonicalizes a batch into an ``UpdatePlan`` once, then
``apply`` runs ``kernels/slot_update.fused_apply``: read the touched rows,
merge the sorted runs and write back in place (one ``merge_rows_fused``
launch per width group on the card) — grown rows land directly in their
new CP2AA block.

Torch tensors are mutable, so snapshot isolation is explicit: a snapshot
shares the payload and seals it on both handles, and an update copies
(``_detach``) only the sealed buffers it is about to write.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import alloc, arena, csr as csr_mod, edgebatch, updates, util, walk_image
from ..kernels.csr_build import ops as _cb_ops
from ..kernels.slot_update import ops as _su_ops
from ..runtime import trace

SENTINEL = int(util.SENTINEL)

#: Live-slot fraction of the arena bump prefix below which traversal-time
#: auto-compaction kicks in (DESIGN.md §7).
COMPACT_THRESHOLD = 0.5
#: Don't bother compacting arenas smaller than this many slots.
COMPACT_MIN_SLOTS = 4 * 128


def _grow_buffer(dst, wgt, slot_rows, new_cap: int, cap_v: int):
    """Fresh pow-2 buffers holding the old payload as their prefix."""
    nd = torch.full((new_cap,), SENTINEL, dtype=torch.int32, device=dst.device)
    nw = torch.zeros(new_cap, dtype=torch.float32, device=dst.device)
    nr = torch.full((new_cap,), cap_v, dtype=torch.int32, device=dst.device)
    nd[: dst.shape[0]] = dst
    nw[: wgt.shape[0]] = wgt
    nr[: slot_rows.shape[0]] = slot_rows
    return nd, nw, nr


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DiGraph:
    """Mutable host handle around device payload tensors."""

    # host metadata
    degrees: np.ndarray        # int64 [CAP_V]
    capacities: np.ndarray     # int64 [CAP_V]  (0 = no block)
    starts: np.ndarray         # int64 [CAP_V]  (-1 = no block)
    exists: np.ndarray         # bool  [CAP_V]
    layout: arena.ArenaLayout
    n: int
    m: int
    # device payload
    dst: torch.Tensor
    wgt: torch.Tensor
    slot_rows: torch.Tensor
    stats: alloc.AllocStats = dataclasses.field(default_factory=alloc.AllocStats)
    # per-buffer seal-on-snapshot (DESIGN.md §10): names of device buffers
    # currently shared with a snapshot.  A mutation detaches ONLY the
    # buffers it is about to write.
    _sealed: set = dataclasses.field(default_factory=set)
    # memoized derived views; any mutation resets them to None.
    _csr_cache: Optional[csr_mod.CSR] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _image: Optional[walk_image.WalkImage] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.dst.device

    @property
    def cap_v(self) -> int:
        return self.degrees.shape[0]

    @property
    def cap_e(self) -> int:
        return int(self.dst.shape[0])

    def has_vertex(self, u: int) -> bool:
        return 0 <= u < self.cap_v and bool(self.exists[u])

    def degree(self, u: int) -> int:
        return int(self.degrees[u]) if u < self.cap_v else 0

    def edges_of(self, u: int) -> np.ndarray:
        if u >= self.cap_v or self.starts[u] < 0:
            return np.empty((0,), np.int32)
        s, d = int(self.starts[u]), int(self.degrees[u])
        return util.host(self.dst[s: s + d])

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_csr(cls, c: csr_mod.CSR, *, device="cuda",
                 engine: str = "auto") -> "DiGraph":
        """Direct CSR -> arena-image construction on ``device`` (§10).

        Host metadata (CP2AA block placement) stays numpy; the device
        payload comes from ``kernels/csr_build.arena_image``.
        """
        dev = util.resolve_device(device)
        offsets_h = util.host(c.offsets).astype(np.int64)
        degrees = np.diff(offsets_h)
        n_cap = alloc.reserve_size(c.n)
        deg = np.zeros(n_cap, np.int64)
        deg[: c.n] = degrees
        caps = np.zeros(n_cap, np.int64)
        caps[: c.n] = np.where(degrees > 0, alloc.edge_capacities(degrees), 0)
        starts = np.full(n_cap, -1, np.int64)
        csum = np.zeros(c.n, np.int64)
        np.cumsum(caps[: c.n], out=csum)
        starts[: c.n] = np.where(caps[: c.n] > 0, csum - caps[: c.n], -1)
        total = int(csum[-1]) if c.n else 0
        cap_e = alloc.next_pow2(max(total, 2))
        lay = arena.ArenaLayout(capacity=cap_e, bump=total)

        wgt_src = c.wgt if c.wgt is not None else torch.ones(c.m, dtype=torch.float32)
        dst_d, wgt_d, rows_d = _cb_ops.arena_image(
            c.offsets, c.dst, wgt_src,
            starts[: c.n], caps[: c.n], cap_e, n_cap,
            total=total, device=dev, engine=engine,
        )
        exists = np.zeros(n_cap, bool)
        exists[: c.n] = True
        g = cls(
            degrees=deg, capacities=caps, starts=starts, exists=exists,
            layout=lay, n=int(c.n), m=int(c.m),
            dst=dst_d, wgt=wgt_d, slot_rows=rows_d,
        )
        g._refresh_occupancy()
        return g

    @classmethod
    def empty(cls, n_vertices: int = 0, *, device="cuda") -> "DiGraph":
        dev = util.resolve_device(device)
        n_cap = alloc.reserve_size(max(n_vertices, 1))
        cap_e = 2
        exists = np.zeros(n_cap, bool)
        exists[:n_vertices] = True
        return cls(
            degrees=np.zeros(n_cap, np.int64),
            capacities=np.zeros(n_cap, np.int64),
            starts=np.full(n_cap, -1, np.int64),
            exists=exists,
            layout=arena.ArenaLayout(capacity=cap_e),
            n=n_vertices,
            m=0,
            dst=torch.full((cap_e,), SENTINEL, dtype=torch.int32, device=dev),
            wgt=torch.zeros(cap_e, dtype=torch.float32, device=dev),
            slot_rows=torch.full((cap_e,), n_cap, dtype=torch.int32, device=dev),
        )

    # ------------------------------------------------------------------
    # vertex ops (paper reserve()/addVertex())
    # ------------------------------------------------------------------
    def _reserve(self, n_needed: int) -> None:
        if n_needed <= self.cap_v:
            return
        new_cap = alloc.reserve_size(n_needed)

        def grow(a, fill):
            out = np.full(new_cap, fill, a.dtype)
            out[: a.shape[0]] = a
            return out

        self.degrees = grow(self.degrees, 0)
        self.capacities = grow(self.capacities, 0)
        self.starts = grow(self.starts, -1)
        self.exists = grow(self.exists, False)
        self.stats.record_relayout()

    def add_vertices(self, ids: np.ndarray) -> int:
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if ids.size == 0:
            return 0
        self._reserve(int(ids.max()) + 1)
        newly = ~self.exists[ids]
        self.exists[ids] = True
        added = int(np.unique(ids[newly]).shape[0])
        self.n += added
        if added:
            self._invalidate_derived()
        return added

    # ------------------------------------------------------------------
    # occupancy bookkeeping (live vs dead slots in the bump prefix)
    # ------------------------------------------------------------------
    def _refresh_occupancy(self) -> None:
        self.stats.used_elems = int(self.m)
        self.stats.slack_elems = max(int(self.layout.bump) - int(self.m), 0)

    @property
    def live_fraction(self) -> float:
        """Fraction of the arena's bump prefix holding live edges."""
        return self.stats.live_fraction

    def _invalidate_derived(self) -> None:
        self._csr_cache = None
        self._image = None

    def _refresh_image(self, lo, hi) -> None:
        """Keep the cached shared walk image current across an update.

        The arena IS the image (``shared=True``), so after an update only
        the buffer references, bump and live count change.  ``lo``/``hi``
        are the [lo, hi) bounds ``fused_apply`` refreshed (None drops the
        interval cache instead).
        """
        img = self._image
        if img is None:
            return
        if img.starts is not self.starts:
            self._image = None
            return
        img.dst, img.wgt, img.rows = self.dst, self.wgt, self.slot_rows
        img.bump = int(self.layout.bump)
        img.live = int(self.m)
        img._blocks = (lo, hi) if lo is not None else None

    # ------------------------------------------------------------------
    # the paper's core ops
    # ------------------------------------------------------------------
    @property
    def sealed(self) -> bool:
        """True while ANY device buffer is shared with a snapshot."""
        return bool(self._sealed)

    def _detach(self, *names: str) -> None:
        """Per-buffer copy-on-write (DESIGN.md §10).

        Copies ONLY the named snapshot-shared buffers (all of them when
        called bare) and marks them private.
        """
        util.cow_detach(self, self._sealed, names or ("dst", "wgt", "slot_rows"))

    def add_edges(self, batch: edgebatch.EdgeBatch, *, inplace: bool = True,
                  backend: str = "auto"):
        """Graph union G ∪ ΔG (paper Alg 8).  Returns (graph, ΔM)."""
        return self.apply(
            updates.plan_update(inserts=batch), inplace=inplace, backend=backend
        )

    def remove_edges(self, batch: edgebatch.EdgeBatch, *, inplace: bool = True,
                     backend: str = "auto"):
        """Graph subtraction G \\ ΔG (paper Alg 7).  Returns (graph, ΔM)."""
        g, dm = self.apply(
            updates.plan_update(deletes=batch), inplace=inplace, backend=backend
        )
        return g, -dm

    def apply(self, plan: updates.UpdatePlan, *, inplace: bool = True,
              backend: str = "auto"):
        """Apply a mixed delete+insert UpdatePlan in one pass (DESIGN.md §9).

        Returns ``(graph, ΔM)`` with ΔM the *net* edge-count change.
        ``backend`` picks the row merge: ``cuda`` (the kernel), ``torch``
        (its plain version) or ``auto`` (by device).
        """
        with trace.span("digraph.apply"):
            plan.validate()  # corrupt plans fail loudly (§13)
            util.resolve_backend(backend, self.device)  # before any mutation
            g = self if inplace else self.clone()
            dm = g._apply_impl(plan, backend)
        return g, dm

    # -- the fused plan/apply pipeline ------------------------------------
    def _apply_impl(self, plan: updates.UpdatePlan, backend: str) -> int:
        if plan.n_ops == 0:
            return 0
        with trace.span("apply.rows"):
            if plan.n_ins:
                s, d, _ = plan.insert_arrays()
                self.add_vertices(np.concatenate([s, d]))
            # shared dirty-row export: drops out-of-range rows and inert runs
            sel, rows, deg_old, ins_count = plan.active_rows(self.degrees, self.cap_v)
        if sel.shape[0] == 0:
            return 0
        old_caps = self.capacities[rows]
        old_starts = self.starts[rows]

        # CP2AA grow decisions (host): rows whose insert upper bound spills
        # their class get a fresh block, written by the same apply.
        with trace.span("apply.alloc"):
            ub = deg_old + ins_count
            grow = ub > old_caps
            new_caps = old_caps.copy()
            new_starts = old_starts.copy()
            if grow.any():
                g_idx = np.nonzero(grow)[0]
                need = alloc.edge_capacities(ub[grow])
                new_caps[g_idx] = need
                pending: list[int] = []
                for i, c in zip(g_idx, need):
                    got = self.layout.try_alloc(int(c))
                    if got is None:
                        pending.append(int(i))
                    else:
                        new_starts[i] = got
                if pending:
                    target = self.layout.grow_target(int(need.sum()))
                    self.dst, self.wgt, self.slot_rows = _grow_buffer(
                        self.dst, self.wgt, self.slot_rows, target, self.cap_v
                    )
                    self._sealed.clear()  # grow copies into fresh buffers
                    self.layout.capacity = target
                    self.stats.record_relayout()
                    for i in pending:
                        got = self.layout.try_alloc(int(new_caps[i]))
                        assert got is not None
                        new_starts[i] = got
                self.stats.record_relayout()

        has_moves = bool(grow.any())
        # per-buffer COW: dst/wgt are always written; the owner map only
        # when a block moves — a sealed slot_rows stays snapshot-shared
        # through every non-moving update.
        self._detach("dst", "wgt", *(("slot_rows",) if has_moves else ()))
        with trace.span("apply.groups"):
            groups, layout, rebuild = _su_ops.patch_operands(
                plan, sel, rows, deg_old, grow, old_starts, old_caps, new_starts, new_caps,
                cap_e=self.cap_e, bump=int(self.layout.bump), cap_v=self.cap_v,
                device=self.device,
            )
        # interval-cache refresh rides the same apply: when the shared
        # walk image has warm [lo, hi) blocks, they are updated from the
        # merge counts and the next walk skips the host geometry rebuild.
        img = self._image
        blk = img._blocks if img is not None and img.starts is self.starts else None
        lo, hi = blk if blk is not None else (None, None)
        applied = _su_ops.fused_apply(self.dst, self.wgt, self.slot_rows, groups,
                                      backend=backend, lo=lo, hi=hi, rebuild=rebuild)
        net = _su_ops.install_counts(self.degrees, rows, deg_old, layout, applied.counts())

        # free vacated blocks, install the new geometry
        if has_moves:
            with trace.span("apply.free"):
                for st, cp in zip(old_starts[grow], old_caps[grow]):
                    if cp > 0 and st >= 0:
                        self.layout.free(int(st), int(cp))
                self.starts[rows] = new_starts
                self.capacities[rows] = new_caps
        self.m += net
        self._csr_cache = None
        self._refresh_image(applied.lo, applied.hi)
        self._refresh_occupancy()
        return net

    # ------------------------------------------------------------------
    # block compaction (DESIGN.md §7)
    # ------------------------------------------------------------------
    def compact(self) -> int:
        """Repack every live block into a dense arena prefix.

        Re-derives minimal CP2AA capacity classes from the current
        degrees, gathers all live edges into fresh pow-2 buffers, and
        resets the arena.  Returns the slots reclaimed from the prefix.
        """
        live = np.nonzero(self.degrees > 0)[0]
        deg = self.degrees[live]
        new_caps = alloc.edge_capacities(deg) if live.size else np.zeros(0, np.int64)
        csum = np.cumsum(new_caps) if live.size else np.zeros(0, np.int64)
        new_starts = csum - new_caps
        total = int(csum[-1]) if live.size else 0
        new_cap_e = alloc.next_pow2(max(total, 2))
        old_bump = int(self.layout.bump)
        dev = self.device

        nd = torch.full((new_cap_e,), SENTINEL, dtype=torch.int32, device=dev)
        nw = torch.zeros(new_cap_e, dtype=torch.float32, device=dev)
        m = int(deg.sum())
        if m:
            dcs = np.cumsum(deg)
            off = np.arange(m, dtype=np.int64) - np.repeat(dcs - deg, deg)
            src_idx = torch.from_numpy(np.repeat(self.starts[live], deg) + off).to(dev)
            dst_idx = torch.from_numpy(np.repeat(new_starts, deg) + off).to(dev)
            nd[dst_idx] = self.dst[src_idx]
            nw[dst_idx] = self.wgt[src_idx]
        slot_rows = np.full(new_cap_e, self.cap_v, np.int32)
        if total:
            slot_rows[:total] = np.repeat(live.astype(np.int32), new_caps)
        self.dst, self.wgt = nd, nw
        self.slot_rows = torch.from_numpy(slot_rows).to(dev)

        self.capacities[:] = 0
        self.capacities[live] = new_caps
        self.starts[:] = -1
        self.starts[live] = new_starts
        self.layout = arena.ArenaLayout(capacity=new_cap_e, bump=total)
        self._sealed.clear()  # fresh buffers: snapshots keep the old payload
        self.stats.record_relayout()
        self._refresh_occupancy()
        self._invalidate_derived()
        return old_bump - total

    def maybe_compact(self, threshold: float = COMPACT_THRESHOLD) -> bool:
        """Compact iff dead slots dominate the bump prefix (DESIGN.md §7)."""
        bump = int(self.layout.bump)
        if bump < COMPACT_MIN_SLOTS or self.m >= threshold * bump:
            return False
        self.compact()
        return True

    # ------------------------------------------------------------------
    # cloning / snapshots / export (paper Alg 6)
    # ------------------------------------------------------------------
    def clone(self) -> "DiGraph":
        """Deep copy: one ``.clone()`` per payload buffer, no host sync."""
        dst, wgt, slot_rows = util.fused_copy(self.dst, self.wgt, self.slot_rows)
        g = DiGraph(
            degrees=self.degrees.copy(),
            capacities=self.capacities.copy(),
            starts=self.starts.copy(),
            exists=self.exists.copy(),
            layout=self.layout.clone(),
            n=self.n,
            m=self.m,
            dst=dst,
            wgt=wgt,
            slot_rows=slot_rows,
        )
        g._refresh_occupancy()  # clone starts with fresh stats
        return g

    def snapshot(self) -> "DiGraph":
        """O(1) device-cost snapshot: shares payload, seals both handles.

        The next in-place update on either handle first copies ONLY the
        buffers it writes (per-buffer COW), so neither handle ever sees
        the other's later writes.
        """
        self._sealed = {"dst", "wgt", "slot_rows"}
        return dataclasses.replace(
            self,
            degrees=self.degrees.copy(),
            capacities=self.capacities.copy(),
            starts=self.starts.copy(),
            exists=self.exists.copy(),
            layout=self.layout.clone(),
            stats=dataclasses.replace(self.stats),
            _sealed={"dst", "wgt", "slot_rows"},
            _csr_cache=None,
            _image=None,  # the image aliases THIS handle's host metadata
        )

    # -- durable state (checkpoint/restore, DESIGN.md §13) ---------------
    def state_tree(self) -> dict:
        """Flat numpy dict of the FULL canonical state — bit-exact restore.

        Same keys as ``repro``'s ``DiGraph.state_tree``, including the
        arena geometry (bump pointer and the free lists in stack order).
        """
        lay = self.layout
        sizes = sorted(k for k, v in lay.freed.items() if v)
        return {
            "degrees": self.degrees.copy(),
            "capacities": self.capacities.copy(),
            "starts": self.starts.copy(),
            "exists": self.exists.copy(),
            "dst": util.host(self.dst),
            "wgt": util.host(self.wgt),
            "slot_rows": util.host(self.slot_rows),
            "n": np.int64(self.n),
            "m": np.int64(self.m),
            "arena/capacity": np.int64(lay.capacity),
            "arena/bump": np.int64(lay.bump),
            "arena/freed_sizes": np.asarray(sizes, np.int64),
            "arena/freed_counts": np.asarray(
                [len(lay.freed[s]) for s in sizes], np.int64
            ),
            "arena/freed_starts": np.asarray(
                [st for s in sizes for st in lay.freed[s]], np.int64
            ),
        }

    @classmethod
    def from_state_tree(cls, t: dict, *, device="cuda") -> "DiGraph":
        """Rebuild a graph on ``device`` from a ``state_tree`` dict (either
        package's)."""
        dev = util.resolve_device(device)
        lay = arena.ArenaLayout(
            capacity=int(t["arena/capacity"]), bump=int(t["arena/bump"])
        )
        at = 0
        starts_f = np.asarray(t["arena/freed_starts"], np.int64)
        for s, c in zip(
            np.asarray(t["arena/freed_sizes"], np.int64).tolist(),
            np.asarray(t["arena/freed_counts"], np.int64).tolist(),
        ):
            lay.freed[int(s)] = [int(x) for x in starts_f[at:at + c]]
            at += c

        def payload(key, dtype):
            return torch.from_numpy(np.array(t[key], dtype=dtype)).to(dev)

        g = cls(
            degrees=np.asarray(t["degrees"], np.int64).copy(),
            capacities=np.asarray(t["capacities"], np.int64).copy(),
            starts=np.asarray(t["starts"], np.int64).copy(),
            exists=np.asarray(t["exists"], bool).copy(),
            layout=lay,
            n=int(t["n"]),
            m=int(t["m"]),
            dst=payload("dst", np.int32),
            wgt=payload("wgt", np.float32),
            slot_rows=payload("slot_rows", np.int32),
        )
        g._refresh_occupancy()
        return g

    def to_csr(self) -> csr_mod.CSR:
        """Compact CSR export (on the graph's device), memoized until the
        next mutation."""
        if self._csr_cache is None:
            self._csr_cache = self._build_csr()
        return self._csr_cache

    def _build_csr(self) -> csr_mod.CSR:
        nv = self.n_max_vertex() + 1
        deg = self.degrees[:nv]
        total = int(deg.sum())
        offsets = np.zeros(nv + 1, np.int64)
        np.cumsum(deg, out=offsets[1:])
        dev = self.device
        if total:
            gidx = np.repeat(self.starts[:nv].clip(0), deg) + (
                np.arange(total) - np.repeat(offsets[:-1], deg)
            )
            gidx = torch.from_numpy(gidx).to(dev)
            dsel = self.dst[gidx]
            wsel = self.wgt[gidx]
        else:
            dsel = torch.zeros(0, dtype=torch.int32, device=dev)
            wsel = torch.zeros(0, dtype=torch.float32, device=dev)
        return csr_mod.CSR(
            offsets=torch.from_numpy(offsets.astype(np.int32)).to(dev),
            dst=dsel,
            wgt=wsel,
            n=nv,
            m=total,
        )

    def to_walk_image(self) -> walk_image.WalkImage:
        """The canonical traversal image (DESIGN.md §11) — zero-cost here.

        The arena *is* the image: the wrap shares the device payload and
        host block metadata (``shared=True``).
        """
        if self._image is None:
            nv = self.n_max_vertex() + 1
            self._image = walk_image.WalkImage.from_blocks(
                self.dst, self.wgt, self.slot_rows,
                self.starts, self.capacities, self.degrees,
                nv, int(self.layout.bump), int(self.m), shared=True,
            )
        return self._image

    def walk_occupancy(self) -> float:
        """Live-edge fraction of the walk image's slot prefix."""
        return self.to_walk_image().occupancy

    def reverse_walk(self, steps: int, *, backend: str = "auto",
                     auto_compact: bool = True, normalize: bool = False,
                     visits0=None) -> torch.Tensor:
        """Paper Alg 13 via the walk-image layer (DESIGN.md §6/§11).

        Only the arena's bump prefix (quantized) is walked, and when dead
        slots dominate after heavy deletions the blocks are first
        compacted (``auto_compact``).  ``visits0`` [B, V] batches B walks.
        """
        with trace.span("digraph.reverse_walk"):
            if auto_compact:
                self.maybe_compact()
            return self.to_walk_image().walk(
                steps, backend=backend, normalize=normalize, visits0=visits0
            )

    def n_max_vertex(self) -> int:
        nz = np.nonzero(self.exists)[0]
        return int(nz[-1]) if nz.size else -1

    def to_edge_sets(self) -> list[set[int]]:
        return self.to_csr().to_edge_sets()
