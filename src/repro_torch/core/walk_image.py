"""WalkImage — the traversal-image layer (DESIGN.md §11/§12).

A representation lowers to ONE canonical device traversal image: a packed
edge buffer (``dst``/``wgt``/``rows``, SENTINEL on dead slots) plus
per-vertex ``[lo, hi)`` block intervals — exactly the operand set the
``kernels/slot_walk`` engine consumes.  The image is incrementally
maintained under update streams instead of being rebuilt per walk:

  * representations *queue* each applied ``UpdatePlan`` on their cached
    image (``queue``), and the next walk *flushes* the queue by patching
    the touched rows in place through ``kernels/slot_update.fused_apply``
    (one ``merge_rows_fused`` launch per width group on the card); on the
    walk path (``walk_flush``) the k-step walk is queued right behind the
    merges, so a stream round waits for the device once, for the merge
    counts;
  * rows sit in CP2AA slack-padded blocks (``alloc.edge_capacities``), or
    densely when the source layout's slack would dominate the walked
    prefix (``DENSE_THRESHOLD``);
  * a row that outgrows its slack relocates to a fresh block at the
    image's bump pointer in the same launch;
  * the patch path gives up (the owner rebuilds) only when the bump slack
    is exhausted, the vertex set grows, the queue got too deep to be worth
    replaying (``MAX_PENDING``), or dead slots came to dominate the walked
    prefix (``COMPACT_THRESHOLD``).

``DiGraph`` is the degenerate case: its arena *is* its image, so
``shared=True`` aliases the live buffers and the rep's own update engine
keeps them current (shared images never patch).

Torch tensors are mutable, so a sealed generation (``seal``) that shares
the live image's payload is protected explicitly: while ``_cow`` is set the
next patch copies ``dst``/``wgt``/``rows`` before writing into them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import alloc, util
from ..kernels.slot_update import ops as _su_ops
from ..kernels.slot_walk import ops as _sw_ops

SENTINEL = util.SENTINEL

#: Queue depth beyond which replaying patches is judged worse than one
#: rebuild (each pending plan costs a fused apply).
MAX_PENDING = 32
#: Fraction of the BUILD-TIME occupancy below which a flush demands a
#: rebuild instead of further patching: dead slots of relocated / deleted
#: rows otherwise accumulate in the walked prefix forever.  Relative to
#: the layout's own slack, so it fires only when a rebuild would densify.
COMPACT_THRESHOLD = 0.5
#: Don't bother occupancy-rebuilding images smaller than this.
COMPACT_MIN_SLOTS = 4 * 128
#: Build-time live fraction below which an image build strips the source
#: layout's slack entirely (caps == degrees, occupancy 1.0).  CP2AA
#: layouts build at ~0.65-0.7 and keep their slack; ChunkedGraph's PAGE
#: quantization builds at ~0.3 and compacts.
DENSE_THRESHOLD = 0.55

#: Module-level maintenance counters: tests and benchmarks read these to
#: prove walks do no host image work (builds) between updates, and how
#: many fused applies / walks a stream round took.
STATS = {"builds": 0, "patches": 0, "rebuilds": 0, "dispatches": 0, "seals": 0}


def stats_snapshot() -> dict:
    return dict(STATS)


def block_bounds(starts, degs, device):
    """Device int32 ``[lo, hi)`` slot intervals of rows with block
    ``starts`` and degrees ``degs``: ``[start, start + deg)``, and
    ``[0, 0)`` for a row without a block (start -1) — the bounds
    ``merge_rows_fused`` writes for the rows it merges."""
    has_block = starts >= 0
    lo = np.where(has_block, starts, 0).astype(np.int32)
    hi = np.where(has_block, starts + degs, 0).astype(np.int32)
    return torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device)


def seal_generation(rep, generation: int = 0) -> "WalkImage":
    """Seal ``rep``'s current state as an immutable walk generation (§16).

    * queueing reps (coo/lazy/chunked/vector2d): ``to_walk_image()``
      flushes or rebuilds the cached image, then :meth:`WalkImage.seal`
      shares its payload and arms the copy-on-write flag on the live image;
    * arena-backed reps (DiGraph, ``shared=True`` images): the rep's own
      per-buffer COW is the isolation — ``rep.snapshot()`` seals the arena
      buffers (the next in-place update copies only what it writes) and
      the snapshot's image wrap becomes the frozen generation.

    Reps with their own ``seal_generation`` (``ShardedGraph``: per-shard
    seals + quarantine masking, §17; ``DurableGraph``, which seals the rep
    it wraps) delegate wholesale.
    """
    own = getattr(rep, "seal_generation", None)
    if own is not None:
        return own(generation)
    img = rep.to_walk_image()
    if not img.shared:
        return img.seal(generation)
    snap = rep.snapshot()
    gen = snap.to_walk_image()
    gen.generation = int(generation)
    gen._frozen = True
    # detach from the snapshot handle: the generation must stay exactly
    # as sealed even if someone mutates the snapshot rep later.
    snap._image = None
    STATS["seals"] += 1
    return gen


def reverse_walk_via_image(rep, steps: int, *, backend: str = "auto",
                           normalize: bool = False, visits0=None):
    """The shared reverse_walk body of every image-queueing representation.

    Try the fused flush→walk on the cached image (§12); fall back to the
    eager flush-or-rebuild path (``to_walk_image``) when the image is
    absent or can only be rebuilt.
    """
    img = rep._image
    if img is not None:
        out = img.walk_flush(steps, backend=backend, normalize=normalize, visits0=visits0)
        if out is not None:
            return out
    return rep.to_walk_image(backend=backend).walk(
        steps, backend=backend, normalize=normalize, visits0=visits0)


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
    #: True when dst/wgt/rows alias the owner's own arena (DiGraph):
    #: kept current by the rep — never patched here.
    shared: bool = False
    #: occupancy as built — the densest this layout can be; the compact
    #: trigger fires relative to it (see COMPACT_THRESHOLD).
    base_occupancy: float = 1.0
    # device [lo, hi) interval cache + queued plans
    _blocks: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _pending: list = dataclasses.field(
        default_factory=list, repr=False, compare=False
    )
    #: set once the queue overflowed MAX_PENDING (or a fused walk left the
    #: occupancy below the compaction trigger): the image can only be
    #: rebuilt, so further plans are dropped instead of pinned.
    _stale: bool = dataclasses.field(default=False, repr=False, compare=False)
    #: sealed-generation id (§16); -1 on live (unsealed) images.
    generation: int = -1
    #: True on a sealed generation: read-only — ``queue`` raises and the
    #: patch engine never touches it.
    _frozen: bool = dataclasses.field(default=False, repr=False, compare=False)
    #: True while a sealed generation still shares this live image's
    #: payload: the next patch copies dst/wgt/rows before its in-place
    #: merge (per-buffer copy-on-write), then the flag clears.
    _cow: bool = dataclasses.field(default=False, repr=False, compare=False)

    @property
    def cap_e(self) -> int:
        return int(self.dst.shape[0])

    @property
    def device(self) -> torch.device:
        """The device the payload lives on (what a walk of it runs on)."""
        return self.dst.device

    @property
    def occupancy(self) -> float:
        """Live-edge fraction of the image's allocated slot prefix."""
        return self.live / max(int(self.bump), 1)

    # ------------------------------------------------------------------
    # integrity (DESIGN.md §13 — the auditor's image half)
    # ------------------------------------------------------------------
    def audit(self) -> dict:
        """Geometry + content invariant sweep; raises ``AuditError``.

        Blocks live inside the bump frontier and are pairwise disjoint,
        every live slot carries an in-range destination owned by its
        block's row and rows stay strictly ascending, slack slots are
        SENTINEL (the merge reads on it — a non-SENTINEL slack slot would
        resurrect a ghost edge on the next patch), and the per-row degrees
        account for exactly ``self.live`` edges.  The geometry is checked
        on the host (where it lives), the payload with reductions on the
        image's device.
        """
        from ..runtime import faultinject as _fi

        chk = _fi._check
        nv, bump, cap_e = int(self.nv), int(self.bump), self.cap_e
        chk(0 <= bump <= cap_e, f"bump {bump} outside [0, cap_e {cap_e}]")
        chk(
            self.starts.shape[0] >= nv
            and self.caps.shape[0] >= nv
            and self.degs.shape[0] >= nv,
            "block geometry arrays shorter than nv",
        )
        starts = np.asarray(self.starts[:nv], np.int64)
        caps = np.asarray(self.caps[:nv], np.int64)
        degs = np.asarray(self.degs[:nv], np.int64)
        chk(bool((degs >= 0).all()), "negative image degree")
        chk(bool((caps >= degs).all()), "image degree exceeds block capacity")
        blocked = caps > 0
        chk(bool((degs[~blocked] == 0).all()), "edges on a block-less row")
        chk(bool((starts[blocked] >= 0).all()), "blocked row with start < 0")
        chk(
            bool(((starts[blocked] + caps[blocked]) <= bump).all()),
            "block extends past the bump frontier",
        )
        if blocked.any():
            order = np.argsort(starts[blocked], kind="stable")
            s_b, c_b = starts[blocked][order], caps[blocked][order]
            chk(
                bool(((s_b[:-1] + c_b[:-1]) <= s_b[1:]).all()),
                "overlapping blocks",
            )
        m = int(degs.sum())
        chk(m == int(self.live), f"degree sum {m} != image live {int(self.live)}")
        n_blocks = int(blocked.sum())
        dev = self.dst.device

        def run_index(base: np.ndarray, lens: np.ndarray, total: int):
            """Slot index of each element of the runs [base, base + lens)."""
            b = torch.from_numpy(base).to(dev)
            ln = torch.from_numpy(lens).to(dev)
            shift = torch.repeat_interleave(b - (torch.cumsum(ln, 0) - ln), ln,
                                            output_size=total)
            return shift + torch.arange(total, dtype=torch.int64, device=dev), ln

        if m:
            gidx, degs_d = run_index(starts, degs, m)
            owner = torch.repeat_interleave(
                torch.arange(nv, dtype=torch.int64, device=dev), degs_d, output_size=m)
            dl, wl, rl = self.dst[gidx], self.wgt[gidx], self.rows[gidx]
            chk(not bool((dl == int(SENTINEL)).any()), "SENTINEL inside a live prefix")
            chk(bool(((dl >= 0) & (dl < nv)).all()), "image dst id out of [0, nv)")
            chk(bool((rl == owner).all()), "live slot owned by the wrong row")
            chk(bool(torch.isfinite(wl).all()), "non-finite live image weight")
            interior = owner[1:] == owner[:-1]
            chk(
                not bool((interior & (dl[1:] <= dl[:-1])).any()),
                "image row not strictly ascending",
            )
            del gidx, owner, dl, wl, rl, interior
        slack = caps - degs
        if int(slack.sum()):
            sidx, _ = run_index(starts + degs, slack, int(slack.sum()))
            chk(bool((self.dst[sidx] == int(SENTINEL)).all()), "non-SENTINEL slack slot")
        return {
            "blocks": n_blocks,
            "bump": bump,
            "slack": int(slack.sum()),
            "occupancy": self.occupancy,
        }

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
        STATS["builds"] += 1
        return cls(
            dst=dst_d, wgt=wgt_d, rows=rows_d,
            starts=starts.astype(np.int64), caps=caps.astype(np.int64),
            degs=deg.astype(np.int64), nv=nv, bump=total, live=m,
            base_occupancy=m / max(total, 1),
        )

    @classmethod
    def from_blocks(cls, dst, wgt, rows, starts, caps, degs, nv: int,
                    bump: int, live: int, *, shared: bool = False) -> "WalkImage":
        """Wrap pre-blocked device buffers (DiGraph arena, page gathers)."""
        STATS["builds"] += 1
        return cls(
            dst=dst, wgt=wgt, rows=rows,
            starts=np.asarray(starts, np.int64),
            caps=np.asarray(caps, np.int64),
            degs=np.asarray(degs, np.int64),
            nv=int(nv), bump=int(bump), live=int(live), shared=shared,
            base_occupancy=int(live) / max(int(bump), 1),
        )

    # ------------------------------------------------------------------
    # generation sealing (DESIGN.md §16 — snapshot-isolated serving)
    # ------------------------------------------------------------------
    def seal(self, generation: int = 0) -> "WalkImage":
        """Seal the current state as a read-only generation.

        O(1) on the device: the sealed image *shares* the live payload and
        copies only the host geometry.  The live image is flagged ``_cow``,
        so its next patch copies dst/wgt/rows before merging into them in
        place and the generation keeps the buffers it sealed.  Readers
        walk the generation while the writer patches the live image.

        Requires a flushed image (no queued plans, not stale);
        ``seal_generation`` flushes or rebuilds first.  Shared (arena)
        images cannot seal here: snapshot the owner rep instead.
        """
        if self.shared:
            raise ValueError("seal(): shared image — snapshot the owner rep")
        if self._pending or self._stale:
            raise ValueError("seal(): image has unflushed plans")
        gen = WalkImage(
            dst=self.dst, wgt=self.wgt, rows=self.rows,
            starts=self.starts[: self.nv].copy(),
            caps=self.caps[: self.nv].copy(),
            degs=self.degs[: self.nv].copy(),
            nv=self.nv, bump=self.bump, live=self.live,
            base_occupancy=self.base_occupancy,
            generation=int(generation), _frozen=True,
        )
        self._cow = True
        STATS["seals"] += 1
        return gen

    # ------------------------------------------------------------------
    # incremental maintenance
    # ------------------------------------------------------------------
    def queue(self, plan) -> None:
        """Record an applied UpdatePlan; the next walk flushes it.

        Past MAX_PENDING the image is only ever rebuilt, so the queue is
        dropped and the image marked stale — an update-only stream must
        not pin every plan's batch arrays until someone walks.
        """
        if self._frozen:
            raise RuntimeError(
                f"sealed walk generation {self.generation} is read-only"
            )
        if self.shared or self._stale:  # shared: the arena IS the image
            return
        self._pending.append(plan)
        if len(self._pending) > MAX_PENDING:
            self._pending.clear()
            self._stale = True

    def block_ranges(self, rows: np.ndarray) -> np.ndarray:
        """``[K, 2]`` half-open slot ranges of ``rows``'s CURRENT blocks.

        A relocated row's old slots are cleared to SENTINEL, so a caller
        tracking dirty bytes asks before AND after a patch.  Rows without
        a block contribute nothing.
        """
        rows = np.asarray(rows, np.int64)
        st = np.asarray(self.starts[rows], np.int64)
        cp = np.asarray(self.caps[rows], np.int64)
        has = (st >= 0) & (cp > 0)
        return np.stack([st[has], st[has] + cp[has]], axis=1)

    def _needs_compact(self) -> bool:
        return (
            self.bump >= COMPACT_MIN_SLOTS
            and self.occupancy < COMPACT_THRESHOLD * self.base_occupancy
        )

    def flush(self, *, backend: str = "auto") -> bool:
        """Patch all queued plans in; False = owner must rebuild.

        ``backend`` picks the merge: ``cuda`` (the kernel), ``torch`` (its
        plain version) or ``auto`` (by device).
        """
        backend = util.resolve_backend(backend, self.dst.device)
        if self._stale:
            STATS["rebuilds"] += 1
            return False
        if not self._pending:
            return True
        while self._pending:
            if not self._patch_one(self._pending[0], backend):
                STATS["rebuilds"] += 1
                return False
            self._pending.pop(0)
        # occupancy-triggered compaction: once dead slots dominate the
        # walked prefix (relative to the layout as built), one rebuild
        # beats every later walk dragging them through the step loop
        if self._needs_compact():
            STATS["rebuilds"] += 1
            return False
        return True

    # -- patch pipeline: host planning, fused apply, host commit ---------
    def _plan_patch(self, plan):
        """Host half of one plan's patch: geometry + ``fused_apply`` operands.

        Mirrors ``DiGraph._apply_impl``'s planning against the image's own
        geometry (every pow-2 width class of the plan in one call; grown
        rows land in fresh bump blocks).  Returns None when only a rebuild
        can represent the result (new vertices, or a grown row with no
        bump slack left) — every failure check precedes the one mutation
        (the bump pointer), so a failed planning pass is side-effect free.
        """
        if plan.n_ops == 0:
            return ()
        if plan.max_insert_vertex() >= self.nv:
            return None  # vertex growth changes the visits shape: rebuild
        sel, rows, deg_old, ins_count = plan.active_rows(self.degs, self.nv)
        if sel.shape[0] == 0:
            return ()
        old_caps = self.caps[rows]
        old_starts = self.starts[rows]
        ub = deg_old + ins_count
        grow = ub > old_caps
        new_caps = old_caps.copy()
        new_starts = old_starts.copy()
        if grow.any():
            need = alloc.edge_capacities(ub[grow])
            if self.bump + int(need.sum()) > self.cap_e:
                return None  # slack exhausted: a rebuild repacks densely
            g_idx = np.nonzero(grow)[0]
            new_caps[g_idx] = need
            new_starts[g_idx] = self.bump + (np.cumsum(need) - need)
            self.bump += int(need.sum())
        groups, layout, rebuild = _su_ops.patch_operands(
            plan, sel, rows, deg_old, grow, old_starts, old_caps, new_starts, new_caps,
            cap_e=self.cap_e, bump=self.bump, cap_v=self.nv, device=self.device,
        )
        return dict(rows=rows, deg_old=deg_old, grow=grow, new_caps=new_caps,
                    new_starts=new_starts, groups=groups, layout=layout, rebuild=rebuild)

    def _detach_generation(self) -> None:
        """Copy the payload a sealed generation still shares, before the
        in-place merge writes into it."""
        if self._cow:
            self.dst, self.wgt, self.rows = util.fused_copy(self.dst, self.wgt, self.rows)
            self._cow = False

    def _launch(self, prep, backend: str, lo=None, hi=None):
        """Launch one planned patch: one ``fused_apply``, all groups, in
        place."""
        self._detach_generation()
        applied = _su_ops.fused_apply(self.dst, self.wgt, self.rows, prep["groups"],
                                      backend=backend, lo=lo, hi=hi, rebuild=prep["rebuild"])
        STATS["dispatches"] += 1
        return applied

    def _commit_patch(self, prep, counts_list) -> None:
        """Install the post-apply geometry (degrees, moved blocks)."""
        rows = prep["rows"]
        self.live += _su_ops.install_counts(self.degs, rows, prep["deg_old"], prep["layout"],
                                            counts_list)
        if prep["grow"].any():
            self.starts[rows] = prep["new_starts"]
            self.caps[rows] = prep["new_caps"]
        self._blocks = None
        STATS["patches"] += 1

    def _patch_one(self, plan, backend: str) -> bool:
        """Apply one plan to the image: one ``fused_apply``, all groups."""
        prep = self._plan_patch(plan)
        if prep is None:
            return False
        if prep != ():
            self._commit_patch(prep, self._launch(prep, backend).counts())
        return True

    # ------------------------------------------------------------------
    # walking
    # ------------------------------------------------------------------
    def edges_hi(self) -> int:
        """Bump prefix bound, quantized to cap_e/8 (<= 8 sizes per capacity)."""
        return alloc.quantized_prefix(self.cap_e, self.bump)

    def device_blocks(self):
        """Device [lo, hi) interval tensors, memoized until the next update."""
        if self._blocks is None:
            self._blocks = block_bounds(self.starts[: self.nv], self.degs[: self.nv],
                                        self.dst.device)
        return self._blocks

    def walk(self, steps: int, *, backend: str = "auto",
             normalize: bool = False, visits0=None) -> torch.Tensor:
        """k-step reverse walk over the image via the slot_walk engine.

        ``visits0`` may be a ``[B, num_vertices]`` stack of initial visit
        vectors — all B walks then share each step.  Assumes the image is
        flushed (owners call ``walk_flush`` or ``to_walk_image()`` first).
        """
        STATS["dispatches"] += 1
        return _sw_ops.slot_walk_image(
            self, steps, backend=backend, normalize=normalize, visits0=visits0,
        )

    def walk_flush(self, steps: int, *, backend: str = "auto",
                   normalize: bool = False, visits0=None) -> Optional[torch.Tensor]:
        """Flush queued plans AND walk, with one host wait (§12).

        The steady-state stream round (one queued plan, then a walk) is
        one ``fused_apply`` with the walk queued behind it: the plan's
        merge launches refresh the [lo, hi) geometry on the device from
        their counts, the k walk steps are queued behind them on the
        patched buffers and refreshed bounds, and only then does the host
        wait, for the counts.  The walk fires no ``slot_walk`` fault
        point, as in ``repro``.  Deeper queues patch all but the last plan
        first (one apply each).  Returns None when the image can only be
        rebuilt — the owner falls back to ``to_walk_image().walk(...)``
        (rebuild accounting happens there, in ``flush``; a failed planning
        pass here is side-effect free).
        """
        dev = self.dst.device
        backend = util.resolve_backend(backend, dev)
        if self.shared or self._stale:
            return None if self._stale else self.walk(
                steps, backend=backend, normalize=normalize, visits0=visits0,
            )
        if visits0 is not None:
            if visits0.ndim != 2 or visits0.shape[1] != self.nv:
                raise ValueError(
                    "visits0 must be [num_walks, num_vertices], got "
                    f"{tuple(visits0.shape)}"
                )
            visits0 = torch.as_tensor(visits0, dtype=torch.float32, device=dev)
        while len(self._pending) > 1:
            if not self._patch_one(self._pending[0], backend):
                return None
            self._pending.pop(0)
        if not self._pending:
            return self.walk(
                steps, backend=backend, normalize=normalize, visits0=visits0,
            )
        prep = self._plan_patch(self._pending[0])
        if prep is None:
            return None
        if prep == ():
            self._pending.pop(0)
            return self.walk(
                steps, backend=backend, normalize=normalize, visits0=visits0,
            )
        applied = self._launch(prep, backend, *self.device_blocks())
        v0 = (visits0 if visits0 is not None
              else torch.ones((1, self.nv), dtype=torch.float32, device=dev))
        visits = _sw_ops.slot_walk_multi_blocked(
            self.dst, applied.lo, applied.hi, v0, steps, self.nv,
            edges_hi=self.edges_hi(), normalize=bool(normalize), backend=backend)
        self._pending.pop(0)
        self._commit_patch(prep, applied.counts())
        self._blocks = (applied.lo, applied.hi)  # refreshed on the device, reusable
        if self._needs_compact():
            # this walk already ran on the sparse image; make the NEXT
            # access rebuild densely instead of patching further
            self._stale = True
        return visits if visits0 is not None else visits[0]
