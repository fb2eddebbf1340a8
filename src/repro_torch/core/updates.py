"""UpdatePlan — the shared host planning layer for batch updates (DESIGN.md §9).

Every representation's ``add_edges`` / ``remove_edges`` / ``apply`` funnels
through one plan object so the host-side work of a batch update — sorting,
in-batch dedup, per-row run splitting (one ``np.unique`` pass), padded
device operand layout — happens exactly once per batch, no matter how many
structures consume it or how many times a stream replays it:

  * **Canonical op stream**: ``(src, dst)``-sorted ops, at most one op per
    edge key.  In a *mixed* plan an insert wins over a delete of the same
    key (delete-then-insert ≡ replace), so ``apply`` is deterministic.
  * **Per-row runs**: ``rows / run_first / run_count / ins_count`` from a
    single ``np.unique`` pass, plus ``[R, K]`` padded run matrices
    (``K`` = pow-2 of the longest run) — the operand layout of the fused
    ``kernels/slot_update`` device pass.
  * **Pow-2 padding everywhere** so repeated batch shapes hit the same
    compiled programs (the CP2AA shape policy, ``core/alloc.py``).
  * **Plan cache**: plans are memoized per source-batch identity, so a
    steady-state stream that reapplies the same ``EdgeBatch`` (or applies
    one batch to several representations) skips host planning entirely.

Plans are graph-independent: grow/compact decisions are made by each
representation against its own metadata at apply time.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Optional

import numpy as np

from . import alloc, edgebatch, util

SENTINEL = util.SENTINEL


def next_pow2_vec(x: np.ndarray) -> np.ndarray:
    """Vectorized ``alloc.next_pow2`` (exact for values < 2**52)."""
    x = np.maximum(np.asarray(x, dtype=np.int64), 1)
    return (2 ** np.ceil(np.log2(x)).astype(np.int64)).astype(np.int64)


@dataclasses.dataclass
class UpdatePlan:
    """One canonicalized batch of mixed edge updates, device-operand ready."""

    # canonical op stream (host, sorted by (src, dst); one op per key)
    q_src: np.ndarray  # int32 [Q]
    q_dst: np.ndarray  # int32 [Q]
    q_wgt: np.ndarray  # float32 [Q]
    q_del: np.ndarray  # bool [Q]  (True = delete op)
    # per-row run structure (one np.unique pass)
    rows: np.ndarray       # int64 [R] unique touched rows, ascending
    run_first: np.ndarray  # int64 [R] first op index of each row's run
    run_count: np.ndarray  # int64 [R] ops per row
    ins_count: np.ndarray  # int64 [R] insert ops per row
    #: pow-2 of the longest run — the K ceiling for run_tiles()
    run_width: int = 1
    # memoized derived views
    _ins_batch: Optional[edgebatch.EdgeBatch] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _del_batch: Optional[edgebatch.EdgeBatch] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _validated: bool = dataclasses.field(default=False, repr=False, compare=False)

    # ------------------------------------------------------------------
    @property
    def n_ops(self) -> int:
        return int(self.q_src.shape[0])

    @property
    def n_ins(self) -> int:
        return int(self.n_ops - self.q_del.sum())

    @property
    def n_del(self) -> int:
        return int(self.q_del.sum())

    @property
    def n_rows(self) -> int:
        return int(self.rows.shape[0])

    @property
    def del_count(self) -> np.ndarray:
        return self.run_count - self.ins_count

    def run_tiles(self, sel: np.ndarray, k: int, a_pad: Optional[int] = None):
        """Padded [A, k] run matrices for the plan rows indexed by ``sel``.

        Built on demand per width group, so a skewed batch (one hub run
        next to thousands of single-op rows) never materializes a dense
        [R, max_run] matrix — each group only pays its own rows at its
        own run width.  ``k`` must cover every selected run; rows pad to
        ``a_pad`` (SENTINEL / 0).  Returns (b_dst, b_wgt, b_del).
        """
        n = int(sel.shape[0])
        a = int(a_pad) if a_pad is not None else n
        bd = np.full((a, k), SENTINEL, np.int32)
        bw = np.zeros((a, k), np.float32)
        bl = np.zeros((a, k), np.int32)
        rc = self.run_count[sel]
        if n == 0 or int(rc.max(initial=0)) == 0:
            return bd, bw, bl
        assert int(rc.max()) <= k, "run width k too small for selected rows"
        q = int(rc.sum())
        rowi = np.repeat(np.arange(n, dtype=np.int64), rc)
        col = np.arange(q, dtype=np.int64) - np.repeat(np.cumsum(rc) - rc, rc)
        src = np.repeat(self.run_first[sel], rc) + col
        bd[rowi, col] = self.q_dst[src]
        bw[rowi, col] = self.q_wgt[src]
        bl[rowi, col] = self.q_del[src].astype(np.int32)
        return bd, bw, bl

    def validate(self, num_vertices: Optional[int] = None) -> "UpdatePlan":
        """Boundary validation at ``apply()`` time (DESIGN.md §13).

        Every representation calls this before touching its arrays, so a
        corrupt plan — typically a damaged WAL record surviving its CRC by
        construction rather than by luck — fails loudly instead of
        poisoning the arena: negative vertex ids and non-finite insert
        weights raise ``ValueError``.  With ``num_vertices`` (the WAL
        record's vertex watermark on replay) insert ids must also stay
        below the bound; out-of-range *deletes* remain silently filtered
        downstream (``rows_in_range``), as always.  The unconditional
        checks are memoized per plan, so a cached plan replayed across a
        stream or across representations pays them once.
        """
        if not self._validated:
            if self.q_src.shape[0]:
                for name, arr in (("q_src", self.q_src), ("q_dst", self.q_dst)):
                    neg = arr < 0
                    if bool(neg.any()):
                        raise ValueError(
                            f"UpdatePlan: negative vertex ids in {name} at "
                            f"{edgebatch._offending(neg)}: "
                            f"{arr[neg][:5].astype(np.int64).tolist()}"
                        )
                ins = ~self.q_del
                bad = ins & ~np.isfinite(self.q_wgt)
                if bool(bad.any()):
                    raise ValueError(
                        f"UpdatePlan: non-finite insert weights in q_wgt at "
                        f"{edgebatch._offending(bad)}: "
                        f"{self.q_wgt[bad][:5].tolist()}"
                    )
            self._validated = True
        if num_vertices is not None:
            mx = self.max_insert_vertex()
            if mx >= int(num_vertices):
                raise ValueError(
                    f"UpdatePlan: insert vertex id {mx} >= bound {int(num_vertices)}"
                )
        return self

    def max_insert_vertex(self) -> int:
        """Largest vertex id an insert op touches (-1 when insert-free)."""
        ins = ~self.q_del
        if not ins.any():
            return -1
        return int(
            max(self.q_src[ins].max(), self.q_dst[ins].max())
        )

    # -- split views (for representations without a fused mixed path) ----
    def insert_arrays(self):
        """(src, dst, wgt) of the insert ops, (src, dst)-sorted."""
        ins = ~self.q_del
        return self.q_src[ins], self.q_dst[ins], self.q_wgt[ins]

    def delete_arrays(self):
        """(src, dst) of the delete ops, (src, dst)-sorted."""
        dl = self.q_del
        return self.q_src[dl], self.q_dst[dl]

    def insert_batch(self) -> edgebatch.EdgeBatch:
        """Insert ops as a pow-2 padded EdgeBatch (memoized)."""
        if self._ins_batch is None:
            s, d, w = self.insert_arrays()
            self._ins_batch = edgebatch.from_arrays(s, d, w, dedup=False)
        return self._ins_batch

    def delete_batch(self) -> edgebatch.EdgeBatch:
        """Delete ops as a pow-2 padded EdgeBatch (memoized)."""
        if self._del_batch is None:
            s, d = self.delete_arrays()
            self._del_batch = edgebatch.from_arrays(s, d, dedup=False)
        return self._del_batch

    # -- shared row filtering (all representations) ----------------------
    def active_rows(self, degrees: np.ndarray, cap_v: int):
        """Dirty-row export: the plan rows that can affect a structure.

        Given the consumer's per-vertex ``degrees`` (and ``cap_v`` vertex
        slots), drops out-of-range rows and inert runs (delete-only runs
        at empty rows), returning ``(sel, rows, deg_old, ins_count)``
        aligned on the surviving rows.  ``sel`` indexes back into the
        plan's run structure (``run_tiles(sel[...], ...)``).  This is the
        shared head of every patch loop — the DiGraph arena update and
        the walk-image maintenance engine both start here.
        """
        sel = np.nonzero(self.rows_in_range(cap_v))[0]
        deg_old = degrees[self.rows[sel]]
        ins_count = self.ins_count[sel]
        act = (deg_old > 0) | (ins_count > 0)
        sel = sel[act]
        return sel, self.rows[sel], deg_old[act], ins_count[act]

    def width_groups(self, sel: np.ndarray, new_caps: np.ndarray, floor: int):
        """Iterate the plan rows ``sel`` by pow-2 width class.

        The operand layout of one fused ``kernels/slot_update`` dispatch
        per group, shared by every patch loop (DiGraph's arena update
        and the walk-image maintenance engine) so the jit-shape lattice
        — width class floored at the backend's, row-count pad ``a_pad``
        (pow-2, floor 16), run width ``k`` (pow-2 of the group's longest
        run, floor 4) — has a single definition.  Yields
        ``(width, gsel, a_pad, pad1, b_dst, b_wgt, b_del)`` with
        ``gsel`` indexing into ``sel``/``new_caps`` and ``pad1`` the
        group's [A]-operand padder.
        """
        wclass = np.maximum(next_pow2_vec(new_caps), floor)
        for wv in np.unique(wclass):
            gsel = np.nonzero(wclass == wv)[0]
            n = gsel.shape[0]
            # floors keep the (width, A, K) jit-shape lattice coarse, so
            # a stream of varying batches stops compiling after a few
            # rounds; wide classes floor lower — 15 pad rows of a
            # 1024-slot class are 15k dead merge lanes, and hub classes
            # rarely hold more than a handful of rows per batch
            a_pad = max(alloc.next_pow2(n), 4 if int(wv) >= 256 else 16)

            def pad1(a, fill, dtype=np.int32, *, _n=n, _a=a_pad):
                out = np.full(_a, fill, dtype)
                out[:_n] = a
                return out

            # the group's own run width: short runs shouldn't pay a hub
            # row's padding (K floored at 4 for jit-shape coarseness)
            k = max(alloc.next_pow2(int(self.run_count[sel[gsel]].max())), 4)
            bd, bw, bl = self.run_tiles(sel[gsel], k, a_pad)
            yield int(wv), gsel, a_pad, pad1, bd, bw, bl

    def fused_groups(self, sel, rows, deg_old, grow,
                     old_starts, old_caps, new_starts, new_caps,
                     floor: int, row_pad: int):
        """Packed per-group operands of one ``fused_apply`` dispatch (§12).

        The single definition of the fused engine's group contract —
        ``(width, a_pad, k, d_k, moves, (row_ops [6, A], b_dstdel
        [2, A, K], b_wgt [A, K]))`` — built for the DiGraph arena and the
        walk image alike through ``slot_update.ops.patch_operands``.
        ``row_pad`` fills pad rows' ids (the consumer's drop bound);
        ``d_k`` is the group's pow-2 delete-run ceiling (the merge's
        hole-compaction window).  Returns ``(groups, layout)`` with
        ``layout = [(width, gsel, a_pad), ...]`` for the counts commit
        and the host slot map.
        """
        groups, layout = [], []
        for wv, gsel, a_pad, pad1, bd, bw, bl in self.width_groups(
            sel, new_caps, floor
        ):
            ops3 = (
                np.stack([
                    pad1(old_starts[gsel], -1),
                    pad1(old_caps[gsel], 0),
                    pad1(new_starts[gsel], -1),
                    pad1(new_caps[gsel], 0),
                    pad1(deg_old[gsel], 0),
                    pad1(rows[gsel], row_pad),
                ]),
                np.stack([bd, bl]),
                bw,
            )
            dmax = int(self.del_count[sel[gsel]].max(initial=0))
            d_k = alloc.next_pow2(dmax) if dmax else 0
            groups.append(
                (int(wv), a_pad, bd.shape[1], d_k,
                 bool(grow[gsel].any()), ops3)
            )
            layout.append((int(wv), gsel, a_pad))
        return groups, layout

    def rows_in_range(self, cap_v: int) -> np.ndarray:
        """Mask of plan rows a graph with ``cap_v`` vertex slots can touch.

        Insert rows are expected to be reserved by the caller first, so
        after reservation this only drops delete-only runs aimed at rows
        the graph has never seen — the out-of-range filter every
        representation shares (previously each delete path hand-rolled
        its own).
        """
        return self.rows < cap_v

    def touched_rows(self, cap_v: int) -> np.ndarray:
        """In-range rows this plan can modify — the WAL-window dirty-row
        export the §15 differential checkpointer accumulates.

        A conservative superset of :meth:`active_rows` (inert delete-only
        runs are kept; they cannot change state, so over-marking them
        dirty costs a few redundant chunks, never correctness) that needs
        no degree array — callable before OR after the apply.
        """
        return self.rows[self.rows_in_range(cap_v)]


# ---------------------------------------------------------------------------
# plan construction
# ---------------------------------------------------------------------------
def _empty_plan() -> UpdatePlan:
    return UpdatePlan(
        q_src=np.empty(0, np.int32),
        q_dst=np.empty(0, np.int32),
        q_wgt=np.empty(0, np.float32),
        q_del=np.empty(0, bool),
        rows=np.empty(0, np.int64),
        run_first=np.empty(0, np.int64),
        run_count=np.empty(0, np.int64),
        ins_count=np.empty(0, np.int64),
    )


def _pair_keys(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """(src, dst) -> sortable int64 key (ids are validated non-negative)."""
    return (src.astype(np.int64) << 32) | dst.astype(np.int64)


def _canonicalize(src, dst, *values):
    """Enforce (src, dst)-sorted unique keys, O(B) when already true.

    EdgeBatches from ``from_arrays`` are already canonical, so the hot
    path is a strictly-increasing-keys check; only ``dedup=False``
    batches with duplicate or unsorted keys pay the full re-sort.
    """
    keys = _pair_keys(src, dst)
    if keys.shape[0] < 2 or bool(np.all(keys[1:] > keys[:-1])):
        return (src, dst, *values)
    return edgebatch.dedup_arrays(src, dst, *values, keep="first")


def _build_plan(
    inserts: Optional[edgebatch.EdgeBatch],
    deletes: Optional[edgebatch.EdgeBatch],
) -> UpdatePlan:
    ins_s, ins_d, ins_w = (
        inserts.to_numpy() if inserts is not None else (None, None, None)
    )
    del_s, del_d, _ = deletes.to_numpy() if deletes is not None else (None, None, None)

    # enforce the one-op-per-key invariant every consumer relies on —
    # EdgeBatches are normally pre-deduped (O(B) check), but dedup=False
    # batches must not smuggle duplicate keys into the merge kernels.
    if ins_s is not None and ins_s.shape[0]:
        ins_s, ins_d, ins_w = _canonicalize(ins_s, ins_d, ins_w)
    if del_s is not None and del_s.shape[0]:
        del_s, del_d = _canonicalize(del_s, del_d)

    if del_s is not None and del_s.shape[0] and ins_s is not None and ins_s.shape[0]:
        # cross-batch dedup: an insert wins over a delete of the same key
        # (delete-then-insert ≡ replace), so conflicting deletes drop out.
        ins_keys = _pair_keys(ins_s, ins_d)
        del_keys = _pair_keys(del_s, del_d)
        pos = np.searchsorted(ins_keys, del_keys)
        pos_c = np.minimum(pos, ins_keys.shape[0] - 1)
        clash = (pos < ins_keys.shape[0]) & (ins_keys[pos_c] == del_keys)
        del_s, del_d = del_s[~clash], del_d[~clash]

    parts_s, parts_d, parts_w, parts_del = [], [], [], []
    if ins_s is not None and ins_s.shape[0]:
        parts_s.append(ins_s)
        parts_d.append(ins_d)
        parts_w.append(ins_w)
        parts_del.append(np.zeros(ins_s.shape[0], bool))
    if del_s is not None and del_s.shape[0]:
        parts_s.append(del_s)
        parts_d.append(del_d)
        parts_w.append(np.zeros(del_s.shape[0], np.float32))
        parts_del.append(np.ones(del_s.shape[0], bool))
    if not parts_s:
        return _empty_plan()

    q_src = np.concatenate(parts_s)
    q_dst = np.concatenate(parts_d)
    q_wgt = np.concatenate(parts_w).astype(np.float32)
    q_del = np.concatenate(parts_del)
    # both sides are individually (src, dst)-sorted and their keys are now
    # disjoint, so one stable argsort over the merged keys canonicalizes.
    if len(parts_s) > 1:
        order = np.argsort(_pair_keys(q_src, q_dst), kind="stable")
        q_src, q_dst, q_wgt, q_del = (
            q_src[order], q_dst[order], q_wgt[order], q_del[order]
        )

    # per-row runs: the single np.unique pass shared by insert and delete
    rows, run_first, run_count = np.unique(
        q_src, return_index=True, return_counts=True
    )
    rows = rows.astype(np.int64)
    run_first = run_first.astype(np.int64)
    run_count = run_count.astype(np.int64)
    ins_count = np.add.reduceat((~q_del).astype(np.int64), run_first)
    k = int(next_pow2_vec(run_count.max())[()]) if rows.shape[0] else 1

    return UpdatePlan(
        q_src=q_src,
        q_dst=q_dst,
        q_wgt=q_wgt,
        q_del=q_del,
        rows=rows,
        run_first=run_first,
        run_count=run_count,
        ins_count=ins_count,
        run_width=k,
    )


def plan_from_canonical(q_src, q_dst, q_wgt, q_del) -> UpdatePlan:
    """Rebuild an UpdatePlan from its canonical op stream (WAL replay path).

    The journal persists exactly the four canonical arrays; everything else
    (runs, widths) is derived state, recomputed here with the same
    ``np.unique`` pass ``_build_plan`` uses — so a replayed plan drives
    ``apply`` through byte-identical operands.  The stream must already be
    canonical: (src, dst)-sorted with strictly increasing keys, negative
    ids rejected.  Value-level validation (finite weights, vertex bounds)
    stays in :meth:`UpdatePlan.validate`, which replay calls with the
    record's vertex watermark.
    """
    q_src = np.ascontiguousarray(q_src, np.int32)
    q_dst = np.ascontiguousarray(q_dst, np.int32)
    q_wgt = np.ascontiguousarray(q_wgt, np.float32)
    q_del = np.ascontiguousarray(q_del, bool)
    n = q_src.shape[0]
    if not (q_dst.shape[0] == q_wgt.shape[0] == q_del.shape[0] == n):
        raise ValueError("plan_from_canonical: op stream arrays disagree on length")
    if n == 0:
        return _empty_plan()
    if int(q_src.min()) < 0 or int(q_dst.min()) < 0:
        raise ValueError("plan_from_canonical: negative vertex id")
    keys = _pair_keys(q_src, q_dst)
    if n >= 2 and not bool(np.all(keys[1:] > keys[:-1])):
        raise ValueError("plan_from_canonical: op stream not (src, dst)-sorted unique")

    rows, run_first, run_count = np.unique(
        q_src, return_index=True, return_counts=True
    )
    rows = rows.astype(np.int64)
    run_first = run_first.astype(np.int64)
    run_count = run_count.astype(np.int64)
    ins_count = np.add.reduceat((~q_del).astype(np.int64), run_first)
    k = int(next_pow2_vec(run_count.max())[()])
    return UpdatePlan(
        q_src=q_src,
        q_dst=q_dst,
        q_wgt=q_wgt,
        q_del=q_del,
        rows=rows,
        run_first=run_first,
        run_count=run_count,
        ins_count=ins_count,
        run_width=k,
    )


# ---------------------------------------------------------------------------
# plan cache — steady-state streams skip host planning entirely
# ---------------------------------------------------------------------------
_CACHE_SIZE = 32
_cache: "collections.OrderedDict[tuple[int, int], tuple]" = collections.OrderedDict()


def _ref(obj):
    if obj is None:
        return lambda: None
    return weakref.ref(obj)


def plan_update(
    inserts: Optional[edgebatch.EdgeBatch] = None,
    deletes: Optional[edgebatch.EdgeBatch] = None,
) -> UpdatePlan:
    """Build (or recall) the UpdatePlan for an insert/delete batch pair.

    Plans are memoized by batch identity: reapplying the same
    ``EdgeBatch`` objects — a replayed stream round, or one batch applied
    to all five representations — returns the cached plan with zero host
    work.  Identity is verified through weakrefs, so a recycled ``id()``
    can never alias a dead batch.
    """
    key = (id(inserts), id(deletes))
    hit = _cache.get(key)
    if hit is not None and hit[0]() is inserts and hit[1]() is deletes:
        _cache.move_to_end(key)
        return hit[2]
    plan = _build_plan(inserts, deletes)
    _cache[key] = (_ref(inserts), _ref(deletes), plan)
    while len(_cache) > _CACHE_SIZE:
        _cache.popitem(last=False)
    return plan


def plan_cache_clear() -> None:
    _cache.clear()
