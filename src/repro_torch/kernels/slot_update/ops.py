"""Fused plan apply: every width group of an UpdatePlan in one call.

``patch_operands`` turns a plan whose rows a representation has placed
(old and new blocks) into what ``fused_apply`` takes: the packed width
groups and, where ``choose_scatter`` picks it, the host map of the rebuild
write-back.  ``fused_apply`` launches the merges (DESIGN.md §9/§12).  On
the card (``backend="cuda"``) each width group is one ``merge_rows_fused``
launch that reads the touched rows' live prefixes from the arena, merges
the sorted batch runs into them (deletes, weight upserts, ranked inserts)
and writes them back in place: grown rows land in their NEW block while
their old block is SENTINEL-filled, and the walk image's [lo, hi) bounds
are refreshed from the counts in the same launch.  The plain version
(``backend="torch"``) runs the same loop, one ``merge_rows_fused_torch`` a
group, unless the caller passes the rebuild operands: then it keeps
``repro``'s formulation, which gathers and merges every group against the
buffers as they were, then rebuilds the quantized bump prefix from the
host map (a vacated slot gets weight 0 and owner ``cap_v`` there).

The caller owns ``dst``/``wgt``/``slot_rows`` (a DiGraph detaches
snapshot-shared buffers first, a walk image copies what a sealed
generation shares).  ``fused_apply`` waits for nothing: the merge counts
come back to the host through one copy, in ``Applied.counts()``, the only
host synchronisation of the CUDA path.  A walk image queues its walk on the
refreshed bounds before it asks (``WalkImage.walk_flush``);
``install_counts`` writes them into the caller's degrees.

While the profiler runs, ``counts()`` counts each group's merge
(``group_counters``, from the host operands) once the counts are back, in
a span of its own, ``slot_update.count``, outside ``slot_update.pack`` and
``slot_update.wait``; with the profiler off no counter is computed.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import alloc, util
from ...runtime import faultinject, trace
from . import kernel as _kernel

SENTINEL = int(util.SENTINEL)
#: Off-GPU write-back dispatch: arenas up to this many slots always use
#: the full-buffer gather rebuild; beyond it, batches touching < 1/10 of
#: the arena switch to per-group scatters so small updates stay O(batch).
REBUILD_MAX_CAP = 1 << 21
#: Row-group width floors.  Off the GPU rows group by their exact pow-2
#: capacity class (floor 8, as ``repro`` does off-TPU); on the GPU the
#: floor is one warp, so the smallest classes share one merge launch.
HOST_FLOOR = 8
GPU_FLOOR = 32
#: The CUDA path's pinned host staging buffer, reused by every call and
#: grown (at least doubled) only when a plan's operands outgrow it, so a
#: stream of batches pays the pinned allocation once or twice, not a call.
#: A call takes it out and ``counts()`` puts it back after the counts copy,
#: when the call's own copy to the card has finished.
_STAGE: dict = {}


def width_floor(device: torch.device) -> int:
    """Row-group width floor for buffers on ``device`` (padding only)."""
    return GPU_FLOOR if device.type == "cuda" else HOST_FLOOR


def choose_scatter(cap_e: int, touched: int, device: torch.device) -> bool:
    """Write-back dispatch: per-group scatters on the GPU (which does them
    well) and for a tiny batch on a huge host arena; otherwise one
    full-buffer gather rebuild."""
    if device.type == "cuda":
        return True
    return cap_e > REBUILD_MAX_CAP and touched * 10 < cap_e


def host_patch_layout(layout, rows, old_starts, old_caps, new_starts,
                      new_caps, grow, map_hi: int, cap_v: int,
                      has_moves: bool):
    """Host-built rebuild operands for the gather write-back.

    ``layout`` is [(width, gsel, a_pad), ...] in group-iteration order —
    merged group g's rows occupy consecutive [a_pad, width] regions of
    the concatenated patch stream.  ``slot_map[map_hi]`` holds -1 for
    untouched slots, a patch index for slots of a touched row's (possibly
    new) block, and the trailing SENTINEL slot for vacated old blocks.
    """
    patch_base = np.zeros(rows.shape[0], np.int64)
    base = 0
    for wv, gsel, a_pad in layout:
        patch_base[gsel] = base + np.arange(gsel.shape[0], dtype=np.int64) * int(wv)
        base += int(a_pad) * int(wv)
    slot_map = np.full(map_hi, -1, np.int32)
    if has_moves:  # vacated blocks clear via the trailing patch slot
        mv = np.nonzero(grow & (old_starts >= 0) & (old_caps > 0))[0]
        oc = old_caps[mv]
        intra = np.arange(int(oc.sum()), dtype=np.int64) - np.repeat(
            np.cumsum(oc) - oc, oc
        )
        slot_map[np.repeat(old_starts[mv], oc) + intra] = base
    intra = np.arange(int(new_caps.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(new_caps) - new_caps, new_caps
    )
    arena_idx = np.repeat(new_starts, new_caps) + intra
    slot_map[arena_idx] = np.repeat(patch_base, new_caps) + intra
    if has_moves:
        owner_patch = np.full(base + 1, cap_v, np.int32)
        owner_patch[np.repeat(patch_base, new_caps) + intra] = np.repeat(
            rows, new_caps
        )
    else:
        owner_patch = np.zeros(1, np.int32)
    return slot_map, owner_patch


def patch_operands(plan, sel, rows, deg_old, grow, old_starts, old_caps,
                   new_starts, new_caps, *, cap_e: int, bump: int, cap_v: int,
                   device: torch.device):
    """What ``fused_apply`` needs for one plan whose rows are placed.

    The arrays are ``plan.active_rows``'s rows with their grow flags and
    their old and new blocks, as the caller's allocator placed them;
    ``bump`` is its bump pointer after the placement, ``cap_v`` the drop
    bound of pad rows.  Returns ``(groups, layout, rebuild)``:
    ``plan.fused_groups``'s width groups and layout, and ``rebuild`` None
    for the in-place write-back or, where ``choose_scatter`` picks the
    host-mapped rebuild (off the card only), ``host_patch_layout``'s
    ``(slot_map, owner_patch)`` over the quantized bump prefix, so the
    SENTINEL tail past the bump pointer is never re-read.
    """
    groups, layout = plan.fused_groups(
        sel, rows, deg_old, grow, old_starts, old_caps, new_starts, new_caps,
        width_floor(device), cap_v,
    )
    touched = int(new_caps.sum() + old_caps[grow].sum())
    if choose_scatter(cap_e, touched, device):
        return groups, layout, None
    return groups, layout, host_patch_layout(
        layout, rows, old_starts, old_caps, new_starts, new_caps, grow,
        alloc.quantized_prefix(cap_e, bump), cap_v, bool(grow.any()),
    )


def install_counts(degrees, rows, deg_old, layout, counts_list) -> int:
    """Write each group's merge counts into ``degrees[rows]`` (pad rows
    dropped); returns the net edge change."""
    net = 0
    for (_wv, gsel, _a), counts in zip(layout, counts_list):
        counts = np.asarray(counts, dtype=np.int64)[: gsel.shape[0]]
        degrees[rows[gsel]] = counts
        net += int(counts.sum() - deg_old[gsel].sum())
    return net


class Applied:
    """The merges one ``fused_apply`` launched.

    ``lo``/``hi`` are the refreshed [lo, hi) bounds (new tensors, written
    by the merges), or None when the call was given none.  ``counts()``
    brings the merge counts to the host.
    """

    def __init__(self, groups, device_counts, stage, lo, hi, backend: str):
        self.lo, self.hi = lo, hi
        self._groups, self._device_counts = groups, device_counts
        self._stage, self._backend = stage, backend
        self._counts = None

    def counts(self) -> list:
        """The merge counts of each group, [a_pad] int32 on the host.

        The first call makes the one device→host copy (``slot_update.wait``),
        puts the staging buffer back and, under the profiler, records the
        groups' counters (``slot_update.count``); later calls return the
        same list.
        """
        if self._counts is not None:
            return self._counts
        with trace.span("slot_update.wait"):
            counts_cat = (util.host(torch.cat(self._device_counts)) if self._device_counts
                          else np.zeros(0, np.int32))
        if self._stage is not None:  # the operands' copy went before the counts'
            _STAGE["buf"] = self._stage
            self._stage = None
        if trace.recording():
            with trace.span("slot_update.count"):
                for g in self._groups:
                    scratch = _kernel.scratch_bytes(*g[:3]) if self._backend == "cuda" else 0
                    trace.count(**group_counters(g, self.lo is not None, scratch))
        self._counts, at = [], 0
        for g in self._groups:
            self._counts.append(counts_cat[at:at + g[1]])
            at += g[1]
        self._device_counts = None
        return self._counts


def fused_apply(dst, wgt, slot_rows, groups, *, backend: str = "auto",
                lo=None, hi=None, rebuild=None) -> Applied:
    """Launch the merges of EVERY width group of a plan, in place.

    ``groups`` is ``[(width, a_pad, k, d_k, moves, operands), ...]`` with
    ``operands`` the packed 3-tuple ``(row_ops [6, A] int32 =
    old_starts/old_caps/new_starts/new_caps/degs/row_ids, b_dstdel
    [2, A, K] int32, b_wgt [A, K] f32)`` (numpy: one transfer each) and
    ``d_k`` the group's (pow-2) delete-run ceiling.  ``rebuild`` is None
    for the in-place write-back, one merge a group in group order, or the
    ``(slot_map, owner_patch)`` pair of ``host_patch_layout`` for the
    plain rebuild (``patch_operands`` picks).  ``lo``/``hi`` (the int32
    [lo, hi) interval cache of a walk image) are refreshed from the merge
    counts into new tensors.

    The fault point ``slot_update.<backend>`` fires once, before the one
    attempt and before any operand is touched; an injected failure raises
    to the caller (no retry, no other backend).

    Returns an ``Applied`` without waiting for the device.
    """
    backend = util.resolve_backend(backend, dst.device)
    faultinject.fire(f"slot_update.{backend}")
    if lo is not None and hi is not None:
        lo, hi = lo.clone(), hi.clone()
    else:
        lo = hi = None
    with trace.span("slot_update.pack"):
        if rebuild is None:
            counts_all, stage = _merge_in_place(dst, wgt, slot_rows, groups, lo, hi, backend)
        else:
            counts_all, stage = _merge_rebuild(dst, wgt, slot_rows, groups, lo, hi, *rebuild), None
    return Applied(groups, counts_all, stage, lo, hi, backend)


def group_counters(group, lohi: bool, scratch: int = 0) -> dict:
    """Counters of one width group's merge, from its host operands: its
    real rows (pad rows carry ``new_starts`` -1), their run entries (not
    SENTINEL), live degrees and new capacities, the new and old
    capacities of the rows that move (``new_starts`` != ``old_starts``),
    whether ``[lo, hi)`` is written, and the scratch bytes its launch
    allocates."""
    width, _a_pad, _k, _d_k, _moves, (row_ops, bdl, _bw) = group
    old_starts, old_caps, new_starts, new_caps, degs, _ids = np.asarray(row_ops, np.int64)
    real = new_starts >= 0
    moved = real & (new_starts != old_starts)
    return {"width": int(width), "rows": int(real.sum()),
            "entries": int((np.asarray(bdl)[0][real] != SENTINEL).sum()),
            "live": int(degs[real].sum()), "new_cap": int(new_caps[real].sum()),
            "moved_new_cap": int(new_caps[moved].sum()),
            "moved_old_cap": int(old_caps[moved].sum()),
            "lohi": bool(lohi), "scratch_bytes": int(scratch)}


def _stage_operands(groups, device):
    """The groups' device operands -> (per-group ``(row_ops, b_dstdel,
    b_wgt)``, the staging buffer to put back once the counts are on the
    host).

    The host operands (mostly the runs' SENTINEL padding: ~100 MB for a
    1e-2·|E| batch at scale 21) are packed into the pinned staging buffer
    by PyTorch's multi-threaded copy and go to the card in one
    asynchronous copy, so nothing here waits for the device."""
    host = []
    for *_head, (row_ops, bdl, bw) in groups:
        host += [np.ascontiguousarray(row_ops, np.int32).reshape(-1),
                 np.ascontiguousarray(bdl, np.int32).reshape(-1),
                 np.ascontiguousarray(bw, np.float32).view(np.int32).reshape(-1)]
    if not host:
        return [], None
    total = sum(x.size for x in host)
    stage = _STAGE.pop("buf", None)
    if stage is None or stage.numel() < total:
        grown = 0 if stage is None else 2 * stage.numel()
        stage = torch.empty(max(total, grown), dtype=torch.int32, pin_memory=True)
    at = 0
    for x in host:
        stage[at:at + x.size].copy_(torch.from_numpy(x))
        at += x.size
    flat = stage[:total].to(device, non_blocking=True)
    operands, at = [], 0
    for _width, a_pad, k, *_rest in groups:
        row_ops = flat[at:at + 6 * a_pad].view(6, a_pad)
        at += 6 * a_pad
        bdl = flat[at:at + 2 * a_pad * k].view(2, a_pad, k)
        at += 2 * a_pad * k
        bw = flat[at:at + a_pad * k].view(torch.float32).view(a_pad, k)
        at += a_pad * k
        operands.append((row_ops, bdl, bw))
    return operands, stage


def _merge_in_place(dst, wgt, slot_rows, groups, lo, hi, backend: str):
    """One merge a group, in place, in group order -> (counts per group,
    the staging buffer or None): ``merge_rows_fused`` on operands staged
    through pinned memory on the card, ``merge_rows_fused_torch`` on
    ``torch.as_tensor`` copies otherwise.  The groups' blocks are
    disjoint, so no group reads what another writes."""
    if backend == "cuda":
        operands, stage = _stage_operands(groups, dst.device)
        merge = _kernel.merge_rows_fused
    else:
        operands = [tuple(torch.as_tensor(x, device=dst.device) for x in g[5]) for g in groups]
        stage, merge = None, _kernel.merge_rows_fused_torch
    counts = [merge(dst, wgt, slot_rows, *ops, width=width, moves=moves, max_holes=d_k,
                    lo=lo, hi=hi)
              for (width, _a_pad, _k, d_k, moves, _host), ops in zip(groups, operands)]
    return counts, stage


def _merge_rebuild(dst, wgt, slot_rows, groups, lo, hi, slot_map, owner_patch):
    """The plain rebuild: gather and merge every group against the
    pre-update buffers, refresh the bounds, then rebuild the prefix
    ``slot_map`` covers from the merged rows."""
    dev = dst.device
    merged_all, counts_all = [], []
    for width, _a_pad, _k, d_k, _moves, (row_ops, bdl, bw) in groups:
        row_ops = torch.as_tensor(row_ops, device=dev)
        bdl = torch.as_tensor(bdl, device=dev)
        bw = torch.as_tensor(bw, device=dev)
        d_rows, w_rows, counts = _kernel.gather_merge_torch(dst, wgt, row_ops, bdl, bw,
                                                           width, d_k)
        counts_all.append(counts)
        merged_all.append((row_ops, d_rows, w_rows))
    if lo is not None:
        for (row_ops, _d, _w), counts in zip(merged_all, counts_all):
            _kernel.refresh_blocks_torch(lo, hi, row_ops, counts)
    pd = torch.cat([m[1].reshape(-1) for m in merged_all]
                   + [torch.full((1,), SENTINEL, dtype=torch.int32, device=dev)])
    pw = torch.cat([m[2].reshape(-1) for m in merged_all]
                   + [torch.zeros(1, dtype=torch.float32, device=dev)])
    smap = torch.as_tensor(slot_map, device=dev).to(torch.int64)
    safe = smap.clamp(0, pd.shape[0] - 1)
    touched = smap >= 0
    span = smap.shape[0]
    dst[:span] = torch.where(touched, pd[safe], dst[:span])
    wgt[:span] = torch.where(touched, pw[safe], wgt[:span])
    if any(bool(g[4]) for g in groups):
        op = torch.as_tensor(owner_patch, device=dev)
        slot_rows[:span] = torch.where(touched, op[safe], slot_rows[:span])
    return counts_all
