"""Fused plan apply: every width group of an UpdatePlan in one call.

``fused_apply`` runs a whole UpdatePlan (DESIGN.md §9/§12).  On the card
(``backend="cuda"``) each width group is one ``merge_rows_fused`` launch
that reads the touched rows' live prefixes from the arena, merges the
sorted batch runs into them (deletes, weight upserts, ranked inserts) and
writes them back in place: grown rows land in their NEW block while their
old block is SENTINEL-filled, and the walk image's [lo, hi) bounds are
refreshed from the counts in the same launch.  The plain version
(``backend="torch"``) is ``repro``'s formulation:

  gather   touched rows' live prefixes into [A, W] tiles per group (W =
           the group's pow-2 width class, >= every member's capacity),
  merge    the sorted batch runs [A, K] into the sorted rows
           (``merge_rows_torch``),
  write    all merged groups back — either per-group scatters or a
           host-mapped gather rebuild of the quantized bump prefix
           (``choose_scatter`` picks).

Every group is read from the buffers as they were before the call (the
groups' blocks are disjoint), then written in place: the caller owns
``dst``/``wgt``/``slot_rows`` (a DiGraph detaches snapshot-shared buffers
first, a walk image copies what a sealed generation shares).  With
``walk=`` the k-step interval walk over the patched buffers follows the
merges (``WalkImage.walk_flush``).  The merge counts come back to the host
through one copy per call, after everything else is queued: the only host
synchronisation of the CUDA path.

While the profiler runs, ``fused_apply`` counts each group's merge
(``group_counters``, from the host operands) once the counts are back, in
a span of its own, ``slot_update.count``, outside ``slot_update.pack`` and
``slot_update.wait``; with the profiler off no counter is computed.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import util
from ...runtime import faultinject, trace
from ..slot_walk import ops as _sw_ops
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
#: A call takes it out and puts it back after the counts copy, when its own
#: copy to the card has finished.
_STAGE: dict = {}


def width_floor(device: torch.device) -> int:
    """Row-group width floor for buffers on ``device`` (padding only)."""
    return GPU_FLOOR if device.type == "cuda" else HOST_FLOOR


def merge_rows(d_rows, w_rows, degs, b_dst, b_wgt, b_del, *,
               backend: str = "auto", max_holes: int | None = None):
    """Backend-dispatched row merge on padded [A, W] rows (the TPU
    kernel's contract): ``torch`` version, or ``cuda``, whose wrapper runs
    on CPU tensors only (the card merges in place, through ``fused_apply``).

    ``max_holes`` bounds the delete-hole compaction window of the plain
    version; None means the full run width.
    """
    if util.resolve_backend(backend, d_rows.device) == "cuda":
        return _kernel.merge_rows(d_rows, w_rows, degs, b_dst, b_wgt, b_del)
    return _kernel.merge_rows_torch(
        d_rows, w_rows, degs, b_dst, b_wgt, b_del, max_holes=max_holes
    )


def choose_scatter(cap_e: int, touched: int, device: torch.device) -> bool:
    """Write-back dispatch: per-group scatters on the GPU (which does them
    well) and for a tiny batch on a huge host arena; otherwise one
    full-buffer gather rebuild."""
    if device.type == "cuda":
        return True
    return cap_e > REBUILD_MAX_CAP and touched * 10 < cap_e


def quantized_prefix(cap_e: int, bump: int) -> int:
    """Bump prefix bound on the cap_e/8 lattice (the walk's edges_hi
    policy): coarse enough that streaming bump growth rarely changes it,
    tight enough to skip the SENTINEL tail."""
    q = max(cap_e // 8, 128)
    return min(-(-max(int(bump), 1) // q) * q, cap_e)


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


def fused_apply(dst, wgt, slot_rows, groups, *, scatter: bool,
                backend: str = "auto", slot_map=None, owner_patch=None,
                lo=None, hi=None, walk=None, visits0=None):
    """Apply EVERY width group of a plan, writing the buffers in place.

    ``groups`` is ``[(width, a_pad, k, d_k, moves, operands), ...]`` with
    ``operands`` the packed 3-tuple ``(row_ops [6, A] int32 =
    old_starts/old_caps/new_starts/new_caps/degs/row_ids, b_dstdel
    [2, A, K] int32, b_wgt [A, K] f32)`` (numpy: one transfer each) and
    ``d_k`` the group's (pow-2) delete-run ceiling.  ``scatter=False``
    takes the host-mapped gather rebuild (``host_patch_layout`` supplies
    ``slot_map``/``owner_patch``) over the prefix ``slot_map`` covers, so
    the SENTINEL tail past the bump pointer is never re-read.
    ``lo``/``hi`` (the int32 [lo, hi) interval cache of a walk image) are
    refreshed from the merge counts into new tensors.  ``walk=(steps, nv,
    edges_hi, nwalks, normalize, engine)`` (with ``lo``/``hi``) runs the
    k-step blocked walk over the patched buffers and refreshed intervals
    behind the merges, from ``visits0`` [nwalks, nv] or, with ``nwalks``
    0, from the all-ones vector; ``engine`` picks its tile cumsum.

    ``scatter`` and the rebuild operands steer the plain version only: the
    CUDA kernel always writes back in place, to the same state.

    The fault point ``slot_update.<backend>`` fires once, before the one
    attempt and before any operand is touched; an injected failure raises
    to the caller (no retry, no other backend).  The walk epilogue fires no
    ``slot_walk`` point, as in ``repro``.

    Returns ``(dst, wgt, slot_rows, counts_list, extra)`` with ``extra``
    None, the refreshed ``(lo, hi)``, or ``(visits, lo, hi)`` with a walk.
    """
    dev = dst.device
    backend = util.resolve_backend(backend, dev)
    faultinject.fire(f"slot_update.{backend}")
    if walk is not None and (lo is None or hi is None):
        raise ValueError("fused_apply: walk= needs the image's lo/hi intervals")
    if lo is not None and hi is not None:
        lo, hi = lo.clone(), hi.clone()
        extra = (lo, hi)
    else:
        lo = hi = extra = None
    stage = None
    with trace.span("slot_update.pack"):
        if backend == "cuda":
            counts_all, stage = _apply_cuda(dst, wgt, slot_rows, groups, lo, hi)
        else:
            counts_all = _apply_torch(dst, wgt, slot_rows, groups, lo, hi, scatter=scatter,
                                      slot_map=slot_map, owner_patch=owner_patch)
    if walk is not None:  # queued behind the merges, before the host waits
        steps, nv, edges_hi, nwalks, normalize, engine = walk
        v0 = (visits0 if nwalks
              else torch.ones((1, nv), dtype=torch.float32, device=dev))
        visits = _sw_ops.slot_walk_multi_blocked(
            dst, lo, hi, v0, steps, nv, edges_hi=edges_hi,
            normalize=normalize, backend=engine)
        extra = (visits if nwalks else visits[0], lo, hi)

    # one counts copy to the host, split back per group
    with trace.span("slot_update.wait"):
        counts_cat = (util.host(torch.cat(counts_all)) if counts_all
                      else np.zeros(0, np.int32))
    if stage is not None:  # the operands' copy went before the counts'
        _STAGE["buf"] = stage
    if trace.recording():
        with trace.span("slot_update.count"):
            for g in groups:
                scratch = _kernel.scratch_bytes(*g[:3]) if backend == "cuda" else 0
                trace.count(**group_counters(g, lo is not None, scratch))
    counts_list, at = [], 0
    for g in groups:
        counts_list.append(counts_cat[at:at + g[1]])
        at += g[1]
    return dst, wgt, slot_rows, counts_list, extra


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


def _apply_cuda(dst, wgt, slot_rows, groups, lo, hi):
    """One ``merge_rows_fused`` launch per group, in place -> (counts per
    group, the staging buffer to put back once the counts are on the host).

    The groups' host operands (mostly the runs' SENTINEL padding: ~100 MB
    for a 1e-2·|E| batch at scale 21) are packed into the pinned staging
    buffer by PyTorch's multi-threaded copy and go to the card in one
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
    flat = stage[:total].to(dst.device, non_blocking=True)
    counts_all, at = [], 0
    for width, a_pad, k, _d_k, moves, _ops in groups:
        row_ops = flat[at:at + 6 * a_pad].view(6, a_pad)
        at += 6 * a_pad
        bdl = flat[at:at + 2 * a_pad * k].view(2, a_pad, k)
        at += 2 * a_pad * k
        bw = flat[at:at + a_pad * k].view(torch.float32).view(a_pad, k)
        at += a_pad * k
        counts_all.append(_kernel.merge_rows_fused(
            dst, wgt, slot_rows, row_ops, bdl, bw, width=width, moves=moves, lo=lo, hi=hi))
    return counts_all, stage


def _apply_torch(dst, wgt, slot_rows, groups, lo, hi, *, scatter: bool,
                 slot_map, owner_patch):
    """The plain version: gather and merge every group against the
    pre-update buffers, refresh the bounds, then write back."""
    dev = dst.device
    any_moves = any(bool(g[4]) for g in groups)
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

    if scatter:
        for g, (row_ops, d_rows, w_rows) in zip(groups, merged_all):
            _kernel.write_back_torch(dst, wgt, slot_rows, row_ops, d_rows, w_rows,
                                     moves=bool(g[4]))
    elif groups:
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
        if any_moves:
            op = torch.as_tensor(owner_patch, device=dev)
            slot_rows[:span] = torch.where(touched, op[safe], slot_rows[:span])
    return counts_all
