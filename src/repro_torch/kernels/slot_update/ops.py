"""Fused plan apply: every width group of an UpdatePlan in one call.

``fused_apply`` runs a whole UpdatePlan (DESIGN.md §9/§12):

  gather   touched rows' live prefixes into [A, W] tiles per group (W =
           the group's pow-2 width class, >= every member's capacity),
  merge    the sorted batch runs [A, K] into the sorted rows — deletes,
           weight upserts and ranked inserts in one pass (the CUDA
           ``merge_rows`` kernel, or its plain PyTorch version),
  write    all merged groups back — either per-group scatters (grown rows
           land directly in their NEW block while their old block is
           SENTINEL-filled) or a host-mapped gather rebuild of the
           quantized bump prefix (``choose_scatter`` picks).

Every group is gathered from the buffers as they were before the call,
then written in place: the caller owns ``dst``/``wgt``/``slot_rows`` (a
DiGraph detaches snapshot-shared buffers first).  The merge counts come
back to the host through one copy per call.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import util
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


def width_floor(device: torch.device) -> int:
    """Row-group width floor for buffers on ``device`` (padding only)."""
    return GPU_FLOOR if device.type == "cuda" else HOST_FLOOR


def merge_rows(d_rows, w_rows, degs, b_dst, b_wgt, b_del, *,
               backend: str = "auto", max_holes: int | None = None):
    """Backend-dispatched row merge: ``cuda`` kernel or ``torch`` version.

    ``max_holes`` bounds the delete-hole compaction window of the plain
    version (the kernel needs no bound); None means the full run width.
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


def _scatter_group(dst, wgt, slot_rows, merged, *, moves: bool):
    """Per-group scatter write-back (in place)."""
    width, row_ids, old_starts, old_caps, new_starts, new_caps, d_rows, w_rows = merged
    dev = dst.device
    lane = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    old_starts = old_starts.to(torch.int64)[:, None]
    new_starts = new_starts.to(torch.int64)[:, None]
    if moves:
        moved = (new_starts != old_starts) & (old_starts >= 0)
        clear = moved & (lane < old_caps.to(torch.int64)[:, None])
        dst[(old_starts + lane)[clear]] = SENTINEL
    put = (new_starts >= 0) & (lane < new_caps.to(torch.int64)[:, None])
    idx = (new_starts + lane)[put]
    dst[idx] = d_rows[put]
    wgt[idx] = w_rows[put]
    if moves:
        slot_rows[idx] = row_ids[:, None].expand(-1, width)[put]


def fused_apply(dst, wgt, slot_rows, groups, *, scatter: bool,
                backend: str = "auto", slot_map=None, owner_patch=None,
                lo=None, hi=None):
    """Apply EVERY width group of a plan, writing the buffers in place.

    ``groups`` is ``[(width, a_pad, k, d_k, moves, operands), ...]`` with
    ``operands`` the packed 3-tuple ``(row_ops [6, A] int32 =
    old_starts/old_caps/new_starts/new_caps/degs/row_ids, b_dstdel
    [2, A, K] int32, b_wgt [A, K] f32)`` (numpy: one transfer each) and
    ``d_k`` the group's (pow-2) delete-run ceiling.  ``scatter=False``
    takes the host-mapped gather rebuild (``host_patch_layout`` supplies
    ``slot_map``/``owner_patch``) over the prefix ``slot_map`` covers, so
    the SENTINEL tail past the bump pointer is never re-read.
    ``lo``/``hi`` (the [lo, hi) interval cache of the shared walk image)
    are refreshed from the merge counts into new tensors.

    Returns ``(dst, wgt, slot_rows, counts_list, extra)`` with ``extra``
    None or the refreshed ``(lo, hi)``.
    """
    dev = dst.device
    backend = util.resolve_backend(backend, dev)
    any_moves = any(bool(g[4]) for g in groups)

    # gather + merge every group against the pre-update buffers
    merged_all, counts_all = [], []
    for width, _a_pad, _k, d_k, _moves, (row_ops, bdl, bw) in groups:
        row_ops = torch.as_tensor(row_ops, device=dev)
        bdl = torch.as_tensor(bdl, device=dev)
        bw = torch.as_tensor(bw, device=dev)
        old_starts, old_caps, new_starts, new_caps, degs, row_ids = row_ops
        d_rows = util.rows_to_padded(dst, old_starts, degs, width, SENTINEL)
        w_rows = util.rows_to_padded(wgt, old_starts, degs, width, 0.0)
        d_rows, w_rows, counts = merge_rows(
            d_rows, w_rows, degs.contiguous(), bdl[0], bw, bdl[1],
            backend=backend, max_holes=d_k,
        )
        counts_all.append(counts)
        merged_all.append((width, row_ids, old_starts, old_caps, new_starts,
                           new_caps, d_rows, w_rows))

    extra = None
    if lo is not None and hi is not None:
        lo, hi = lo.clone(), hi.clone()
        for (_w, row_ids, _os, _oc, new_starts, _nc, _d, _wr), counts in zip(
            merged_all, counts_all
        ):
            ok = row_ids < lo.shape[0]  # pad rows carry row_ids >= nv
            lo[row_ids[ok].to(torch.int64)] = new_starts[ok].to(lo.dtype)
            hi[row_ids[ok].to(torch.int64)] = (new_starts + counts)[ok].to(hi.dtype)
        extra = (lo, hi)

    if scatter:
        for g, merged in zip(groups, merged_all):
            _scatter_group(dst, wgt, slot_rows, merged, moves=bool(g[4]))
    elif groups:
        pd = torch.cat([m[6].reshape(-1) for m in merged_all]
                       + [torch.full((1,), SENTINEL, dtype=torch.int32, device=dev)])
        pw = torch.cat([m[7].reshape(-1) for m in merged_all]
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

    # one counts copy to the host, split back per group
    counts_cat = util.host(torch.cat(counts_all)) if counts_all else np.zeros(0, np.int32)
    counts_list, at = [], 0
    for g in groups:
        counts_list.append(counts_cat[at:at + g[1]])
        at += g[1]
    return dst, wgt, slot_rows, counts_list, extra
