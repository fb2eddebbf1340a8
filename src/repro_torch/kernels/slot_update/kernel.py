"""The row merge of an update batch, fused with its gather and write-back.

``merge_rows_fused`` merges one width group of an UpdatePlan into the
arena in place (``csrc/merge_rows.cu``): for each touched row it reads the
live prefix from the arena, merges the sorted op run into it (deletes,
weight upserts, ranked inserts), writes the merged row into its (possibly
new) block, clears a vacated block, writes the owner map and the walk
image's [lo, hi) bounds, and returns the counts.  One warp a row for rows
of width <= 32 (ranks by ballots over the row in registers), one block a
row for wider ones.  Exact for every int32 id.  It replaces the TPU kernel
``repro/kernels/slot_update/kernel.py::merge_rows_pallas`` (one-hot matmul
placement, O(W^2), ids < 2**24) with the gather and the write-back around
it.  The wrapper launches the kernel for CUDA tensors and uses its plain
version, ``merge_rows_fused_torch``, only for CPU tensors;
``merge_rows_fused.launches`` counts kernel launches.

``merge_rows`` is the row merge on padded [A, W] rows (the TPU kernel's
contract), on the CPU only: on the card rows merge in place, through
``merge_rows_fused``.

``merge_rows_torch`` is the port of ``repro``'s ``_merge_rows_xla``: a
batched branchless bisect for op membership, rank arithmetic for placement
and a (holes+1)-wide window for delete-hole compaction; runs wider than
``MERGE_WINDOW_MAX_K`` take an equality-tensor + row sort formulation.
The plain fused version gathers with ``util.rows_to_padded``, merges with
it and scatters back (``gather_merge_torch``, ``write_back_torch``,
``refresh_blocks_torch``).
"""
from __future__ import annotations

import torch

from ...core import util
from .. import _build

SENTINEL = int(util.SENTINEL)
#: Runs wider than this take the sort-based merge; narrower runs use the
#: window-compaction merge.
MERGE_WINDOW_MAX_K = 32
#: Rows of width <= this take the warp kernel (one warp a row)
WARP_ROW_MAX = 32
#: Largest per-row stage (row ids and weights, run keys and ranks) the
#: block kernel keeps in shared memory; wider rows stage in device memory
SMEM_STAGE_MAX = 40 * 1024


def _threads(w: int, k: int) -> int:
    """Block size of the block kernel (w > 32): one lane per slot or op, up
    to 256."""
    n = max(w, k, 32)
    return min(256, 1 << (n - 1).bit_length())


def stage_bytes(w: int, k: int) -> int:
    """Bytes of one row's stage in the block kernel."""
    return 4 * (2 * w + 3 * k)


def scratch_bytes(width: int, a: int, k: int) -> int:
    """Device memory a launch of the block kernel stages its rows in: 0
    for warp rows and for stages that fit in shared memory."""
    if width <= WARP_ROW_MAX or stage_bytes(width, k) <= SMEM_STAGE_MAX:
        return 0
    return a * stage_bytes(width, k)


def gather_merge_torch(dst, wgt, row_ops, b_dstdel, b_wgt, width: int,
                       max_holes: int | None = None):
    """Plain gather + merge of one group: the rows' live prefixes into
    [A, width] tiles, merged with their runs -> (d_rows, w_rows, counts)."""
    old_starts, degs = row_ops[0], row_ops[4]
    d_rows = util.rows_to_padded(dst, old_starts, degs, width, SENTINEL)
    w_rows = util.rows_to_padded(wgt, old_starts, degs, width, 0.0)
    return merge_rows_torch(d_rows, w_rows, degs.contiguous(), b_dstdel[0], b_wgt,
                            b_dstdel[1], max_holes=max_holes)


def write_back_torch(dst, wgt, slot_rows, row_ops, d_rows, w_rows, *, moves: bool):
    """Plain scatter write-back of one merged group (in place): a moved
    row's old block is SENTINEL-filled, its merged row lands in its new
    block and, with ``moves``, the owner map is written over the new block."""
    old_starts, old_caps, new_starts, new_caps, _degs, row_ids = row_ops
    width = d_rows.shape[1]
    lane = torch.arange(width, dtype=torch.int64, device=dst.device)[None, :]
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


def refresh_blocks_torch(lo, hi, row_ops, counts) -> None:
    """Plain [lo, hi) refresh of one group's rows from their counts (in
    place; pad rows carry row ids >= lo.shape[0])."""
    new_starts, row_ids = row_ops[2], row_ops[5]
    ok = row_ids < lo.shape[0]
    lo[row_ids[ok].to(torch.int64)] = new_starts[ok].to(lo.dtype)
    hi[row_ids[ok].to(torch.int64)] = (new_starts + counts)[ok].to(hi.dtype)


def merge_rows_fused_torch(dst, wgt, slot_rows, row_ops, b_dstdel, b_wgt, *,
                           width: int, moves: bool = False, max_holes=None,
                           lo=None, hi=None):
    """Plain version of ``merge_rows_fused``: gather, merge, refresh the
    bounds, write back."""
    d_rows, w_rows, counts = gather_merge_torch(dst, wgt, row_ops, b_dstdel, b_wgt,
                                                width, max_holes)
    if lo is not None:
        refresh_blocks_torch(lo, hi, row_ops, counts)
    write_back_torch(dst, wgt, slot_rows, row_ops, d_rows, w_rows, moves=moves)
    return counts


def merge_rows_fused(dst, wgt, slot_rows, row_ops, b_dstdel, b_wgt, *,
                     width: int, moves: bool = False, max_holes=None,
                     lo=None, hi=None):
    """Merge one width group's op runs into its arena rows, in place.

    ``dst``/``wgt``/``slot_rows`` [cap_e] are the arena (written in place;
    ``slot_rows`` only with ``moves``); ``row_ops`` [6, A] int32 holds
    old_starts/old_caps/new_starts/new_caps/degs/row_ids; ``b_dstdel``
    [2, A, K] int32 the sorted runs' keys and delete flags, ``b_wgt``
    [A, K] f32 their weights; ``width`` >= every row's capacity.  Pad rows
    carry ``new_starts`` -1.  ``lo``/``hi`` (int32, the walk image's
    bounds) are refreshed in place for rows with ids < ``lo.shape[0]``.
    ``max_holes`` bounds the plain version's delete-hole window (the
    kernel needs none).  Returns the merged counts [A] int32.
    """
    if dst.device.type == "cpu":
        return merge_rows_fused_torch(
            dst, wgt, slot_rows, row_ops, b_dstdel, b_wgt, width=width, moves=moves,
            max_holes=max_holes, lo=lo, hi=hi)
    a = row_ops.shape[1] if row_ops.ndim == 2 else -1
    k = b_dstdel.shape[2] if b_dstdel.ndim == 3 else -1
    operands = [(dst, "dst", torch.int32, None), (wgt, "wgt", torch.float32, None),
                (row_ops, "row_ops", torch.int32, (6, a)),
                (b_dstdel, "b_dstdel", torch.int32, (2, a, k)),
                (b_wgt, "b_wgt", torch.float32, (a, k))]
    if moves:
        operands.append((slot_rows, "slot_rows", torch.int32, None))
    if lo is not None:
        operands += [(lo, "lo", torch.int32, None), (hi, "hi", torch.int32, tuple(lo.shape))]
    for t, name, dtype, shape in operands:
        _build.require(t, name, dtype, 1 if shape is None else len(shape))
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not 0 < width < 2**31 or dst.shape[0] >= 2**31:
        raise ValueError("width and the arena must fit int32 offsets")
    counts = torch.empty(a, dtype=torch.int32, device=dst.device)
    if a == 0:
        return counts
    nbytes = scratch_bytes(width, a, k)
    scratch = (torch.empty(nbytes // 4, dtype=torch.int32, device=dst.device)
               if nbytes else None)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    lib = _build.library()
    _build.check(
        lib.repro_merge_rows(
            dst.data_ptr(), wgt.data_ptr(), ptr(slot_rows) if moves else 0, row_ops.data_ptr(), a, width,
            b_dstdel[0].data_ptr(), b_dstdel[1].data_ptr(), b_wgt.data_ptr(), k,
            int(bool(moves)), counts.data_ptr(), ptr(lo), ptr(hi),
            0 if lo is None else lo.shape[0], ptr(scratch), _threads(width, k),
            _build.stream(dst),
        ),
        "merge_rows_fused",
    )
    merge_rows_fused.launches += 1
    return counts


merge_rows_fused.launches = 0


def merge_rows(d_rows, w_rows, degs, b_dst, b_wgt, b_del):
    """Row merge on padded rows: [A, W] rows x [A, K] runs -> (out_d, out_w,
    counts), on CPU tensors only (``merge_rows_torch``); on the card rows
    merge in place, through ``merge_rows_fused``."""
    if d_rows.device.type != "cpu":
        raise ValueError("merge_rows on padded rows runs on the CPU only: on the card "
                         "rows merge in place, through merge_rows_fused")
    return merge_rows_torch(d_rows, w_rows, degs, b_dst, b_wgt, b_del)


def _flat_set(size: int, idx, vals, fill, dtype, device):
    """[size + 1] buffer of ``fill`` with ``vals`` written at ``idx``.

    The extra trailing slot absorbs the writes of masked-off lanes.
    """
    out = torch.full((size + 1,), fill, dtype=dtype, device=device)
    out[idx.reshape(-1)] = vals.reshape(-1).to(dtype)
    return out[:size]


def merge_rows_torch(d_rows, w_rows, degs, b_dst, b_wgt, b_del,
                     max_holes: int | None = None):
    """Plain version: the scatter-free (and for narrow runs sort-free) merge.

    Rows arrive sorted (live ascending prefix, SENTINEL tail) and so do
    each row's ops, so op membership is a batched bisect over the [A, K]
    query set; deletes mark a ``killed`` plane, upserts overwrite their
    hit lane's weight, new inserts land at ``#surviving-below + rank``.
    A delete punches at most ``max_holes`` holes (callers pass the
    group's pow-2 delete-run ceiling), so a (holes+1)-wide select window
    compacts the row.  Runs wider than ``MERGE_WINDOW_MAX_K`` take the
    equality-tensor + row-sort formulation.
    """
    a, w = d_rows.shape
    k = b_dst.shape[1]
    dev = d_rows.device
    bdel = b_del != 0
    lane = torch.arange(w, dtype=torch.int64, device=dev)[None, :]
    live = lane < degs.to(torch.int64)[:, None]
    ilive = b_dst != SENTINEL

    if k > MERGE_WINDOW_MAX_K:
        eq = (b_dst[:, :, None] == d_rows[:, None, :]) & live[:, None, :]
        killed = (eq & bdel[:, :, None]).any(dim=1)
        upd = eq & ~bdel[:, :, None]
        has_up = upd.any(dim=1)
        # at most one op matches a lane, so the sum moves that one weight
        w_up = torch.where(upd, b_wgt[:, :, None], 0.0).sum(dim=1)
        found = eq.any(dim=2) & ilive
        new_ins = ~found & ~bdel & ilive
        d_keep = torch.where(live & ~killed, d_rows, SENTINEL)
        w_keep = torch.where(has_up, w_up, w_rows)
        keys = torch.cat([d_keep, torch.where(new_ins, b_dst, SENTINEL)], dim=1)
        vals = torch.cat([w_keep, b_wgt], dim=1)
        keys, order = torch.sort(keys, dim=1, stable=True)
        vals = torch.gather(vals, 1, order)
        d_out = keys[:, :w].contiguous()
        w_out = torch.where(d_out != SENTINEL, vals[:, :w], 0.0)
        counts = (d_out != SENTINEL).sum(dim=1).to(torch.int32)
        return d_out, w_out, counts

    holes = k if max_holes is None else min(int(max_holes), k)
    # batched branchless bisect: pos = #row entries with key < q
    pos = torch.zeros((a, k), dtype=torch.int64, device=dev)
    h = w // 2
    while h >= 1:
        cand = pos + h
        at = torch.gather(d_rows, 1, cand - 1)
        pos = torch.where(at < b_dst, cand, pos)
        h //= 2
    at = torch.gather(d_rows, 1, pos.clamp(max=w - 1))
    found = (at == b_dst) & ilive & (pos < w)
    rowi = torch.arange(a, dtype=torch.int64, device=dev)[:, None].expand(a, k)

    # deletes mark hit lanes; upserts land their weight in place
    kill_idx = torch.where(found & bdel, rowi * w + pos, a * w)
    killed = _flat_set(a * w, kill_idx, torch.ones_like(kill_idx, dtype=torch.bool),
                       False, torch.bool, dev).reshape(a, w)
    up_idx = torch.where(found & ~bdel, rowi * w + pos, a * w)
    w_keep = torch.cat([w_rows.reshape(-1), torch.zeros(1, device=dev)])
    w_keep[up_idx.reshape(-1)] = b_wgt.reshape(-1)
    w_keep = w_keep[: a * w].reshape(a, w)

    keep = live & ~killed
    keep_i = keep.to(torch.int64)
    kept_cum = torch.cumsum(keep_i, dim=1)
    n_kept = kept_cum[:, -1]
    kex = kept_cum - keep_i  # kept strictly before lane i
    d_keep = torch.where(keep, d_rows, SENTINEL)

    # new-insert placement: surviving entries below the key + run rank
    killed_i = killed.to(torch.int64)
    kill_cum = torch.cumsum(killed_i, dim=1)
    kill_excl = torch.cat([kill_cum - killed_i, kill_cum[:, -1:]], dim=1)
    new_ins = ilive & ~found & ~bdel
    new_i = new_ins.to(torch.int64)
    lt_kept = pos - torch.gather(kill_excl, 1, pos)
    pos_ins = lt_kept + torch.cumsum(new_i, dim=1) - new_i
    ins_idx = torch.where(
        new_ins, rowi * (w + 1) + pos_ins.clamp(max=w), a * (w + 1)
    )
    size = a * (w + 1)
    is_ins = _flat_set(size, ins_idx, new_ins, False, torch.bool, dev)
    is_ins = is_ins.reshape(a, w + 1)[:, :w]
    ins_d = _flat_set(size, ins_idx, b_dst, 0, torch.int32, dev)
    ins_d = ins_d.reshape(a, w + 1)[:, :w]
    ins_w = _flat_set(size, ins_idx, b_wgt, 0.0, torch.float32, dev)
    ins_w = ins_w.reshape(a, w + 1)[:, :w]
    is_ins_i = is_ins.to(torch.int64)
    ins_lt = torch.cumsum(is_ins_i, dim=1) - is_ins_i

    # hole compaction: kept lane i lands at kex[i], a left shift bounded by
    # the group delete-run ceiling — (holes+1)-wide select window
    if holes:
        pad_d = torch.cat([d_keep, torch.full((a, holes), SENTINEL, dtype=torch.int32, device=dev)], 1)
        pad_w = torch.cat([w_keep, torch.zeros((a, holes), device=dev)], 1)
        pad_keep = torch.cat([keep, torch.zeros((a, holes), dtype=torch.bool, device=dev)], 1)
        pad_kex = torch.cat([kex, torch.full((a, holes), w + k, dtype=torch.int64, device=dev)], 1)
    else:
        pad_d, pad_w, pad_keep, pad_kex = d_keep, w_keep, keep, kex
    comp_d = torch.full((a, w), SENTINEL, dtype=torch.int32, device=dev)
    comp_w = torch.zeros((a, w), device=dev)
    for o in range(holes + 1):
        sel = pad_keep[:, o:o + w] & (pad_kex[:, o:o + w] == lane)
        comp_d = torch.where(sel, pad_d[:, o:o + w], comp_d)
        comp_w = torch.where(sel, pad_w[:, o:o + w], comp_w)

    r = (lane - ins_lt).clamp(0, w - 1)
    g_d = torch.gather(comp_d, 1, r)
    g_w = torch.gather(comp_w, 1, r)
    counts = (n_kept + new_i.sum(dim=1)).to(torch.int32)
    valid = lane < counts.to(torch.int64)[:, None]
    d_out = torch.where(valid, torch.where(is_ins, ins_d, g_d), SENTINEL)
    w_out = torch.where(valid, torch.where(is_ins, ins_w, g_w), 0.0)
    return d_out, w_out, counts
