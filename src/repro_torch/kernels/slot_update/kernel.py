"""merge_rows: merge sorted op runs into sorted arena rows.

``merge_rows`` launches the hand-written CUDA kernel
(``csrc/merge_rows.cu``: one block per row, rank arithmetic, O(W + K log W)
work, exact for every int32 id) for CUDA tensors and uses its plain
PyTorch version, ``merge_rows_torch``, only for CPU tensors.  It replaces
the TPU kernel ``repro/kernels/slot_update/kernel.py::merge_rows_pallas``
(one-hot matmul placement, O(W^2), ids < 2**24).  ``merge_rows.launches``
counts kernel launches.

``merge_rows_torch`` is the port of ``repro``'s ``_merge_rows_xla``: a
batched branchless bisect for op membership, rank arithmetic for placement
and a (holes+1)-wide window for delete-hole compaction; runs wider than
``MERGE_WINDOW_MAX_K`` take an equality-tensor + row sort formulation.
"""
from __future__ import annotations

import torch

from ...core import util
from .. import _build

SENTINEL = int(util.SENTINEL)
#: Runs wider than this take the sort-based merge; narrower runs use the
#: window-compaction merge.
MERGE_WINDOW_MAX_K = 32


def _threads(w: int, k: int) -> int:
    """Block size of the CUDA merge: one lane per slot or op, 32..256."""
    n = max(w, k, 32)
    return min(256, 1 << (n - 1).bit_length())


def merge_rows(d_rows, w_rows, degs, b_dst, b_wgt, b_del):
    """Row merge: [A, W] rows x [A, K] runs -> (out_d, out_w, counts)."""
    if d_rows.device.type == "cpu":
        return merge_rows_torch(d_rows, w_rows, degs, b_dst, b_wgt, b_del)
    a, w = d_rows.shape
    k = b_dst.shape[1]
    for t, name, dtype, shape in (
        (d_rows, "d_rows", torch.int32, (a, w)),
        (w_rows, "w_rows", torch.float32, (a, w)),
        (degs, "degs", torch.int32, (a,)),
        (b_dst, "b_dst", torch.int32, (a, k)),
        (b_wgt, "b_wgt", torch.float32, (a, k)),
        (b_del, "b_del", torch.int32, (a, k)),
    ):
        _build.require(t, name, dtype, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    out_d = torch.empty_like(d_rows)
    out_w = torch.empty_like(w_rows)
    counts = torch.empty_like(degs)
    if a == 0:
        return out_d, out_w, counts
    scratch = torch.empty((2, a, k), dtype=torch.int32, device=d_rows.device)
    lib = _build.library()
    _build.check(
        lib.repro_merge_rows(
            d_rows.data_ptr(), w_rows.data_ptr(), degs.data_ptr(),
            b_dst.data_ptr(), b_wgt.data_ptr(), b_del.data_ptr(),
            a, w, k, out_d.data_ptr(), out_w.data_ptr(), counts.data_ptr(),
            scratch.data_ptr(), _threads(w, k), _build.stream(d_rows),
        ),
        "merge_rows",
    )
    merge_rows.launches += 1
    return out_d, out_w, counts


merge_rows.launches = 0


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
