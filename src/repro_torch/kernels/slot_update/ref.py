"""Pure-numpy oracle for the slot_update row merge.

Dict-per-row semantics, deliberately naive: start from the row's live
prefix, apply every op of its batch run (delete pops, insert/upsert
assigns — one op per key, guaranteed by UpdatePlan), and emit the result
ascending with SENTINEL padding.  The CUDA kernel and its plain PyTorch
version (``kernel.py``) are tested against this.
"""
from __future__ import annotations

import numpy as np

from ...core import util

SENTINEL = util.SENTINEL


def merge_rows_reference(d_rows, w_rows, degs, b_dst, b_wgt, b_del):
    """Merge batch runs into gathered rows; returns (out_d, out_w, counts).

    d_rows/w_rows: [A, W] gathered rows (live prefix + SENTINEL/0 tail)
    degs:          [A]    live lengths
    b_dst/b_wgt:   [A, K] batch run values (ascending, SENTINEL pad)
    b_del:         [A, K] 1 = delete op
    """
    d_rows = util.host(d_rows)
    w_rows = util.host(w_rows)
    degs = util.host(degs)
    b_dst = util.host(b_dst)
    b_wgt = util.host(b_wgt)
    b_del = util.host(b_del)
    a, w = d_rows.shape
    out_d = np.full((a, w), SENTINEL, np.int32)
    out_w = np.zeros((a, w), np.float32)
    counts = np.zeros(a, np.int32)
    for i in range(a):
        deg = int(degs[i])
        cur = dict(zip(d_rows[i, :deg].tolist(), w_rows[i, :deg].tolist()))
        for v, wt, dl in zip(b_dst[i].tolist(), b_wgt[i].tolist(), b_del[i].tolist()):
            if v == int(SENTINEL):
                continue
            if dl:
                cur.pop(v, None)
            else:
                cur[v] = wt
        keys = sorted(cur)
        counts[i] = len(keys)
        out_d[i, : len(keys)] = keys
        out_w[i, : len(keys)] = [cur[k] for k in keys]
    return out_d, out_w, counts
