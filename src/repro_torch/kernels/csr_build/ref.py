"""Pure-numpy oracle for the CSR counting-sort build.

Deliberately naive per-edge semantics: count degrees with a python-level
histogram, prefix-sum offsets, and place every edge via the paper's
shifted-offset fill (Alg 5) — a per-row cursor that appends edges in
(src, dst) order.  The host and device engines in ``ops.py`` are tested
against this, as is the arena-image builder.
"""
from __future__ import annotations

import numpy as np

from ...core import util

SENTINEL = util.SENTINEL


def coo_to_csr_reference(src, dst, wgt=None, *, n: int, dedup: bool = False):
    """(src, dst[, wgt]) COO -> (offsets, dst, wgt) with sorted rows.

    Duplicate keys keep the FIRST occurrence's weight (file order).
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = (
        np.asarray(wgt, np.float32)
        if wgt is not None
        else np.ones(src.shape[0], np.float32)
    )
    rows: list[dict] = [dict() for _ in range(n)]
    for s, d, x in zip(src.tolist(), dst.tolist(), w.tolist()):
        r = rows[s]
        if dedup:
            r.setdefault(d, x)
        else:
            r.setdefault(d, []).append(x)
    out_d, out_w, degs = [], [], []
    for r in rows:
        items = sorted(r.items())
        if dedup:
            degs.append(len(items))
            out_d.extend(k for k, _ in items)
            out_w.extend(v for _, v in items)
        else:
            deg = 0
            for k, vs in items:
                for v in vs:
                    out_d.append(k)
                    out_w.append(v)
                    deg += 1
            degs.append(deg)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(degs, out=offsets[1:])
    return (
        offsets.astype(np.int32),
        np.asarray(out_d, np.int32),
        np.asarray(out_w, np.float32),
    )


def count_degrees_reference(src, n: int) -> np.ndarray:
    """Per-vertex out-degree histogram (the Alg 5 degree-count oracle)."""
    deg = np.zeros(n, np.int64)
    for s in np.asarray(src, np.int64).tolist():
        if 0 <= s < n:
            deg[s] += 1
    return deg


def arena_image_reference(offsets, dst, wgt, starts, caps, cap_e, cap_v):
    """CSR -> slotted arena image, one edge at a time (DiGraph layout)."""
    o = np.asarray(offsets, np.int64)
    d = np.asarray(dst, np.int64)
    w = np.asarray(wgt, np.float32)
    a_dst = np.full(cap_e, SENTINEL, np.int32)
    a_wgt = np.zeros(cap_e, np.float32)
    a_rows = np.full(cap_e, cap_v, np.int32)
    for u in range(o.shape[0] - 1):
        if caps[u] <= 0:
            continue
        for k in range(int(caps[u])):
            a_rows[int(starts[u]) + k] = u
        for j in range(int(o[u]), int(o[u + 1])):
            slot = int(starts[u]) + (j - int(o[u]))
            a_dst[slot] = d[j]
            a_wgt[slot] = w[j]
    return a_dst, a_wgt, a_rows
