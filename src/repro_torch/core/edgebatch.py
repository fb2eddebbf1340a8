"""EdgeBatch — a batch of edge updates ΔG (paper: "a batch of edges is
represented using DiGraph"; here a sorted, deduped, pow-2-padded COO).

The batch is the unit of the paper's union / subtraction operations.  It
is planned on the host (``core/updates.py``), so its arrays are numpy;
its capacity is pow-2 bucketed (alloc.py) as in ``repro``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import alloc, util


@dataclasses.dataclass(frozen=True)
class EdgeBatch:
    """src/dst/wgt sorted by (src, dst), deduped; slots >= n are SENTINEL."""

    src: np.ndarray  # int32 [CAP]
    dst: np.ndarray  # int32 [CAP]
    wgt: np.ndarray  # float32 [CAP]
    n: int           # live edges

    @property
    def capacity(self) -> int:
        return self.src.shape[0]

    def to_numpy(self):
        return self.src[: self.n], self.dst[: self.n], self.wgt[: self.n]

    def to_sets(self) -> set[tuple[int, int]]:
        s, d, _ = self.to_numpy()
        return set(zip(s.tolist(), d.tolist()))

    def max_vertex(self) -> int:
        s, d, _ = self.to_numpy()
        if s.shape[0] == 0:
            return -1
        return int(max(s.max(), d.max()))

    def row_counts(self, n_vertices: int) -> np.ndarray:
        s, _, _ = self.to_numpy()
        return np.bincount(s, minlength=n_vertices)


def _offending(mask: np.ndarray, limit: int = 5) -> str:
    """Render the first few True indices of a bad-element mask, e.g.
    ``indices [3, 17, 40] (+2 more)``."""
    idx = np.flatnonzero(mask)
    head = ", ".join(str(int(i)) for i in idx[:limit])
    more = f" (+{idx.size - limit} more)" if idx.size > limit else ""
    return f"indices [{head}]{more}"


def _validate_ids(arr, name: str) -> np.ndarray:
    """Coerce vertex ids to int32, rejecting anything that can't be one.

    Negative ids, ids >= INT32_MAX (the SENTINEL), non-integral floats
    and non-numeric dtypes all raise — silently wrapping them into the
    arena would corrupt rows far from the call site.
    """
    a = util.host(arr).reshape(-1)
    if a.dtype.kind == "f":
        bad = a != np.floor(a)
        if a.size and bool(bad.any()):
            raise ValueError(
                f"{name}: non-integral vertex ids at {_offending(bad)}: "
                f"{a[bad][:5].tolist()}"
            )
    elif a.dtype.kind not in "iu":
        raise TypeError(f"{name}: vertex ids must be integers, got {a.dtype}")
    if a.size:
        neg = a < 0
        if bool(neg.any()):
            raise ValueError(
                f"{name}: negative vertex ids at {_offending(neg)}: "
                f"{a[neg][:5].astype(np.int64).tolist()}"
            )
        big = a >= np.iinfo(np.int32).max
        if bool(big.any()):
            raise ValueError(
                f"{name}: vertex ids overflow int32 at {_offending(big)}: "
                f"{a[big][:5].astype(np.int64).tolist()}"
            )
    return a.astype(np.int32)


def dedup_arrays(src: np.ndarray, dst: np.ndarray, *values, keep: str = "first"):
    """(src, dst)-lexsort host arrays and drop duplicate keys.

    ``keep`` selects which duplicate survives ("first" or "last" in the
    original order); ``values`` ride along.
    """
    n = src.shape[0]
    if keep == "last":
        order = np.lexsort((-np.arange(n), dst, src))
    else:
        order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    values = tuple(v[order] for v in values)
    if n:
        uniq = np.concatenate(
            [[True], (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])]
        )
        src, dst = src[uniq], dst[uniq]
        values = tuple(v[uniq] for v in values)
    return (src, dst, *values)


def from_arrays(src, dst, wgt=None, *, dedup: bool = True,
                symmetric: bool = False) -> EdgeBatch:
    """Host-side constructor: validate, sort by (src,dst), dedup, pad pow-2."""
    src = _validate_ids(src, "src")
    dst = _validate_ids(dst, "dst")
    if src.shape[0] != dst.shape[0]:
        raise ValueError(
            f"src/dst length mismatch: src has {src.shape[0]} ids, "
            f"dst has {dst.shape[0]}"
        )
    if wgt is None:
        wgt = np.ones_like(src, dtype=np.float32)
    wgt = util.host(wgt).astype(np.float32).reshape(-1)
    if wgt.shape[0] != src.shape[0]:
        raise ValueError(
            f"wgt length mismatch: wgt has {wgt.shape[0]} weights for "
            f"{src.shape[0]} edges"
        )
    nonfinite = ~np.isfinite(wgt)
    if wgt.shape[0] and bool(nonfinite.any()):
        # NaN/inf weights would survive every merge unnoticed and poison
        # walk sums far from the call site
        raise ValueError(
            f"wgt: non-finite edge weights at {_offending(nonfinite)}: "
            f"{wgt[nonfinite][:5].tolist()}"
        )
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        wgt = np.concatenate([wgt, wgt])
    if dedup:
        src, dst, wgt = dedup_arrays(src, dst, wgt, keep="first")
    else:
        order = np.lexsort((dst, src))
        src, dst, wgt = src[order], dst[order], wgt[order]
    n = int(src.shape[0])
    cap = alloc.next_pow2(max(n, 1))
    pad = cap - n
    src = np.concatenate([src, np.full(pad, util.SENTINEL, np.int32)])
    dst = np.concatenate([dst, np.full(pad, util.SENTINEL, np.int32)])
    wgt = np.concatenate([wgt, np.zeros(pad, np.float32)])
    return EdgeBatch(src, dst, wgt, n)


def random_insertions(rng: np.random.Generator, n_vertices: int, count: int,
                      *, weighted_range=(1.0, 1.0)) -> EdgeBatch:
    """Paper §4.2.4: uniformly random vertex pairs."""
    src = rng.integers(0, n_vertices, size=count, dtype=np.int64)
    dst = rng.integers(0, n_vertices, size=count, dtype=np.int64)
    lo, hi = weighted_range
    wgt = rng.uniform(lo, hi, size=count).astype(np.float32)
    return from_arrays(src, dst, wgt)


def random_deletions(rng: np.random.Generator, csr, count: int) -> EdgeBatch:
    """Paper §4.2.3: uniformly sampled existing edges."""
    m = int(csr.m)
    count = min(count, m)
    pick = rng.choice(m, size=count, replace=False)
    rows = util.host(csr.row_ids())[pick]
    dsts = util.host(csr.dst)[pick]
    return from_arrays(rows, dsts)
