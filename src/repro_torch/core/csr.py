"""CSR container + builders.

This is the *static* representation every dynamic representation converts
to/from; traversal oracles run on it.  Builders mirror the paper's Alg 5
convertToCsr(): partitioned degree counting + shifted-offset fill.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import util


@dataclasses.dataclass(frozen=True)
class CSR:
    """offsets[N+1] int32, dst[M] int32, wgt[M] f32 (optional) tensors."""

    offsets: torch.Tensor
    dst: torch.Tensor
    wgt: Optional[torch.Tensor]
    n: int
    m: int

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    @property
    def degrees(self) -> torch.Tensor:
        return (self.offsets[1:] - self.offsets[:-1]).to(torch.int32)

    def degree(self, u: int) -> int:
        return int(self.offsets[u + 1] - self.offsets[u])

    def edges_of(self, u: int) -> np.ndarray:
        o = util.host(self.offsets)
        return util.host(self.dst[o[u]: o[u + 1]])

    def row_ids(self) -> torch.Tensor:
        """Row id per edge (for segment ops)."""
        return util.expand_rows(self.offsets, self.dst.shape[0])

    def to_dense(self) -> np.ndarray:
        """Dense adjacency (tests only)."""
        a = np.zeros((self.n, self.n), dtype=np.float32)
        o = util.host(self.offsets)
        d = util.host(self.dst)
        w = util.host(self.wgt) if self.wgt is not None else np.ones_like(d, np.float32)
        for u in range(self.n):
            a[u, d[o[u]: o[u + 1]]] = w[o[u]: o[u + 1]]
        return a

    def to_edge_sets(self) -> list[set[int]]:
        o = util.host(self.offsets)
        d = util.host(self.dst)
        return [set(d[o[u]: o[u + 1]].tolist()) for u in range(self.n)]


def from_coo(
    src,
    dst,
    wgt=None,
    *,
    n: Optional[int] = None,
    num_partitions: int = 4,
    dedup: bool = True,
    sort: bool = True,
    engine: str = "auto",
    presorted: Optional[bool] = None,
    device="cuda",
) -> CSR:
    """Build a CSR on ``device`` from COO arrays via the counting sort (Alg 5).

    ``engine`` selects the ``kernels/csr_build`` backend: ``host``
    (packed-key radix argsort in numpy), ``cuda`` (device sort + the
    ``degree_offsets`` CUDA kernel) or ``torch`` (device sort + the plain
    offsets); ``auto`` picks ``cuda`` for a CUDA device and ``host``
    otherwise.  The device engines build sorted, non-deduplicated CSRs
    (``sort and not dedup``); every other request takes the host engine,
    as in ``repro``.  ``presorted=True`` says the edges are already in
    (src, dst) order (an MTX file in CSR order): every engine then skips
    its sort; ``None`` means unknown (the host engine checks, the device
    engines sort).  Ids given as tensors already on a CUDA ``device``
    (with ``n``) go to a device engine's build as they are, without a
    copy through the host.
    """
    from ..kernels.csr_build import ops as _build_ops

    dev = util.resolve_device(device)
    if (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
            and src.device == dst.device == dev and dev.type != "cpu"
            and sort and not dedup and engine != "host" and n is not None):
        # ids already on the card: the device build reads them there, with
        # no round trip through the host
        w_t = None if wgt is None else torch.as_tensor(wgt, dtype=torch.float32, device=dev)
        return _build_device(src.to(torch.int32), dst.to(torch.int32), w_t, n=int(n),
                             engine=_build_ops.default_engine(dev) if engine == "auto"
                             else engine, presorted=bool(presorted))
    src = np.asarray(util.host(src), dtype=np.int64)
    dst_a = np.asarray(util.host(dst), dtype=np.int64)
    w = np.asarray(util.host(wgt), dtype=np.float32) if wgt is not None else None
    if n is None:
        n = int(max(src.max(initial=-1), dst_a.max(initial=-1)) + 1)
    if engine == "auto":
        engine = _build_ops.default_engine(dev)
    if engine not in _build_ops.ENGINES:
        raise ValueError(f"unknown csr_build engine: {engine!r}")

    if engine != "host" and sort and not dedup:
        return _from_coo_device(src, dst_a, w, n=int(n), engine=engine, device=dev,
                                presorted=bool(presorted))

    # shifted-offset fill: a stable counting sort realizes the same
    # placement the paper achieves with atomic offset increments.  Inputs
    # already in (src, dst) order skip the sort and read offsets straight
    # off the sorted runs.  ``presorted`` lets the caller pass an order
    # observation made elsewhere; None means detect here.
    if presorted is None:
        presorted = sort and _build_ops.is_coo_sorted(src, dst_a)
    else:
        presorted = bool(presorted) and sort
    if presorted:
        src_s, dst_s, w_s = src, dst_a, w
    elif sort:
        src_s, dst_s, *wrest = (
            _build_ops.sort_coo_host(src, dst_a, w)
            if w is not None
            else _build_ops.sort_coo_host(src, dst_a)
        )
        w_s = wrest[0] if w is not None else None
    else:
        order = np.argsort(src, kind="stable")
        src_s, dst_s = src[order], dst_a[order]
        w_s = w[order] if w is not None else None

    if (presorted and not dedup) or (dedup and sort and src_s.shape[0]):
        # offsets come straight off the sorted runs, or the dedup pass
        # below recounts
        degrees = None
    else:
        # per-partition degree counting (Alg 5: degrees[0] += degrees[p])
        degrees = _build_ops.count_degrees(
            src, int(n), num_partitions=num_partitions, engine="host"
        )

    if dedup and sort and src_s.shape[0]:
        keep = np.concatenate(
            [[True], (src_s[1:] != src_s[:-1]) | (dst_s[1:] != dst_s[:-1])]
        )
        src_s, dst_s = src_s[keep], dst_s[keep]
        w_s = w_s[keep] if w_s is not None else None
        degrees = np.bincount(src_s, minlength=n)

    if degrees is None:
        offsets = np.searchsorted(src_s, np.arange(n + 1, dtype=np.int64))
    else:
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(degrees, out=offsets[1:])
    # out-of-range ids (negative or >= n) fall out of both the degree
    # histogram and the searchsorted window: fail loudly instead of
    # emitting a CSR whose offsets orphan edges
    if int(offsets[0]) != 0 or int(offsets[-1]) != int(src_s.shape[0]):
        raise ValueError("from_coo: source id out of range [0, n)")
    return CSR(
        offsets=torch.from_numpy(offsets.astype(np.int32)).to(dev),
        dst=torch.from_numpy(dst_s.astype(np.int32)).to(dev),
        wgt=torch.from_numpy(w_s.astype(np.float32)).to(dev) if w_s is not None else None,
        n=int(n),
        m=int(dst_s.shape[0]),
    )


def _from_coo_device(src, dst, wgt, *, n: int, engine: str, device,
                     presorted: bool = False) -> CSR:
    """Device counting-sort build: the host conversions, the host→device
    copies, then the build on the device (sort, offsets, range check)."""
    s, d, w = _coo_int32(src, dst, wgt)
    s, d, w = _to_device(s, d, w, device=device)
    return _build_device(s, d, w, n=n, engine=engine, presorted=presorted)


def _coo_int32(src, dst, wgt):
    """Host COO -> the device build's types: int32 ids, f32 weights."""
    return (
        src.astype(np.int32),
        dst.astype(np.int32),
        wgt.astype(np.float32, copy=False) if wgt is not None else None,
    )


def _to_device(*arrays, device):
    """Host arrays -> tensors on ``device`` (None stays None)."""
    return tuple(None if a is None else torch.from_numpy(a).to(device) for a in arrays)


def _build_device(src, dst, wgt, *, n: int, engine: str, presorted: bool) -> CSR:
    """The build on the tensors' device; ``wgt`` None builds unit weights
    for the sort and leaves the CSR unweighted."""
    from ..kernels.csr_build import ops as _build_ops

    m = int(src.shape[0])
    w = wgt if wgt is not None else torch.ones(m, dtype=torch.float32, device=src.device)
    offsets, _, dst_s, wgt_s = _build_ops.coo_to_csr_device(
        src, dst, w, n=n, engine=engine, presorted=presorted
    )
    # same loud failure as the host engine: sorted ids below 0 move
    # offsets[0] off 0 and ids >= n move offsets[n] off m — a 2-element
    # readback guards against silently orphaned edges
    ends = util.host(offsets[[0, n]])
    if int(ends[0]) != 0 or int(ends[1]) != m:
        raise ValueError("from_coo: source id out of range [0, n)")
    return CSR(
        offsets=offsets,
        dst=dst_s,
        wgt=wgt_s if wgt is not None else None,
        n=n,
        m=m,
    )


def from_dense(a, *, device="cuda") -> CSR:
    """Dense adjacency (numpy) -> CSR on ``device``: nonzeros are edges,
    their values the weights."""
    a = np.asarray(a)
    src, dst = np.nonzero(a)
    return from_coo(src, dst, a[src, dst], n=a.shape[0], device=device)


def from_sorted(src: torch.Tensor, dst: torch.Tensor, wgt: torch.Tensor, n: int) -> CSR:
    """CSR of unique, (src, dst)-sorted edge tensors, on their device: the
    offsets are read off the sorted sources (what ``from_coo`` with
    ``dedup=False`` builds from such edges, without the host round trip)."""
    ids = torch.arange(n + 1, dtype=src.dtype, device=src.device)
    offsets = torch.searchsorted(src, ids).to(torch.int32)
    return CSR(offsets=offsets, dst=dst.to(torch.int32), wgt=wgt.to(torch.float32),
               n=int(n), m=int(src.shape[0]))


def validate(csr: CSR) -> None:
    """Invariant checks (tests): offsets monotone, rows sorted unique."""
    o = util.host(csr.offsets)
    d = util.host(csr.dst)
    assert o[0] == 0 and o[-1] == d.shape[0] == csr.m
    assert (np.diff(o) >= 0).all()
    for u in range(csr.n):
        row = d[o[u]: o[u + 1]]
        assert (np.diff(row) > 0).all(), f"row {u} not sorted-unique"
        assert ((row >= 0) & (row < csr.n)).all()
