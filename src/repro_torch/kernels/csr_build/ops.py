"""COO → CSR → arena construction engines (DESIGN.md §10).

The paper's Alg 5 structure (partitioned degree count + shifted-offset
fill) as a counting-sort build with three engines:

  host    pack (src, dst) into ONE int64 key and radix argsort it
          (``np.argsort(kind="stable")``); degrees from a partitioned
          bincount, offsets from one cumsum, and the sorted order IS the
          shifted-offset fill.  Inputs already in (src, dst) order skip
          the sort.
  cuda    the device build: a stable ``torch.sort`` on the packed key
          (skipped for inputs already in (src, dst) order), then the CSR
          offsets read off the sorted sources by the hand-written
          ``degree_offsets`` CUDA kernel (``kernel.py``).  The
          counterpart of ``repro``'s ``pallas`` engine.
  torch   the same device build with the plain PyTorch offsets (the
          counterpart of ``repro``'s ``xla`` engine; runs on any device).

``arena_image`` builds the DiGraph slotted-arena payload (dst/wgt/
slot_rows) straight from CSR arrays — a numpy fill and one transfer
(``host``), or a plain PyTorch fill on the target device (``torch``).
``flat_image`` builds the padded flat COO that SortedCOO and LazyCSR
keep, ``pages_image_host`` ChunkedGraph's page pool.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import util
from . import kernel as _kernel

SENTINEL = util.SENTINEL
ENGINES = ("host", "cuda", "torch")


def default_engine(device: torch.device) -> str:
    """Build engine for a CSR that will live on ``device``."""
    return "cuda" if device.type == "cuda" else "host"


# ---------------------------------------------------------------------------
# degree counting (paper Alg 5 lines 4-8)
# ---------------------------------------------------------------------------
def count_degrees(src, n: int, *, num_partitions: int = 4, engine: str = "host"):
    """Per-vertex degree histogram; out-of-range sources are dropped.

    ``host`` keeps the paper's per-partition counting shape (partial
    bincounts summed) and returns int64 numpy.  ``cuda`` (the kernel) and
    ``torch`` (its plain version) take an int32 tensor and return an
    int32 tensor on its device.
    """
    if engine == "host":
        s = util.host(src).astype(np.int64)
        s = s[(s >= 0) & (s < n)]
        rho = max(int(num_partitions), 1)
        bounds = np.linspace(0, s.shape[0], rho + 1).astype(np.int64)
        deg = np.zeros(n, np.int64)
        for p in range(rho):
            deg += np.bincount(s[bounds[p]:bounds[p + 1]], minlength=n)
        return deg
    if engine not in ENGINES:
        raise ValueError(f"unknown csr_build engine: {engine!r}")
    src = torch.as_tensor(src, dtype=torch.int32)
    if util.resolve_backend(engine, src.device) == "cuda":
        return _kernel.count_degrees(src, n)
    return _kernel.count_degrees_torch(src, n)


# ---------------------------------------------------------------------------
# the counting-sort CSR fill
# ---------------------------------------------------------------------------
def is_coo_sorted(src: np.ndarray, dst: np.ndarray) -> bool:
    """True when edges are already in (src, dst) order (CSR-order file)."""
    if src.shape[0] < 2:
        return True
    key = (src.astype(np.int64) << 32) | dst.astype(np.uint32).astype(np.int64)
    return bool((key[1:] >= key[:-1]).all())


def sort_coo_host(src: np.ndarray, dst: np.ndarray, *values: np.ndarray):
    """Stable (src, dst) order via ONE packed-key radix argsort.

    Stability preserves file order among duplicate keys (the
    dedup-keep-first contract).
    """
    key = (src.astype(np.int64) << 32) | dst.astype(np.uint32).astype(np.int64)
    order = np.argsort(key, kind="stable")
    return (src[order], dst[order], *(v[order] for v in values))


def sort_coo_device(src: torch.Tensor, dst: torch.Tensor, *values: torch.Tensor):
    """Stable (src, dst) order on the tensors' device: one packed-key sort.

    The sorted int32 ids are the sorted key's two words (little-endian:
    the low word is dst, the high word src), so only ``values`` are
    gathered.
    """
    key = (src.to(torch.int64) << 32) | (dst.to(torch.int64) & 0xFFFFFFFF)
    key_s, order = torch.sort(key, stable=True)
    del key
    words = key_s.view(torch.int32)
    return (words[1::2].contiguous(), words[0::2].contiguous(), *(v[order] for v in values))


def degree_offsets(src_s, n: int, *, engine: str = "torch"):
    """CSR offsets [n + 1] int32 of sorted int32 sources on their device:
    the ``degree_offsets`` kernel (``cuda``) or its plain version
    (``torch``).  Out-of-range sources move ``offsets[0]`` off 0 or
    ``offsets[n]`` off M."""
    if engine not in ("cuda", "torch"):
        raise ValueError(f"degree_offsets: engine must be 'cuda' or 'torch', got {engine!r}")
    if util.resolve_backend(engine, src_s.device) == "cuda":
        return _kernel.degree_offsets(src_s, n)
    return _kernel.degree_offsets_torch(src_s, n)


def coo_to_csr_device(src, dst, wgt, *, n: int, engine: str, presorted: bool = False):
    """Device counting-sort build -> (offsets, src_s, dst_s, wgt_s).

    ``src``/``dst`` are int32 and ``wgt`` f32 tensors on one device.  The
    stable sort brings the edges into (src, dst) order (``presorted``
    inputs skip it); the offsets are then read off the sorted sources'
    run boundaries.  Offsets are int32 [n + 1].
    """
    if presorted:
        src_s, dst_s, wgt_s = src, dst, wgt
    else:
        src_s, dst_s, wgt_s = sort_coo_device(src, dst, wgt)
    return degree_offsets(src_s, n, engine=engine), src_s, dst_s, wgt_s


# ---------------------------------------------------------------------------
# CSR -> DiGraph arena image (the paper's load-into-representation step)
# ---------------------------------------------------------------------------
def arena_image_host(offsets, dst, wgt, starts, caps, cap_e: int, cap_v: int):
    """Numpy shifted-offset fill of the slotted arena (single pass each).

    ``starts``/``caps`` are the host CP2AA block placement; every edge
    lands at ``starts[row] + (edge_idx - offsets[row])`` and every block
    slot records its owning row.
    """
    o = np.asarray(offsets, np.int64)
    deg = np.diff(o)
    n = deg.shape[0]
    total = int(caps[:n].sum())
    m = int(o[-1])
    a_dst = np.full(cap_e, SENTINEL, np.int32)
    a_wgt = np.zeros(cap_e, np.float32)
    a_rows = np.full(cap_e, cap_v, np.int32)
    if m:
        gidx = np.repeat(starts[:n].clip(0), deg) + (
            np.arange(m) - np.repeat(o[:-1], deg)
        )
        a_dst[gidx] = np.asarray(dst)[:m]
        a_wgt[gidx] = np.asarray(wgt)[:m]
    if total:
        a_rows[:total] = np.repeat(
            np.arange(n, dtype=np.int32), caps[:n].astype(np.int64)
        )
    return a_dst, a_wgt, a_rows


def arena_image_device(offsets, dst, wgt, starts, caps, cap_e: int,
                       cap_v: int, *, total: int, device):
    """Plain PyTorch arena fill on ``device``: expand rows, scatter edges,
    paint block owners by a searchsorted into the block-end cumsum."""
    dev = torch.device(device)
    o = torch.as_tensor(offsets, device=dev).to(torch.int64)
    d = torch.as_tensor(dst, device=dev).to(torch.int32)
    w = torch.as_tensor(wgt, device=dev).to(torch.float32)
    st = torch.as_tensor(np.asarray(starts, np.int64), device=dev)
    cp = torch.as_tensor(np.asarray(caps, np.int64), device=dev)
    n = o.shape[0] - 1
    m = d.shape[0]
    a_dst = torch.full((cap_e + 1,), int(SENTINEL), dtype=torch.int32, device=dev)
    a_wgt = torch.zeros(cap_e + 1, dtype=torch.float32, device=dev)
    if m and n:
        row = util.expand_rows(o, m).to(torch.int64)
        ok = row < n
        rc = row.clamp(0, n - 1)
        edge = torch.arange(m, dtype=torch.int64, device=dev)
        slot = torch.where(ok, st[rc] + (edge - o[rc]), cap_e)
        a_dst[slot] = d
        a_wgt[slot] = w
    pos = torch.arange(cap_e, dtype=torch.int64, device=dev)
    owner = torch.searchsorted(torch.cumsum(cp, 0), pos, right=True)
    a_rows = torch.where(pos < total, owner.clamp(max=cap_v), cap_v)
    return a_dst[:cap_e], a_wgt[:cap_e], a_rows.to(torch.int32)


def arena_image(offsets, dst, wgt, starts, caps, cap_e: int, cap_v: int,
                *, total: int, device, engine: str = "auto"):
    """Arena build; returns (dst, wgt, slot_rows) tensors on ``device``.

    ``auto`` fills on the device when it is a GPU (``torch``) and on the
    host otherwise (``host``, one transfer).
    """
    dev = torch.device(device)
    if engine == "auto":
        engine = "torch" if dev.type == "cuda" else "host"
    if engine == "host":
        out = arena_image_host(
            util.host(offsets), util.host(dst), util.host(wgt),
            util.host(starts), util.host(caps), cap_e, cap_v,
        )
        return tuple(torch.from_numpy(a).to(dev) for a in out)
    if engine != "torch":
        raise ValueError(f"unknown arena_image engine: {engine!r}")
    return arena_image_device(
        offsets, dst, wgt, starts, caps, cap_e, cap_v, total=total, device=dev
    )


# ---------------------------------------------------------------------------
# CSR -> flat padded COO image (SortedCOO / LazyCSR base arrays)
# ---------------------------------------------------------------------------
def flat_image(offsets, dst, wgt, cap: int, *, device):
    """(row_ids, dst, wgt) tensors on ``device``, padded to ``cap`` slots
    (SENTINEL ids, zero weights): the row-major flat layout SortedCOO and
    LazyCSR share, filled on the device."""
    dev = torch.device(device)
    o = torch.as_tensor(offsets).to(dev, torch.int64)
    d = torch.as_tensor(dst).to(dev, torch.int32)
    w = torch.as_tensor(wgt).to(dev, torch.float32)
    m = int(d.shape[0])
    rows = torch.full((cap,), int(SENTINEL), dtype=torch.int32, device=dev)
    out_d = torch.full((cap,), int(SENTINEL), dtype=torch.int32, device=dev)
    out_w = torch.zeros(cap, dtype=torch.float32, device=dev)
    rows[:m] = util.expand_rows(o, m)
    out_d[:m] = d
    out_w[:m] = w
    return rows, out_d, out_w


# ---------------------------------------------------------------------------
# CSR -> ChunkedGraph page image (same fill, PAGE-quantized blocks)
# ---------------------------------------------------------------------------
def pages_image_host(offsets, dst, wgt, page_base, npages, page: int,
                     p_cap: int, n_sentinel: int):
    """Page-pool image (numpy): edges land at page_base[row]*page + the
    intra-row index; pages past the used ones are SENTINEL, owned by
    ``n_sentinel``."""
    o = util.host(offsets).astype(np.int64)
    deg = np.diff(o)
    n = deg.shape[0]
    m = int(o[-1])
    pages_d = np.full(p_cap * page, SENTINEL, np.int32)
    pages_w = np.zeros(p_cap * page, np.float32)
    owner = np.full(p_cap, n_sentinel, np.int32)
    if m:
        gidx = np.repeat(page_base[:n] * page, deg) + (
            np.arange(m) - np.repeat(o[:-1], deg)
        )
        pages_d[gidx] = util.host(dst)[:m]
        pages_w[gidx] = util.host(wgt)[:m]
    total_pages = int(npages[:n].sum())
    if total_pages:
        owner[:total_pages] = np.repeat(
            np.arange(n, dtype=np.int32), npages[:n].astype(np.int64)
        )
    return (
        pages_d.reshape(p_cap, page),
        pages_w.reshape(p_cap, page),
        owner,
    )
