"""Shared tensor utilities for the graph representations (PyTorch port).

Besides the sentinels and the padded-row helpers of ``repro.core.util``,
this module owns the port's two placement rules:

* ``resolve_device``: entry points take ``device=`` and default to
  ``"cuda"``; asking for the card on a machine without one raises instead
  of quietly running on the CPU.
* ``resolve_backend``: ``"auto"`` picks the hand-written CUDA kernels for
  CUDA tensors and the plain PyTorch versions for CPU tensors; ``"torch"``
  forces the plain versions on either device (the reference on the card).
"""
from __future__ import annotations

import numpy as np
import torch

# Sentinel marking empty edge slots.  INT32_MAX sorts after every valid
# vertex id, so ascending sorts push padding to the row tail for free.
SENTINEL = np.int32(np.iinfo(np.int32).max)
# GraphBLAS-style zombie marker for lazily-deleted edges (LazyCSR).
ZOMBIE = np.int32(np.iinfo(np.int32).max - 1)

BACKENDS = ("auto", "cuda", "torch")


def resolve_device(device) -> torch.device:
    """``device=`` argument -> ``torch.device``; CUDA must be present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the host"
        )
    return dev


def resolve_backend(backend: str, device: torch.device) -> str:
    """Kernel backend for tensors on ``device``: ``"cuda"`` or ``"torch"``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend == "cuda" and device.type != "cuda" and not _fake_mode_active():
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got {device}")
    return backend


def _fake_mode_active() -> bool:
    """Whether a ``FakeTensorMode`` is active: the dry run traces the
    kernels' custom ops through their fake bodies, on any device."""
    from torch._guards import detect_fake_mode

    return detect_fake_mode() is not None


def host(x) -> np.ndarray:
    """Any array or tensor -> numpy (copies device tensors to the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def fused_copy(*tensors):
    """Deep-copy device buffers: one ``.clone()`` per buffer, no sync."""
    return tuple(t.clone() for t in tensors)


def cow_detach(obj, sealed: set, names) -> None:
    """Per-buffer copy-on-write detach (DESIGN.md §10).

    Torch tensors are mutable, so a buffer shared with a snapshot must be
    copied before the owner writes into it in place.  Copies the named
    attribute buffers of ``obj`` that are still in ``sealed`` and marks
    them private; buffers the caller will not write stay shared.
    """
    need = [n for n in names if n in sealed]
    if not need:
        return
    copies = fused_copy(*(getattr(obj, n) for n in need))
    for n, c in zip(need, copies):
        setattr(obj, n, c)
        sealed.discard(n)


def rows_to_padded(flat_vals: torch.Tensor, starts: torch.Tensor,
                   lengths: torch.Tensor, width: int, fill) -> torch.Tensor:
    """Gather variable-length row segments of a flat buffer into [R, width].

    Slots >= length are ``fill``.  Out-of-range gathers are clamped (their
    lanes are masked anyway).
    """
    lane = torch.arange(width, dtype=torch.int64, device=flat_vals.device)
    idx = starts.to(torch.int64)[:, None] + lane[None, :]
    mask = lane[None, :] < lengths.to(torch.int64)[:, None]
    vals = flat_vals[idx.clamp(0, flat_vals.shape[0] - 1)]
    return torch.where(mask, vals, torch.full_like(vals, fill))


def scatter_padded_rows(flat_vals: torch.Tensor, rows: torch.Tensor,
                        starts: torch.Tensor, width_mask: torch.Tensor):
    """Scatter padded rows [R, K] back into a copy of ``flat_vals``.

    Lanes where ``width_mask`` is False are dropped (left unchanged).
    """
    k = rows.shape[1]
    lane = torch.arange(k, dtype=torch.int64, device=flat_vals.device)
    idx = starts.to(torch.int64)[:, None] + lane[None, :]
    out = flat_vals.clone()
    out[idx[width_mask]] = rows[width_mask]
    return out


def lexsort2(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Order sorting by (primary, secondary), both int arrays; stable.

    Equivalent to ``np.lexsort((secondary, primary))``.  int32 pairs sort
    as ONE packed int64 key (``secondary`` offset by 2^31 so negative ids
    keep their order); wider ids take two stable argsorts.
    """
    if primary.dtype == torch.int32 and secondary.dtype == torch.int32:
        key = (primary.to(torch.int64) << 32) + (secondary.to(torch.int64) + 2**31)
        return torch.argsort(key, stable=True)
    order = torch.argsort(secondary, stable=True)
    return order[torch.argsort(primary[order], stable=True)]


def dedup_sorted_rows(keys: torch.Tensor, *values: torch.Tensor):
    """Row-wise dedup of key-sorted 2D tensors, compacting to the left.

    ``keys``: [R, K] int32, each row ascending with SENTINEL padding.
    Duplicate keys (after the first occurrence) become SENTINEL and the
    rows are re-sorted so live entries stay contiguous; ``values`` ride
    the same permutation.  Returns (keys, *values, counts).
    """
    prev = torch.cat([torch.full((keys.shape[0], 1), -1, dtype=keys.dtype,
                                 device=keys.device), keys[:, :-1]], dim=1)
    masked = torch.where(keys == prev, int(SENTINEL), keys)
    order = torch.argsort(masked, dim=1, stable=True)
    keys_out = torch.gather(masked, 1, order)
    vals_out = tuple(torch.gather(v, 1, order) for v in values)
    counts = (keys_out != int(SENTINEL)).sum(dim=1).to(torch.int32)
    return (keys_out, *vals_out, counts)


def searchsorted_rows(rows: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Per-row searchsorted (left): rows [R, K] ascending, queries [R, Q]."""
    return torch.searchsorted(rows.contiguous(), queries.contiguous())


def row_contains(rows: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Membership of queries [R, Q] in sorted rows [R, K] -> bool [R, Q]."""
    pos = searchsorted_rows(rows, queries).clamp(0, rows.shape[1] - 1)
    found = torch.gather(rows, 1, pos) == queries
    return found & (queries != int(SENTINEL))


def segment_sum(vals: torch.Tensor, segment_ids: torch.Tensor, num: int) -> torch.Tensor:
    """Sum ``vals`` rows into ``num`` segments; ids outside [0, num) drop."""
    ids = segment_ids.to(torch.int64)
    ok = (ids >= 0) & (ids < num)
    out = torch.zeros((num, *vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids[ok], vals[ok])


def coo_sort(src: torch.Tensor, dst: torch.Tensor, *values: torch.Tensor):
    """Sort COO edges by (src, dst); carries values. Stable."""
    order = lexsort2(src, dst)
    return (src[order], dst[order], *(v[order] for v in values))


def coo_dedup_mask(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """For (src, dst)-sorted COO: True where the entry is the FIRST of its key."""
    first = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    first[1:] = ~((src[1:] == src[:-1]) & (dst[1:] == dst[:-1]))
    return first


def binsearch_window(flat: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     queries: torch.Tensor):
    """Per-query binary search in windows of a flat sorted buffer.

    ``flat`` is ascending within each window [lo_i, hi_i).  Returns
    (pos, found): ``pos`` is the leftmost index in the window with
    flat[pos] >= q, ``found`` whether flat[pos] == q.  Vectorized over
    the queries; 32 halvings cover int32 windows.
    """
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    if flat.shape[0] == 0:
        return lo, torch.zeros(queries.shape, dtype=torch.bool, device=queries.device)
    last = flat.shape[0] - 1
    l, h = lo, hi
    for _ in range(32):
        mid = (l + h) // 2
        go_right = flat[mid.clamp(0, last)] < queries
        open_ = l < h
        l, h = (torch.where(go_right & open_, mid + 1, l),
                torch.where(go_right | ~open_, h, mid))
    found = (l < hi) & (flat[l.clamp(0, last)] == queries)
    return l, found


def pair_keys(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(src, dst) int32 id pairs -> int64 keys in lexicographic order.

    Ids are non-negative and at most SENTINEL, so ``src << 32 | dst`` sorts
    like the pair and SENTINEL pairs sort last.
    """
    return (src.to(torch.int64) << 32) | dst.to(torch.int64)


def searchsorted_2d(s_sorted: torch.Tensor, d_sorted: torch.Tensor,
                    qs: torch.Tensor, qd: torch.Tensor):
    """Binary search for (qs, qd) pairs in a (src, dst)-lexsorted COO.

    One ``torch.searchsorted`` over packed int64 keys (``pair_keys``).
    Returns (pos, found) like ``binsearch_window``: ``pos`` is the leftmost
    slot whose pair is >= the query.
    """
    n = s_sorted.shape[0]
    keys = pair_keys(s_sorted, d_sorted)
    q = pair_keys(qs, qd)
    pos = torch.searchsorted(keys, q)
    if n == 0:
        return pos, torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    return pos, (pos < n) & (keys[pos.clamp(max=n - 1)] == q)


def expand_rows(offsets: torch.Tensor, total: int) -> torch.Tensor:
    """CSR offsets [N+1] -> row id per edge slot [total] (searchsorted)."""
    pos = torch.arange(total, dtype=offsets.dtype, device=offsets.device)
    return (torch.searchsorted(offsets, pos, right=True) - 1).to(torch.int32)
