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
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got {device}")
    return backend


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


def expand_rows(offsets: torch.Tensor, total: int) -> torch.Tensor:
    """CSR offsets [N+1] -> row id per edge slot [total] (searchsorted)."""
    pos = torch.arange(total, dtype=offsets.dtype, device=offsets.device)
    return (torch.searchsorted(offsets, pos, right=True) - 1).to(torch.int32)
