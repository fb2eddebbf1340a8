"""EmbeddingBag entry point: pow-2 bag padding, default weights, routing.

The counterpart of ``repro.kernels.embedding_bag.ops``.  ``backend=``
takes the place of ``repro``'s ``use_kernel``: ``"cuda"`` is the
hand-written kernel, ``"torch"`` its plain PyTorch version, ``"auto"``
picks by the table's device.
"""
from __future__ import annotations

import torch

from ...core import alloc, util
from . import kernel as _kernel
from . import ref as _ref


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, weights=None, *,
                  combine: str = "sum", backend: str = "auto") -> torch.Tensor:
    """EmbeddingBag over [n_bags, K] ragged index bags (-1 = padding).

    1-D ``indices`` are one bag.  K is padded to a power of two with -1
    ids and zero weights, as ``repro`` pads it; ``weights`` default to 1.
    """
    backend = util.resolve_backend(backend, table.device)
    if indices.ndim == 1:
        indices = indices[None]
    if weights is not None and weights.ndim == 1:
        weights = weights[None]
    k = indices.shape[-1]
    k_pad = alloc.next_pow2(max(k, 1))
    if k_pad != k:
        pad = torch.full(indices.shape[:-1] + (k_pad - k,), -1, dtype=indices.dtype,
                         device=indices.device)
        indices = torch.cat([indices, pad], dim=-1)
    if weights is None:
        weights = torch.ones(indices.shape, dtype=torch.float32, device=indices.device)
    elif weights.shape[-1] != k_pad:
        wpad = torch.zeros(weights.shape[:-1] + (k_pad - weights.shape[-1],),
                           dtype=torch.float32, device=weights.device)
        weights = torch.cat([weights.to(torch.float32), wpad], dim=-1)
    bag = _kernel.embedding_bag if backend == "cuda" else _kernel.embedding_bag_torch
    return bag(table, indices.to(torch.int32).contiguous(),
               weights.to(torch.float32).contiguous(), combine)


def embedding_bag_reference(table, indices, weights=None, *, combine: str = "sum"):
    if weights is None:
        weights = torch.ones(indices.shape, dtype=torch.float32, device=indices.device)
    return _ref.embedding_bag_reference(table, indices, weights, combine=combine)
