"""EmbeddingBag entry point: pow-2 bag padding, default weights, routing.

The counterpart of ``repro.kernels.embedding_bag.ops``.  ``backend=``
takes the place of ``repro``'s ``use_kernel``: ``"cuda"`` is the
hand-written kernel, ``"torch"`` its plain PyTorch version, ``"auto"``
picks by the table's device.

The op is differentiable in the table for ``sum`` and ``mean``: the
forward is the bag (the kernel on CUDA tensors, its plain version on CPU
tensors), the backward plain PyTorch (``repro`` has no backward kernel
either: its train path is the jnp bag).  The table's grad is one
``index_add_`` of each slot's ``weight · grad_out[bag]`` (mean: divided by
the bag's valid count; 0 for a padding slot) into a dense zero table, in
the order autograd through the plain gather adds them; the weights get no
grad.
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
    indices = indices.to(torch.int32).contiguous()
    weights = weights.to(torch.float32).contiguous()
    if table.requires_grad and torch.is_grad_enabled():
        return _Bag.apply(table, indices, weights, combine, backend)
    return _bag(table, indices, weights, combine, backend)


def _bag(table, indices, weights, combine, backend):
    bag = _kernel.embedding_bag_op if backend == "cuda" else _kernel.embedding_bag_torch
    return bag(table, indices, weights, combine)


class _Bag(torch.autograd.Function):
    """The bag forward, its table grad in plain PyTorch."""

    @staticmethod
    def forward(ctx, table, indices, weights, combine, backend):
        if combine not in ("sum", "mean"):
            raise NotImplementedError(f"embedding_bag: no backward for combine={combine!r}")
        ctx.save_for_backward(indices, weights)
        ctx.combine, ctx.shape = combine, table.shape
        return _bag(table, indices, weights, combine, backend)

    @staticmethod
    def backward(ctx, grad_out):
        indices, weights = ctx.saved_tensors
        valid = indices >= 0
        g = grad_out
        if ctx.combine == "mean":
            g = g / torch.clamp(valid.sum(dim=1, keepdim=True), min=1)
        # every slot, bag-major; a padding slot adds 0 to row 0 (no host
        # round trip to pick the valid ones)
        rows = torch.clamp(indices.long(), 0, ctx.shape[0] - 1).reshape(-1)
        contrib = g[:, None, :] * torch.where(valid, weights, 0.0)[..., None]
        grad = torch.zeros(ctx.shape, dtype=grad_out.dtype, device=grad_out.device)
        grad.index_add_(0, rows, contrib.reshape(-1, ctx.shape[1]))
        return grad, None, None, None, None


def embedding_bag_reference(table, indices, weights=None, *, combine: str = "sum"):
    if weights is None:
        weights = torch.ones(indices.shape, dtype=torch.float32, device=indices.device)
    return _ref.embedding_bag_reference(table, indices, weights, combine=combine)
