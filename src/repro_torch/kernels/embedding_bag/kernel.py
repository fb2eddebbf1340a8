"""EmbeddingBag's gather-and-reduce kernel.

``embedding_bag`` reduces each bag of table rows (weighted sum, mean or
max) in one launch (``csrc/embedding_bag.cu``).  It replaces the TPU kernel
``repro/kernels/embedding_bag/kernel.py::embedding_bag`` (a scalar-prefetch
grid that DMAs one table row a step).

The wrapper launches the CUDA kernel for CUDA tensors and uses its plain
PyTorch version (``embedding_bag_torch``) only for CPU tensors; its
``launches`` attribute counts kernel launches.  ``embedding_bag_op`` is the
wrapper as a ``torch.library`` custom op (``repro_torch::embedding_bag``),
the form the two-tower model calls: its fake body gives [B, D] float32 to
fake tensors, its flop formula is 2·B·K·D (every slot valid: the count
``chip_smoke.py`` takes from its data, which a shape cannot see).
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build

COMBINES = ("sum", "mean", "max")


def embedding_bag_torch(table: torch.Tensor, indices: torch.Tensor,
                        weights: torch.Tensor, combine: str = "sum") -> torch.Tensor:
    """Plain version: one [B, D] gather per bag slot, reduced slot by slot.

    table [V, D] f32, indices [B, K] int32 (-1 pad; ids >= V read row
    V-1), weights [B, K] f32 -> [B, D] f32.  Never holds the [B, K, D]
    gather, so it runs at the kernel's full shapes on the card.
    """
    if combine not in COMBINES:
        raise ValueError(f"unknown combine {combine!r}; expected one of {COMBINES}")
    valid = indices >= 0
    safe = torch.clamp(indices.to(torch.int64), 0, table.shape[0] - 1)
    b, k = indices.shape
    if combine == "max":
        out = torch.full((b, table.shape[1]), float("-inf"), dtype=torch.float32,
                         device=table.device)
        for j in range(k):
            row = torch.where(valid[:, j, None], table.index_select(0, safe[:, j]),
                              float("-inf"))
            out = torch.maximum(out, row)
        return torch.where(torch.isfinite(out), out, 0.0)
    out = torch.zeros((b, table.shape[1]), dtype=torch.float32, device=table.device)
    w = torch.where(valid, weights, 0.0)
    for j in range(k):
        out += table.index_select(0, safe[:, j]) * w[:, j, None]
    if combine == "mean":
        out /= torch.clamp(valid.sum(dim=1, keepdim=True), min=1)
    return out


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor,
                  combine: str = "sum") -> torch.Tensor:
    """Bag reduction: table [V, D] f32, indices [B, K] int32 (-1 = padding),
    weights [B, K] f32 -> [B, D] f32.

    ``sum`` adds ``row * weight`` over the bag's valid slots, ``mean``
    divides that by the count of valid slots, ``max`` takes the largest
    row ignoring the weights.  Ids >= V read row V-1; an empty bag gives 0.
    """
    if combine not in COMBINES:
        raise ValueError(f"unknown combine {combine!r}; expected one of {COMBINES}")
    if table.device.type == "cpu":
        return embedding_bag_torch(table, indices, weights, combine)
    _build.require(table, "table", torch.float32, 2)
    _build.require(indices, "indices", torch.int32, 2)
    _build.require(weights, "weights", torch.float32, 2)
    if weights.shape != indices.shape:
        raise ValueError(
            f"weights {tuple(weights.shape)} and indices {tuple(indices.shape)} differ")
    v, d = table.shape
    b, k = indices.shape
    if v == 0:
        raise ValueError("table: no rows")
    if v >= 2**31:
        raise ValueError(f"table: {v} rows do not fit int32 ids")
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0 or d == 0:
        return out
    if d % 4 == 0 and table.data_ptr() % 16:  # the kernel loads float4 rows
        raise ValueError("table: data pointer not 16-byte aligned")
    lib = _build.library()
    _build.check(
        lib.repro_embedding_bag(
            table.data_ptr(), indices.data_ptr(), weights.data_ptr(), b, k, v, d,
            COMBINES.index(combine), out.data_ptr(), _build.stream(table),
        ),
        "embedding_bag",
    )
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0


@torch.library.custom_op("repro_torch::embedding_bag", mutates_args=())
def embedding_bag_op(table: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor,
                     combine: str) -> torch.Tensor:
    """``embedding_bag`` as a custom op."""
    return embedding_bag(table, indices, weights, combine)


@embedding_bag_op.register_fake
def _(table, indices, weights, combine):
    return table.new_empty((indices.shape[0], table.shape[1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.embedding_bag)
def _(table_shape, indices_shape, weights_shape, combine, out_shape=None, **kwargs) -> int:
    return 2 * indices_shape[0] * indices_shape[1] * table_shape[1]
