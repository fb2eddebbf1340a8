"""Plain EmbeddingBag oracle: take + reduce over the bag axis."""
from __future__ import annotations

import torch


def embedding_bag_reference(table: torch.Tensor, indices: torch.Tensor,
                            weights: torch.Tensor, *, combine: str = "sum") -> torch.Tensor:
    """table [V, D], indices [B, K] (-1 pad), weights [B, K] -> [B, D].

    Ids >= V read row V-1.  ``mean`` divides the weighted sum by the count
    of non-padding ids; ``max`` ignores the weights and turns a non-finite
    result (an empty bag) into 0.
    """
    valid = indices >= 0
    safe = torch.clamp(indices.to(torch.int64), 0, table.shape[0] - 1)
    rows = table[safe]  # [B, K, D]
    if combine in ("sum", "mean"):
        rows = rows * torch.where(valid, weights, 0.0)[..., None]
        out = rows.sum(dim=1)
        if combine == "mean":
            out = out / torch.clamp(valid.sum(dim=1, keepdim=True), min=1)
        return out
    rows = torch.where(valid[..., None], rows, float("-inf"))
    out = rows.amax(dim=1)
    return torch.where(torch.isfinite(out), out, 0.0)
