"""Plain segment sum over edges: the oracle of ``edge_segment_sum``."""
from __future__ import annotations

import torch


def segment_sum_reference(rows: torch.Tensor, vals: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """rows [E] int (>= num_segments means dropped), vals [E, D] -> [num_segments, D].

    Dropped rows are clamped to a sink row ``num_segments``, which is sliced
    off.
    """
    safe = torch.clamp(rows.to(torch.int64), max=num_segments)
    out = torch.zeros((num_segments + 1, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, safe, vals)[:num_segments]
