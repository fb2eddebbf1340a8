"""LM transformer configuration (the counterpart of
``repro.models.transformer.config``), dense models only.

``repro``'s ``TransformerConfig`` less what no ported code reads: ``remat``
(training), ``scan_layers`` (a Python loop over the layers has no
counterpart), ``batch_axes`` and ``tp_axis`` (the mesh) and
``n_active_params`` (equal to ``n_params`` without MoE).  A config that
sets ``moe`` is refused until ``moe.py`` is ported.  The dtypes are torch
dtypes; ``backend`` picks the attention kernel as ``TwoTowerConfig``'s
does (``"auto"`` | ``"cuda"`` | ``"torch"``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    qkv_bias: bool = False              # qwen2
    sliding_window: int = 0             # h2o-danube SWA; 0 = full attention
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    moe: None = None                    # MoE: not ported
    tie_embeddings: bool = False
    # numerics / memory policy
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "blocked"          # ref | blocked | flash
    attn_block: int = 512               # kv block for blocked/flash impls
    backend: str = "auto"               # flash kernel: "auto" | "cuda" | "torch"

    def __post_init__(self):
        if self.moe is not None:
            raise ValueError(f"{self.name}: MoE layers are not ported (moe.py)")

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_subquadratic(self) -> bool:
        return self.sliding_window > 0

    def n_params(self) -> int:
        """Total parameter count (embeddings included)."""
        d, l = self.d_model, self.n_layers
        hq, hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
        if self.qkv_bias:
            attn += (hq + 2 * hkv) * dh
        ff = 3 * d * self.d_ff
        norms = 2 * d * l + d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return l * (attn + ff) + norms + emb
