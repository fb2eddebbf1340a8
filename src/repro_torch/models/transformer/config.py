"""Unified LM transformer configuration (the counterpart of
``repro.models.transformer.config``): dense (mistral-large, qwen2,
h2o-danube w/ SWA) and MoE (qwen3-moe, arctic w/ dense residual).

``repro``'s ``TransformerConfig`` less what belongs to XLA:
``scan_layers`` (a ``lax.scan`` over the stacked layers; the port runs a
Python loop over them, so there is nothing to choose).  ``batch_axes`` and
``tp_axis`` are ``repro``'s activation sharding axes, applied under a mesh
(``models.sharding_utils``).  The dtypes are torch dtypes; ``backend``
picks the attention kernel as ``TwoTowerConfig``'s does (``"auto"`` |
``"cuda"`` | ``"torch"``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    dense_residual_ff: int = 0   # arctic: parallel dense FFN width (0 = off)


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
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = False
    # numerics / memory policy
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True                  # recompute each layer in the backward
    attn_impl: str = "blocked"          # ref | blocked | flash
    attn_block: int = 512               # kv block for blocked/flash impls
    backend: str = "auto"               # flash kernel: "auto" | "cuda" | "torch"
    # activation sharding (models/sharding_utils.py): mesh axis names for
    # the batch dim and the tensor-parallel axis; () / "" = unconstrained
    batch_axes: tuple = ()
    tp_axis: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_subquadratic(self) -> bool:
        return self.sliding_window > 0

    def _attn_params(self) -> int:
        d, hq, hkv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        return d * hq * dh + 2 * d * hkv * dh + hq * dh * d

    def n_params(self) -> int:
        """Total parameter count (embeddings included)."""
        d, l = self.d_model, self.n_layers
        hq, hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = self._attn_params()
        if self.qkv_bias:
            attn += (hq + 2 * hkv) * dh
        if self.moe is not None:
            ff = self.moe.n_experts * 3 * d * self.moe.d_ff_expert
            ff += d * self.moe.n_experts  # router
            if self.moe.dense_residual_ff:
                ff += 3 * d * self.moe.dense_residual_ff
        else:
            ff = 3 * d * self.d_ff
        norms = 2 * d * l + d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return l * (attn + ff) + norms + emb

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.n_params()
        d, l = self.d_model, self.n_layers
        ff = self.moe.top_k * 3 * d * self.moe.d_ff_expert
        ff += d * self.moe.n_experts
        if self.moe.dense_residual_ff:
            ff += 3 * d * self.moe.dense_residual_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return l * (self._attn_params() + ff) + 2 * d * l + d + emb
