"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual FFN
[hf:Snowflake/snowflake-arctic-base; hf]."""
import torch

from ..models.transformer.config import MoEConfig, TransformerConfig
from . import base

FULL = TransformerConfig(
    name="arctic-480b",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=0,
    vocab=32000,
    moe=MoEConfig(
        n_experts=128, top_k=2, d_ff_expert=4864, dense_residual_ff=4864
    ),
    rope_theta=1e6,
    attn_impl="blocked",
    # 480B params: bf16 params + bf16 adam m/v — 8 B/param -> ~15 GB/chip
    # on the 256-chip pod (DESIGN.md §5 memory budget)
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="arctic-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=0,
    vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, dense_residual_ff=48),
    attn_impl="ref",
    compute_dtype=torch.float32,
)

base.register(
    base.ArchEntry(
        name="arctic-480b",
        family="lm",
        full=FULL,
        smoke=SMOKE,
        model="transformer",
        skip_shapes={
            "long_500k": "pure full attention (quadratic) — skipped per "
            "assignment; see DESIGN.md §4"
        },
    )
)
