"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family; hf]."""
import torch

from ..models.transformer.config import MoEConfig, TransformerConfig
from . import base

FULL = TransformerConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=0,
    vocab=151936,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
    rope_theta=1e6,
    attn_impl="blocked",
    # 235B params: bf16 storage + bf16 adam states to fit single-pod HBM
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="qwen3-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=0,
    vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32),
    attn_impl="ref",
    compute_dtype=torch.float32,
)

base.register(
    base.ArchEntry(
        name="qwen3-moe-235b-a22b",
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
