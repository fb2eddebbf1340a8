"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — GQA, QKV bias [arXiv:2407.10671; hf]."""
import torch

from ..models.transformer.config import TransformerConfig
from . import base

FULL = TransformerConfig(
    name="qwen2-72b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    attn_impl="blocked",
)

SMOKE = TransformerConfig(
    name="qwen2-72b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=512,
    qkv_bias=True,
    attn_impl="ref",
    compute_dtype=torch.float32,
)

base.register(
    base.ArchEntry(
        name="qwen2-72b",
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
