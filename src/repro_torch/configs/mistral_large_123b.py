"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768  [hf:mistralai/Mistral-Large-Instruct-2407; unverified]."""
import torch

from ..models.transformer.config import TransformerConfig
from . import base

FULL = TransformerConfig(
    name="mistral-large-123b",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab=32768,
    rope_theta=1e6,
    attn_impl="blocked",
)

SMOKE = TransformerConfig(
    name="mistral-large-123b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    attn_impl="ref",
    compute_dtype=torch.float32,
)

base.register(
    base.ArchEntry(
        name="mistral-large-123b",
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
