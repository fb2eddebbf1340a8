"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix, sliding-window attention
[arXiv:2401.16818; hf].

``FULL`` keeps ``repro``'s ``attn_impl="blocked"``; serving runs it with
``dataclasses.replace(FULL, attn_impl="flash")``, the CUDA kernel."""
import torch

from ..models.transformer.config import TransformerConfig
from . import base

FULL = TransformerConfig(
    name="h2o-danube-1.8b",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=80,
    d_ff=6912,
    vocab=32000,
    sliding_window=4096,          # the mistral-style SWA mix
    rope_theta=1e4,
    attn_impl="blocked",
)

SMOKE = TransformerConfig(
    name="h2o-danube-1.8b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=96,
    vocab=256,
    sliding_window=16,
    attn_impl="ref",
    compute_dtype=torch.float32,
)

base.register(
    base.ArchEntry(
        name="h2o-danube-1.8b",
        family="lm",
        full=FULL,
        smoke=SMOKE,
        model="transformer",
        # SWA is sub-quadratic: long_500k RUNS for this arch (ring cache)
    )
)
