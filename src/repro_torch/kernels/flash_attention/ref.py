"""Plain attention oracle (f32 softmax, causal/window/GQA)."""
from __future__ import annotations

import torch


def attention_reference(q, k, v, *, causal=True, window=0):
    """q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D] -> [B,Hq,Sq,D] in q's dtype.

    Dense [Sq, Skv] scores: for small shapes and tests.  A row with no
    visible key gives 0.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s / (d ** 0.5)
    q_ids = torch.arange(sq, device=q.device)[:, None]
    k_ids = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_ids <= q_ids
    if window > 0:
        mask &= k_ids > q_ids - window
    s = torch.where(mask, s, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
