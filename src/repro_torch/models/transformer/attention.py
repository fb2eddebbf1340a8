"""Attention implementations (the counterpart of
``repro.models.transformer.attention``): ref (dense scores), blocked
(``repro``'s XLA online-softmax scan, in plain torch), flash (the CUDA
kernel).

Shape routing differs from ``repro`` for ``impl="flash"``: ``repro`` sends
S <= ``block`` (and Sq == 1) to the dense reference, while the port sends
every shape to the flash op, so that on a card the plain version stays off
the main path.  ``impl="ref"`` still calls the reference and
``impl="blocked"`` the ported scan (with ``repro``'s routing); within the
flash op ``backend="torch"`` is the kernel's plain version on the card,
and a CPU tensor always takes the plain version.

``ref`` and ``blocked`` are plain torch and run under autograd.  ``flash``
has no backward (nor has ``repro``'s Pallas kernel): a call that records
grads through it raises rather than switching to ``blocked``.
"""
from __future__ import annotations

import torch

from ...kernels.flash_attention import ops as fa_ops
from .. import sharding_utils

NEG_INF = -1e30


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding; x [..., S, H, Dh], positions [..., S].

    The frequencies and angles are ``repro``'s, in its order: a float32
    power, then a float32 product with the positions.
    """
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                           device=x.device) / half)
    angles = positions[..., :, None].float() * freqs  # [..., S, half]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def ref_attention(q, k, v, *, causal=True, window=0):
    """Dense-score attention (small shapes / tests)."""
    return fa_ops.attention_reference(q, k, v, causal=causal, window=window)


def blocked_attention(q, k, v, *, causal=True, window=0, block=512):
    """Online-softmax attention as a loop over KV blocks, ``repro``'s XLA
    formulation: q scaled before the dot, every block visited (no skip)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    if skv % block:
        raise ValueError(f"Skv={skv} is not a multiple of block={block}")
    scale = 1.0 / (d ** 0.5)
    qf = q.float() * scale
    q_ids = torch.arange(sq, device=q.device)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, skv, block):
        kk = k[:, :, k0:k0 + block].float().repeat_interleave(group, dim=1)
        vv = v[:, :, k0:k0 + block].float().repeat_interleave(group, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kk)
        k_ids = k0 + torch.arange(block, device=q.device)
        mask = torch.ones((sq, block), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_ids[None, :] <= q_ids[:, None]
        if window > 0:
            mask &= k_ids[None, :] > q_ids[:, None] - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vv)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def attention(q, k, v, *, impl="blocked", causal=True, window=0, block=512,
              backend="auto", batch_axes=(), tp_axis=""):
    """q [B, Hq, S, D], k/v [B, Hkv, S, D] -> [B, Hq, S, D] through ``impl``.

    Under a mesh (``DTensor`` inputs) each rank runs ``impl`` on its own
    heads through ``local_map``.  Placement rule: heads over ``tp_axis``
    (``"model"`` when not given), the batch over ``batch_axes``, each
    dropped where it does not divide (the kv heads decide: a rank's q heads
    are the groups of its kv heads, so the GQA group must divide evenly, or
    the heads replicate); q, k and v are redistributed to that placement (a
    no-op when the projections left them there; from a sequence-sharded
    layer input, the all-to-all that gathers the sequence) and the output
    keeps it.
    """
    if sharding_utils.is_dtensor(q):
        return _sharded_attention(q, k, v, impl=impl, causal=causal, window=window,
                                  block=block, backend=backend, batch_axes=batch_axes,
                                  tp_axis=tp_axis)
    if impl == "ref":
        return ref_attention(q, k, v, causal=causal, window=window)
    if impl == "blocked":
        if q.shape[2] <= block:
            return ref_attention(q, k, v, causal=causal, window=window)
        return blocked_attention(q, k, v, causal=causal, window=window, block=block)
    if impl == "flash":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "attn_impl='flash' has no backward: train with 'blocked' or 'ref'")
        return fa_ops.attention(q, k, v, causal=causal, window=window, backend=backend,
                                block_q=block, block_k=block)
    raise ValueError(impl)


def _sharded_attention(q, k, v, *, batch_axes, tp_axis, **kw):
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    tp = tp_axis or ("model" if "model" in mesh.mesh_dim_names else None)
    pl = sharding_utils.spec_to_placements((tuple(batch_axes) or None, tp), k.shape, mesh)
    q, k, v = (t if tuple(t.placements) == pl else t.redistribute(mesh, pl) for t in (q, k, v))
    site = local_map(lambda q_, k_, v_: attention(q_, k_, v_, **kw),
                     out_placements=list(pl), in_placements=(pl, pl, pl), device_mesh=mesh)
    return site(q, k, v)


decode_attention = fa_ops.decode_attention
