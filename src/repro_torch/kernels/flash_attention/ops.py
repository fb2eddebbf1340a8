"""Attention entry points: the flash kernel for prefill, plain torch for
decode (the counterpart of ``repro.kernels.flash_attention.ops``).

``backend=`` takes the place of ``repro``'s ``use_kernel``: ``"cuda"`` is
the hand-written kernel, ``"torch"`` its plain PyTorch version, ``"auto"``
picks by the tensors' device.  Unlike ``repro``, which sends Sq == 1 to the
dense reference, a CUDA tensor goes through the kernel at every shape.
"""
from __future__ import annotations

import torch

from ...core import util
from . import kernel as _kernel
from . import ref as _ref


def attention(q, k, v, *, causal: bool = True, window: int = 0, backend: str = "auto",
              block_q: int = 128, block_k: int = 128):
    """q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D] -> [B,Hq,Sq,D].

    ``repro``'s preconditions hold: Sq a multiple of ``min(block_q, Sq)``
    and Skv of ``min(block_k, Skv)``, else ``ValueError``.
    """
    sq, skv = q.shape[2], k.shape[2]
    bq, bk = min(block_q, sq), min(block_k, skv)
    if (bq and sq % bq) or (bk and skv % bk):
        raise ValueError(f"Sq={sq} and Skv={skv} must be multiples of the blocks "
                         f"min(block_q, Sq)={bq} and min(block_k, Skv)={bk}")
    backend = util.resolve_backend(backend, q.device)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if backend == "cuda":
        return _kernel.flash_attention_op(q, k, v, bool(causal), int(window))
    return _kernel.flash_attention_torch(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, kv_len, *, window: int = 0):
    """Single-token decode against a prefix of the KV cache, plain torch.

    q [B,Hq,1,D]; k/v [B,Hkv,S,D] ring or linear caches; ``kv_len`` = live
    prefix length: cache slots >= kv_len are masked.  GQA is a view (q as
    [B, Hkv, group, D]), so K/V are never repeated; the sums are
    ``repro``'s.
    """
    b, hq, _, d = q.shape
    _, hkv, s, _ = k.shape
    group = hq // hkv
    qf = q.float().reshape(b, hkv, group, d)
    scores = qf @ k.float().transpose(-1, -2)  # [B, Hkv, group, S]
    scores = scores / (d ** 0.5)
    ids = torch.arange(s, device=q.device)
    mask = ids < kv_len
    if window > 0:
        mask &= ids > kv_len - 1 - window
    scores = torch.where(mask, scores, -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return (p @ v.float()).reshape(b, hq, 1, d).to(q.dtype)


def decode_attention_partials(q, k, v, kv_len, *, s_offset: int, window: int = 0):
    """``decode_attention``'s softmax over one slice of the cache's sequence,
    unnormalised (flash-decoding), plain torch.

    k/v [B,Hkv,S,D] hold global slots ``[s_offset, s_offset + S)``; a slot is
    live when its global id is below ``kv_len`` (and within ``window``).
    Returns float32 ``(m [B,Hq], l [B,Hq], o [B,Hq,D])``: the max score, the
    sum of exp(score − m) and the sum of exp(score − m)·v.  A slice with no
    live slot gives m = −1e30 (the masked score, as ``repro`` masks) and
    l = o = 0, so :func:`merge_decode_partials` weighs it 0.
    """
    b, hq, _, d = q.shape
    _, hkv, s, _ = k.shape
    group = hq // hkv
    qf = q.float().reshape(b, hkv, group, d)
    scores = qf @ k.float().transpose(-1, -2)  # [B, Hkv, group, S]
    scores = scores / (d ** 0.5)
    ids = s_offset + torch.arange(s, device=q.device)
    mask = ids < kv_len
    if window > 0:
        mask &= ids > kv_len - 1 - window
    scores = torch.where(mask, scores, -1e30)
    m = scores.amax(-1)
    p = torch.where(mask, torch.exp(scores - m[..., None]), 0.0)
    o = p @ v.float()  # [B, Hkv, group, D]
    return m.reshape(b, hq), p.sum(-1).reshape(b, hq), o.reshape(b, hq, d)


def merge_decode_partials(m, l, o):
    """The attention output of partials stacked on a leading parts dim
    (m, l [P,B,Hq], o [P,B,Hq,D]): with M = max m, Σ e^(m−M)·o over
    max(Σ e^(m−M)·l, 1e-30) (``repro``'s clamp) -> float32 [B,Hq,D]."""
    w = torch.exp(m - m.amax(0))
    return (w[..., None] * o).sum(0) / torch.clamp((w * l).sum(0), min=1e-30)[..., None]


attention_reference = _ref.attention_reference
