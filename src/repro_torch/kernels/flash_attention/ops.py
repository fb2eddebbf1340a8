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


attention_reference = _ref.attention_reference
