"""Flash attention's CUDA kernel and its plain version.

``flash_attention`` is online-softmax attention with causal and
sliding-window masks and GQA head grouping, in one launch
(``csrc/flash_attention.cu``).  It replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention`` (a
(B·Hq, Sq/BQ, Skv/BK) grid that skips fully masked kv blocks).  The C entry
point picks one of two hand-written kernels by type, head dim and alignment
(``repro_flash_attention_path``): bfloat16 at D % 8 == 0 (16-byte aligned
operands, Skv > 0) runs the tensor-core kernel (``"wgmma"``: TMA tile ring,
bf16 wgmma products with f32 accumulators, P split into two bf16 halves so
P·V keeps f32 precision); float32, and the other bfloat16 calls, run the
FMA kernel (``"simt"``: f32 tiles, FP32 FMAs on the CUDA cores).  Both pick
their own tile sizes and take any Sq, Skv and D <= 128; the op's
``block_q`` / ``block_k`` only set its preconditions.

The wrapper launches the CUDA kernel for CUDA tensors and uses its plain
PyTorch version (``flash_attention_torch``) only for CPU tensors; its
``launches`` attribute counts kernel launches, and ``path_launches`` counts
them by kernel (``"wgmma"`` / ``"simt"``).  ``flash_attention_op`` is the
wrapper as a ``torch.library`` custom op (``repro_torch::flash_attention``),
the form the attention entry point calls: its fake body gives q's shape
and type to fake tensors, its flop formula is ``chip_smoke.py``'s count,
4·B·Hq·D a visible (query, key) pair.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build

NEG_INF = -1e30
#: the kernel's input types and their codes in the C entry point
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the CUDA kernels, indexed by what repro_flash_attention_path returns
PATHS = ("simt", "wgmma")
#: query rows the plain version takes at a time
PLAIN_BLOCK_Q = 256


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version, one block of query rows at a time.

    Each block scores only the keys its rows can see (``[q0 - window + 1,
    q1)`` when causal), in float32, scaled after the dot; masked scores are
    ``NEG_INF``; ``exp(s - rowmax)`` masked to 0, summed, and the output is
    ``p·v / max(l, 1e-30)`` in q's type (0 for a row that sees no key).
    GQA is a view: the query heads of one kv head form a group axis.  It
    never holds [B, Hq, S, S] scores, so it runs at the kernel's full shapes
    on the card.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    scale = 1.0 / (d ** 0.5)
    out = torch.zeros_like(q)
    for q0 in range(0, sq, PLAIN_BLOCK_Q):
        q1 = min(q0 + PLAIN_BLOCK_Q, sq)
        lo = max(0, q0 - window + 1) if window > 0 else 0
        hi = min(skv, q1) if causal else skv
        if hi <= lo:
            continue
        qb = q[:, :, q0:q1].float().reshape(b, hkv, group, q1 - q0, d)
        kb = k[:, :, None, lo:hi].float()
        vb = v[:, :, None, lo:hi].float()
        s = (qb @ kb.transpose(-1, -2)) * scale  # [B, Hkv, group, bq, L]
        q_ids = torch.arange(q0, q1, device=q.device)[:, None]
        k_ids = torch.arange(lo, hi, device=q.device)[None, :]
        mask = torch.ones((q1 - q0, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_ids <= q_ids
        if window > 0:
            mask &= k_ids > q_ids - window
        s = torch.where(mask, s, NEG_INF)
        p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        o = (p @ vb) / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
        out[:, :, q0:q1] = o.reshape(b, hq, q1 - q0, d).to(q.dtype)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D] -> [B,Hq,Sq,D] in q's type.

    Key j is visible to query i when ``j <= i`` (causal) and ``j > i -
    window`` (``window > 0``); query head h reads kv head ``h // (Hq/Hkv)``.
    """
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, window=window)
    if q.dtype not in DTYPES:
        raise ValueError(f"q: expected one of {list(DTYPES)}, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, q.dtype, 4)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "do not fit [B,Hq,Sq,D], [B,Hkv,Skv,D], [B,Hkv,Skv,D]")
    if not 1 <= d <= 128:
        raise ValueError(f"head dim {d}: the kernel takes 1..128")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    if b * hq > 65535:
        raise ValueError(f"B*Hq = {b * hq} exceeds the kernel's grid (65535)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library()
    path = PATHS[lib.repro_flash_attention_path(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), skv, d, DTYPES[q.dtype])]
    _build.check(
        lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * hq, hq, hkv,
            sq, skv, d, int(causal), int(window), 1.0 / (d ** 0.5), DTYPES[q.dtype],
            _build.stream(q),
        ),
        "flash_attention",
    )
    flash_attention.launches += 1
    flash_attention.path_launches[path] += 1
    return out


flash_attention.launches = 0
flash_attention.path_launches = dict.fromkeys(PATHS, 0)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       window: int) -> torch.Tensor:
    """``flash_attention`` as a custom op."""
    return flash_attention(q, k, v, causal=causal, window=window)


@flash_attention_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs attention computes: key j is visible to query i
    when j <= i (causal) and j > i - window (window > 0)."""
    q = np.arange(sq)
    hi = np.minimum(q + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(q - window + 1, 0) if window > 0 else 0
    return int(np.maximum(hi - lo, 0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, window, out_shape=None, **kwargs) -> int:
    b, hq, sq, d = q_shape
    return b * hq * 4 * d * visible_pairs(sq, k_shape[2], causal, window)
