"""Packed bitset for vertex-existence flags (paper Alg 1: ``exists``).

The paper stores existence flags in 64-bit chunks; ``repro`` packs them
into uint32 words.  ``torch.uint32`` lacks shifts and bitwise ops in
several builds, so the words here are int32 tensors holding the same 32
bits (viewed as uint32 they equal ``repro``'s words); the bit arithmetic
runs on int64 copies.  All ops are vectorized.
"""
from __future__ import annotations

import torch

from . import util

BITS = 32
_LOW32 = 0xFFFFFFFF


def _to_words(w64: torch.Tensor) -> torch.Tensor:
    """int64 tensor of 32-bit patterns -> int32 words with those bits."""
    return torch.where(w64 >= 2**31, w64 - 2**32, w64).to(torch.int32)


def _unsigned(bits: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 tensor of their unsigned values."""
    return bits.to(torch.int64) & _LOW32


def make(capacity: int, *, device="cuda") -> torch.Tensor:
    """Zeroed bitset able to hold ``capacity`` flags, on ``device``."""
    words = -(-int(capacity) // BITS)
    return torch.zeros(max(words, 1), dtype=torch.int32,
                       device=util.resolve_device(device))


def capacity(bits: torch.Tensor) -> int:
    return bits.shape[0] * BITS


def get(bits: torch.Tensor, idx) -> torch.Tensor:
    """Vectorized getBit: True where the flag is set. OOB reads are False."""
    idx = torch.as_tensor(idx, device=bits.device).to(torch.int64)
    word = idx // BITS
    off = idx % BITS
    in_range = (idx >= 0) & (word < bits.shape[0])
    w = _unsigned(bits[word.clamp(0, bits.shape[0] - 1)])
    return in_range & (((w >> off) & 1) != 0)


def set_(bits: torch.Tensor, idx, value: bool = True) -> torch.Tensor:
    """Vectorized setBit/clearBit; returns the new word array.  Indices
    outside the bitset are dropped."""
    idx = torch.as_tensor(idx, device=bits.device).to(torch.int64).reshape(-1)
    idx = idx[(idx >= 0) & (idx < capacity(bits))]
    word = idx // BITS
    mask = torch.ones_like(idx) << (idx % BITS)
    out = _unsigned(bits)
    if value:
        out[word] = out[word] | mask
    else:
        out[word] = out[word] & (~mask & _LOW32)
    return _to_words(out)


def set_many(bits: torch.Tensor, idx) -> torch.Tensor:
    """Set several (possibly duplicate) indices at once.

    Scatter-OR is not a torch reduction, so the distinct indices' masks
    are summed per word (distinct bits of one word never carry, so the sum
    is their OR) and OR-ed into the words once.
    """
    idx = torch.as_tensor(idx, device=bits.device).to(torch.int64).reshape(-1)
    idx = torch.unique(idx[(idx >= 0) & (idx < capacity(bits))])
    acc = torch.zeros(bits.shape[0], dtype=torch.int64, device=bits.device)
    acc.index_add_(0, idx // BITS, torch.ones_like(idx) << (idx % BITS))
    return _to_words(_unsigned(bits) | acc)


def count(bits: torch.Tensor) -> int:
    """Population count across the whole bitset."""
    w = _unsigned(bits)
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return int((((w * 0x01010101) & _LOW32) >> 24).sum())


def grow(bits: torch.Tensor, new_capacity: int) -> torch.Tensor:
    """Reallocate to a larger capacity, preserving flags (paper reallocate())."""
    new = make(new_capacity, device=bits.device)
    new[: bits.shape[0]] = bits
    return new
