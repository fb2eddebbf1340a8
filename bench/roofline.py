"""Peaks of the card and the bytes a kernel's call needs.

Peaks: NVIDIA's data sheet for one H100 SXM 80 GB (dense rates, at the
700 W power limit).  A share of a roofline is stated against these, with
the card's power limit printed beside it by every run.
"""
from __future__ import annotations

#: HBM3 bandwidth of one H100 SXM, bytes/s
HBM_BYTES_PER_S = 3.35e12

#: slots per tile of the walk image (``[T, 128]`` tiles)
TILE = 128


def tile_cumsum_bytes(rows: int) -> int:
    """One ``tile_cumsum`` launch on ``[rows, 128]`` float32 tiles: each
    element read once (4 bytes) and its prefix written once (4 bytes)."""
    return 8 * TILE * int(rows)


def share_of_bytes_roofline(nbytes: float, seconds: float):
    """Least time at the HBM peak over the measured time, in %; None when
    no time was measured."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / seconds
