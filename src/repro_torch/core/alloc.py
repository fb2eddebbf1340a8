"""CP2AA-analogue capacity policy (paper Alg 11/12, adapted per DESIGN.md §2).

On CPU the paper's Concurrent Power-of-2 Arena Allocator amortizes *malloc*
cost; on an accelerator the analogous cost is a whole-buffer copy when a
shape changes.  We therefore keep CP2AA's exact size-class policy
(Alg 11 lines 30-33) but apply it to **shapes**: every dynamic array in the
system only ever takes power-of-2 (or page-rounded) sizes, and in-place
growth uses pre-reserved slack.

All functions are pure python/numpy (shape decisions happen on host).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# --- constants mirroring the paper's configuration (§4.1.2, Alg 11) ---------
MIN_ALLOC_BYTES = 16        # smallest size class
MAX_POW2_BYTES = 8192       # largest pow-2 class; beyond -> page rounding
PAGE_SIZE = 4096            # bytes; reserve() rounds vertex arrays to pages
EDGE_SIZE = 8               # bytes per edge: (int32 dst, float32 weight)
BOOL_BITS = 32              # existence bitset chunk width


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 0)."""
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def pow2_with_headroom(total: int, min_frac: float = 0.25) -> int:
    """Pow-2 capacity >= ``total`` with at least ``min_frac`` bump headroom.

    The walk-image build paths size their buffers with this so grown
    rows can relocate to bump blocks a while before a rebuild.  Dense
    (slack-free) images pass ``min_frac=1.0``: with zero in-block slack
    EVERY insert-touched row relocates, so they need a deeper bump
    reserve.
    """
    total = int(total)
    cap = next_pow2(max(total, 2))
    while cap < total * (1 + min_frac):
        cap *= 2
    return cap


def allocation_size(nbytes: int) -> int:
    """Paper Alg 11, allocationSize(): size class in bytes for a request.

    <=16 -> 16;  <8192 -> next pow2;  else -> round up to page multiple.
    """
    nbytes = int(nbytes)
    if nbytes <= MIN_ALLOC_BYTES:
        return MIN_ALLOC_BYTES
    if nbytes < MAX_POW2_BYTES:
        return next_pow2(nbytes)
    return -(-nbytes // PAGE_SIZE) * PAGE_SIZE


def edge_capacity(deg: int) -> int:
    """Per-vertex edge-slot capacity for a desired degree (elements)."""
    return allocation_size(max(int(deg), 1) * EDGE_SIZE) // EDGE_SIZE


def edge_capacities(degrees: np.ndarray) -> np.ndarray:
    """Vectorized `edge_capacity` over an int array of degrees."""
    deg = np.maximum(np.asarray(degrees, dtype=np.int64), 1)
    nbytes = deg * EDGE_SIZE
    # pow-2 branch
    exp = np.ceil(np.log2(np.maximum(nbytes, MIN_ALLOC_BYTES))).astype(np.int64)
    pow2 = np.maximum(1 << exp, MIN_ALLOC_BYTES)
    # page branch
    paged = -(-nbytes // PAGE_SIZE) * PAGE_SIZE
    out = np.where(nbytes < MAX_POW2_BYTES, pow2, paged)
    return (out // EDGE_SIZE).astype(np.int64)


def reserve_size(n: int, elem_bytes: int = 4) -> int:
    """Paper Alg 1 reserve(): round a vertex-array length up to a page."""
    n = max(int(n), 1)
    per_page = PAGE_SIZE // elem_bytes
    return -(-n // per_page) * per_page


@dataclasses.dataclass
class AllocStats:
    """Bookkeeping mirroring the paper's allocator microbenchmarks.

    ``relayouts`` counts whole-buffer reallocations (the expensive path the
    pow-2 slack exists to avoid).  ``used_elems`` /
    ``slack_elems`` track live edges vs dead-or-slack slots inside the
    arena's bump prefix — the occupancy signal the traversal engine uses to
    trigger block compaction (DESIGN.md §7).
    """

    relayouts: int = 0
    slack_elems: int = 0
    used_elems: int = 0

    def record_relayout(self) -> None:
        self.relayouts += 1

    @property
    def slack_fraction(self) -> float:
        total = self.slack_elems + self.used_elems
        return self.slack_elems / total if total else 0.0

    @property
    def live_fraction(self) -> float:
        """Live-slot share of the occupied arena prefix (1.0 when empty)."""
        total = self.slack_elems + self.used_elems
        return self.used_elems / total if total else 1.0
