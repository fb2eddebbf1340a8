"""Device-buffer arena: CP2AA's block allocator applied to a flat tensor.

The paper's CP2AA hands out power-of-2-sized blocks from pools and recycles
freed blocks through per-size-class free lists.  Here the "pool" is one flat
device tensor of edge slots; *this class only does the bookkeeping on host*
(which slots belong to which vertex).  Handing a freed block to a new vertex
is a metadata operation — no device traffic — exactly like CP2AA's free-list
pop.  Growing the pool is a pow-2 whole-buffer reallocation (the amortized
path, mirroring AA's "allocate a new pool").
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from . import alloc


@dataclasses.dataclass
class ArenaLayout:
    """Host-side slot allocator for a flat device buffer of ``capacity`` slots."""

    capacity: int
    bump: int = 0
    freed: dict[int, list[int]] = dataclasses.field(
        default_factory=lambda: defaultdict(list)
    )
    n_alloc: int = 0
    n_free: int = 0
    n_reuse: int = 0

    def try_alloc(self, size_class: int) -> int | None:
        """Allocate a block of ``size_class`` slots; None if pool exhausted.

        Mirrors FAA.allocate() (paper Alg 9): freed list first, then bump.
        """
        lst = self.freed.get(size_class)
        if lst:
            self.n_reuse += 1
            return lst.pop()
        if self.bump + size_class <= self.capacity:
            start = self.bump
            self.bump += size_class
            self.n_alloc += 1
            return start
        return None

    def free(self, start: int, size_class: int) -> None:
        self.freed[int(size_class)].append(int(start))
        self.n_free += 1

    def grow_target(self, extra: int) -> int:
        """New pool capacity able to fit ``extra`` more slots (pow-2 growth)."""
        return alloc.next_pow2(max(self.bump + extra, self.capacity + 1))

    def live_slots(self) -> int:
        freed_total = sum(k * len(v) for k, v in self.freed.items())
        return self.bump - freed_total

    def clone(self) -> "ArenaLayout":
        c = ArenaLayout(self.capacity, self.bump)
        c.freed = defaultdict(list, {k: list(v) for k, v in self.freed.items()})
        return c
