"""repro_torch.core — the dynamic graph representations (the paper's
contribution) and the layers they are built from.

Representations (DESIGN.md §3):
  DiGraph      — paper's CP2AA-backed slotted CSR (ours)
  SortedCOO    — cuGraph-analogue sort/merge rebuild
  LazyCSR      — GraphBLAS-analogue zombies + pending tuples
  ChunkedGraph — Aspen-analogue append-only pages, O(1) device snapshots
  Vector2D     — naive per-vertex host arrays (Fig. 1 strawman)
"""
from . import alloc, arena, bitset, traversal, updates, util, walk_image  # noqa: F401
from .chunked import ChunkedGraph  # noqa: F401
from .coo import SortedCOO  # noqa: F401
from .csr import CSR, from_coo, from_dense  # noqa: F401
from .digraph import DiGraph  # noqa: F401
from .edgebatch import EdgeBatch, from_arrays, random_deletions, random_insertions  # noqa: F401
from .lazy import LazyCSR  # noqa: F401
from .updates import UpdatePlan, plan_update  # noqa: F401
from .vector2d import Vector2D  # noqa: F401
from .walk_image import WalkImage  # noqa: F401

#: Representation registry used by benchmarks/tests; ordering mirrors the
#: paper's comparison tables (and ``repro.core.REPRESENTATIONS``).
REPRESENTATIONS = {
    "digraph": DiGraph,       # ours
    "coo": SortedCOO,         # cuGraph-analogue
    "lazy": LazyCSR,          # GraphBLAS-analogue
    "chunked": ChunkedGraph,  # Aspen-analogue
    "vector2d": Vector2D,     # PetGraph/SNAP-class strawman
}
