"""repro_torch.core — DiGraph (the paper's CP2AA-backed slotted CSR) and
the layers it is built from."""
from . import alloc, arena, traversal, updates, util, walk_image  # noqa: F401
from .csr import CSR, from_coo  # noqa: F401
from .digraph import DiGraph  # noqa: F401
from .edgebatch import EdgeBatch, from_arrays, random_deletions, random_insertions  # noqa: F401
from .updates import UpdatePlan, plan_update  # noqa: F401
from .walk_image import WalkImage  # noqa: F401
