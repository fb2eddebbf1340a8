"""repro_torch.kernels — the hand-written CUDA kernels and the ops around them.

``KERNELS`` names each CUDA kernel wrapper; a wrapper's ``launches``
attribute counts the times it launched its kernel.
"""
from .bsr_spmm.kernel import bsr_spmm
from .csr_build.kernel import count_degrees, degree_offsets
from .edge_segment_sum.kernel import edge_segment_runs
from .embedding_bag.kernel import embedding_bag
from .flash_attention.kernel import flash_attention
from .slot_update.kernel import merge_rows_fused
from .slot_walk.kernel import slot_gather, slot_walk_partials, tile_bases, tile_cumsum

KERNELS = {
    "slot_gather": slot_gather,
    "tile_cumsum": tile_cumsum,
    "tile_bases": tile_bases,
    "merge_rows_fused": merge_rows_fused,
    "degree_offsets": degree_offsets,
    "count_degrees": count_degrees,
    "slot_walk_partials": slot_walk_partials,
    "bsr_spmm": bsr_spmm,
    "edge_segment_runs": edge_segment_runs,
    "embedding_bag": embedding_bag,
    "flash_attention": flash_attention,
}
