"""Host ms a round's DiGraph.apply spends allocating CP2AA blocks: the grow
decisions, the try_alloc loop over the grown rows and a relayout when the
arena fills (program span apply.alloc), plus the free loop over the vacated
blocks and the new geometry's install (apply.free); summed over the traced
rounds, over their digraph.apply spans."""
from bench import program_spans

LAYER = "representation"
UNIT = "ms"
MOVES = "round_ms"


def read(record):
    return program_spans.host_ms_per_root(record, "digraph.apply",
                                          ("apply.alloc", "apply.free"))
