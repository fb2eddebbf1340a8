"""Host ms a round's DiGraph.apply spends choosing and grouping rows:
add_vertices and plan.active_rows (program span apply.rows), plan.fused_groups
and, where taken, host_patch_layout (apply.groups); summed over the traced
rounds, over their digraph.apply spans."""
from bench import program_spans

LAYER = "representation"
UNIT = "ms"
MOVES = "round_ms"


def read(record):
    return program_spans.host_ms_per_root(record, "digraph.apply",
                                          ("apply.rows", "apply.groups"))
