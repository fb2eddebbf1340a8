"""Host ms a round's fused_apply spends launching the merge: the groups'
operands packed into the pinned buffer, its copy to the card and a
merge_rows_fused launch a width group (program span slot_update.pack);
summed over the traced rounds, over their digraph.apply spans."""
from bench import program_spans

LAYER = "representation"
UNIT = "ms"
MOVES = "round_ms"


def read(record):
    return program_spans.host_ms_per_root(record, "digraph.apply", ("slot_update.pack",))
