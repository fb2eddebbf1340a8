"""Host ms a round's fused_apply waits for the merge counts to reach the
host, apply's one synchronisation (program span slot_update.wait); summed
over the traced rounds, over their digraph.apply spans."""
from bench import program_spans

LAYER = "representation"
UNIT = "ms"
MOVES = "round_ms"


def read(record):
    return program_spans.host_ms_per_root(record, "digraph.apply", ("slot_update.wait",))
