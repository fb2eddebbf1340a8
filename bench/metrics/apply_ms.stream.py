"""Host time of a round's DiGraph.apply (CP2AA block moves on the host, the
fused merge_rows launches, its one wait for the merge counts), mean over the
untraced rounds of the window (the profiler slows the host's launches):
the benchmark's own span, host clock."""
from bench import readers

LAYER = "representation"
UNIT = "ms"
MOVES = "round_ms"


def read(record):
    return readers.span_ms(record, "apply")
