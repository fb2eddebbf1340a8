"""Host time of a round's 42-step DiGraph.reverse_walk up to its device work's
end, mean over the untraced rounds of the window (the profiler slows the host's launches):
the benchmark's own span, host clock."""
from bench import readers

LAYER = "walk image"
UNIT = "ms"
MOVES = "round_ms"


def read(record):
    return readers.span_ms(record, "walk")
