"""Host time of a round's planning (edgebatch.from_arrays of the deletions and
insertions, updates.plan_update), mean over the untraced rounds of the window: the
benchmark's own span, host clock."""
from bench import readers

LAYER = "host planning"
UNIT = "ms"
MOVES = "round_ms"


def read(record):
    return readers.span_ms(record, "plan")
