"""Share of the traced window in which no kernel, copy or set ran on the
device, from the profiler's trace."""
from bench import readers

LAYER = "device"
UNIT = "%"
MOVES = "walks_per_s"


def read(record):
    return readers.idle_pct(record)
