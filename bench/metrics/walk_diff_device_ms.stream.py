"""Device ms a walk step spends in the interval differences (six index_selects
of the tile prefixes and bases, the wheres, the adds), in the stream rounds'
42-step walks: the CUDA events of the program span slot_walk.diff, mean over
the traced steps."""
from bench import program_spans

LAYER = "walk image"
UNIT = "ms"
MOVES = "round_ms"


def read(record):
    return program_spans.device_ms_per_span(record, "slot_walk.diff")
