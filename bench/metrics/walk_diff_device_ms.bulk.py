"""Device ms a walk step spends in the interval differences (six index_selects
of the tile prefixes and bases, the wheres, the adds), in the batched walks
(16 walks a step): the CUDA events of the program span slot_walk.diff, mean
over the traced steps."""
from bench import program_spans

LAYER = "walk image"
UNIT = "ms"
MOVES = "walks_per_s"


def read(record):
    return program_spans.device_ms_per_span(record, "slot_walk.diff")
