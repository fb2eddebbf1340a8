"""Device ms a walk step spends on the tile bases, in the stream rounds'
42-step walks: one ``tile_bases`` call on the card (its reduce and scan
kernels: the exclusive prefix of the tile totals, summed in float64 and
kept as two float32 halves), the CUDA events of the program span
slot_walk.scan, mean over the traced steps."""
from bench import program_spans

LAYER = "walk image"
UNIT = "ms"
MOVES = "round_ms"


def read(record):
    return program_spans.device_ms_per_span(record, "slot_walk.scan")
