"""Device ms a walk step spends on the tile bases, in the batched walks (16
walks a step): one ``tile_bases`` call on the card (its reduce and scan
kernels: the exclusive prefix of the tile totals, summed in float64 and
kept as two float32 halves), the CUDA events of the program span
slot_walk.scan, mean over the traced steps."""
from bench import program_spans

LAYER = "walk image"
UNIT = "ms"
MOVES = "walks_per_s"


def read(record):
    return program_spans.device_ms_per_span(record, "slot_walk.scan")
