"""Device ms a walk step spends gathering the visits over the image's slots
(cat with the zero column, index_select), in the batched walks (16 walks a
step): the CUDA events of the program span slot_walk.gather, mean over the
traced steps."""
from bench import program_spans

LAYER = "walk image"
UNIT = "ms"
MOVES = "walks_per_s"


def read(record):
    return program_spans.device_ms_per_span(record, "slot_walk.gather")
