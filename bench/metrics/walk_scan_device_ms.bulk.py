"""Device ms a walk step spends in the compensated Hillis-Steele scan of the
tile totals and its two exclusive shifts, in the batched walks (16 walks a
step): the CUDA events of the program span slot_walk.scan, mean over the
traced steps."""
from bench import program_spans

LAYER = "walk image"
UNIT = "ms"
MOVES = "walks_per_s"


def read(record):
    return program_spans.device_ms_per_span(record, "slot_walk.scan")
