"""Device busy milliseconds of the traced calls per batched walk step
(16 walks a step), from the profiler's trace."""
from bench import readers

LAYER = "walk image"
UNIT = "ms"
MOVES = "walks_per_s"


def read(record):
    return readers.step_device_ms(record)
