"""tile_cumsum's share of its byte roofline in the stream rounds' walks:
4 bytes in and 4 out per float32 of each launch's [T, 128] tiles at 3.35
TB/s, over the kernel's device time in the trace."""
from bench import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "round_ms"


def read(record):
    return readers.tile_cumsum_roofline(record)
