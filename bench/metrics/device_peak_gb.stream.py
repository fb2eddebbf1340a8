"""Peak device memory allocated in the window
(torch.cuda.max_memory_allocated after a reset at the window's start)."""
from bench import readers

LAYER = "device"
UNIT = "GB"
MOVES = "round_ms"


def read(record):
    return readers.peak_gb(record)
