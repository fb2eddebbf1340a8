"""merge_rows_block_kernel's share of its byte roofline in the stream rounds'
applies: the bytes its launches need (bench/merge_roofline.py, from the
program's counters on slot_update.count) at 3.35 TB/s, over the
kernel's device time in the trace."""
from bench import merge_roofline

LAYER = "kernels"
UNIT = "%"
MOVES = "round_ms"


def read(record):
    return merge_roofline.share(record, "wide")
