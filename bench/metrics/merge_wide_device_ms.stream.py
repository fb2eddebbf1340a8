"""Device ms a stream round spends merging its rows wider than 32 slots
(merge_rows_block_kernel, a block a row, one launch a width group): the
kernel's launches in the trace, summed, over the traced rounds."""
from bench import merge_roofline

LAYER = "representation"
UNIT = "ms"
MOVES = "round_ms"


def read(record):
    return merge_roofline.device_ms(record, "wide")
