"""Device ms a stream round spends merging its rows of width <= 32
(merge_rows_warp_kernel, a warp a row, one launch an apply): the kernel's
launches in the trace, summed, over the traced rounds."""
from bench import merge_roofline

LAYER = "representation"
UNIT = "ms"
MOVES = "round_ms"


def read(record):
    return merge_roofline.device_ms(record, "narrow")
