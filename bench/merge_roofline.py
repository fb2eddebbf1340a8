"""The merge's kernels in a traced window: their device time a round, the
bytes ``merge_rows_fused`` needs from the program's counters, and the
share of the byte roofline.

While the profiler runs, ``fused_apply`` opens the host span
``slot_update.count`` after its merges and attaches one record of
counters a width group, one group a launch, to it
(``repro_torch.runtime.trace.count``): groups of width <= 32 run the warp
kernel, wider ones the block kernel.  The device time is the trace's, of
the kernel's launches.  A program without those counters gives no share.
"""
from __future__ import annotations

from . import program_spans, readers, roofline

#: each half of the merge: the kernel its launches run
KERNELS = {"narrow": "merge_rows_warp_kernel", "wide": "merge_rows_block_kernel"}
#: the widest group the warp kernel takes (``kernels/slot_update/kernel.py``)
WARP_ROW_MAX = 32


def merge_rows_bytes(c: dict) -> int:
    """Bytes one launch needs (its real rows; pad rows and run padding
    count nothing): each row's ``row_ops`` (24 B) and count (4 B), its live
    prefix read (id and weight, 8 B a slot), its run entries (key, delete
    flag, weight: 12 B), its new block written (8 B a slot); for a row
    that moved, the owner map over its new block and the SENTINEL fill of
    its old one (4 B a slot each); ``[lo, hi)`` (8 B a row) where written."""
    rows = int(c["rows"])
    return (28 * rows + 8 * int(c["live"]) + 12 * int(c["entries"])
            + 8 * int(c["new_cap"]) + 4 * int(c["moved_new_cap"])
            + 4 * int(c["moved_old_cap"]) + (8 * rows if c["lohi"] else 0))


def launches(record, phase: str) -> list:
    """The counter records of the traced launches of one half of the merge."""
    wide = phase == "wide"
    return [c for s in program_spans.select(record) if s.name == "slot_update.count"
            for c in getattr(s, "counters", None) or []
            if (c["width"] > WARP_ROW_MAX) == wide]


def device_ms(record, phase: str):
    """Device ms of the half's kernel a traced round; None without a
    launch in the trace."""
    rounds = len(record.get("traced_walks") or [])
    seconds, n = readers.kernel_seconds(record, KERNELS[phase])
    return 1e3 * seconds / rounds if n and rounds else None


def share(record, phase: str):
    """The launches' bytes at the HBM peak over their kernel's traced
    device time, in %; None when the trace's launches of the kernel are
    not the counted ones."""
    recs = launches(record, phase)
    seconds, n = readers.kernel_seconds(record, KERNELS[phase])
    if not recs or n != len(recs):
        return None
    return roofline.share_of_bytes_roofline(sum(merge_rows_bytes(c) for c in recs), seconds)
