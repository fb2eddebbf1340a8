"""The program's own spans (``repro_torch.runtime.trace``) in a traced run.

The program records its spans only while the profiler runs, on the same
epoch-nanosecond clock as the benchmark's stamps (``Spans.stamps``), so
``select`` keeps the spans that lie inside the traced part of the window:
from the first stamp's start to the last stamp's end.  That also leaves out
spans an earlier run in the same process left in the ring.  A program
without spans, or a run without a trace, gives nothing to select, and each
reduction then returns None.
"""
from __future__ import annotations


def program_spans() -> list:
    """Every span the program's ring holds; [] for a program without one."""
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return []
    return trace.spans()


def select(record) -> list:
    stamps = record["spans"].stamps
    if not stamps:
        return []
    lo = min(s for s, _, _ in stamps)
    hi = max(e for _, e, _ in stamps)
    return [s for s in program_spans() if lo <= s.start_ns and s.end_ns <= hi]


def host_ms_per_root(record, root: str, names) -> float | None:
    """Host ms of the spans named in ``names`` under the selected root spans
    named ``root``, summed, over the number of those roots."""
    spans = select(record)
    roots = {s.index for s in spans if s.name == root and s.parent == -1}
    if not roots:
        return None
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name in names and s.root in roots)
    return ns / 1e6 / len(roots)


def device_ms_per_span(record, name: str) -> float | None:
    """Mean device ms of the selected spans named ``name``; None when there
    are none or one carries no device time (a run off the card)."""
    times = [s.device_ms for s in select(record) if s.name == name]
    if not times or any(t is None for t in times):
        return None
    return sum(times) / len(times)
