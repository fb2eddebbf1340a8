"""Reductions the per-layer metric files share; each takes the record a
loop returned (``record["trace"]`` is the reduced device trace, None in a
run without one) and returns None when there is nothing to read."""
from __future__ import annotations

from . import roofline


def span_ms(record, name: str):
    return record["spans"].mean_ms(name)


def idle_pct(record):
    t = record.get("trace")
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def idle_pct_of_rounds(record):
    """Share of an untraced round in which the device is idle: 1 - the
    device-busy seconds a traced round (the union of the trace's
    operations over its rounds; the profiler does not slow the device)
    over the mean seconds of the untraced rounds (the profiler's launch
    hooks slow the host's part of a traced round)."""
    t = record.get("trace")
    rounds = len(record.get("traced_walks") or [])
    plain = record.get("round_s_untraced")
    if not t or t["busy_s"] <= 0 or not rounds or not plain:
        return None
    return 100.0 * (1.0 - t["busy_s"] / rounds / plain)


def peak_gb(record):
    return record["peak_bytes"] / 1e9 if record.get("peak_bytes") else None


def kernel_seconds(record, needle: str):
    """(device seconds, launches) of the traced operations whose name
    holds ``needle``."""
    t = record.get("trace")
    if not t:
        return 0.0, 0
    hits = [v for k, v in t["device_ops"].items() if needle in k]
    return sum(v["seconds"] for v in hits), sum(v["count"] for v in hits)


def tile_cumsum_roofline(record):
    """The traced walks' ``tile_cumsum`` launches (one a step, on [B·T,
    128] tiles): their bytes at the HBM peak over their device time, in %.
    None when the trace's launches are not the walks' steps."""
    walks = record.get("traced_walks") or []
    seconds, launches = kernel_seconds(record, "tile_cumsum_kernel")
    if not walks or launches != sum(steps for steps, _, _ in walks):
        return None
    nbytes = sum(steps * roofline.tile_cumsum_bytes(rows * tiles) for steps, rows, tiles in walks)
    return roofline.share_of_bytes_roofline(nbytes, seconds)


def step_device_ms(record):
    """Device busy ms of the traced window per walk step."""
    t = record.get("trace")
    steps = sum(s for s, _, _ in record.get("traced_walks") or [])
    if not t or t["busy_s"] <= 0 or not steps:
        return None
    return 1e3 * t["busy_s"] / steps
