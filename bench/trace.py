"""Host spans and the device trace of a ``--trace 1`` run.

``Spans`` times the benchmark's own calls into the program on the host
clock, in every run (the per-layer metrics print them only when traced),
outside the traced part of the window; inside it, it stamps each span on
the wall clock that the profiler's timestamps use.  ``Tracer`` runs
``torch.profiler`` over the last ``seconds`` of the measured window (its
launch hooks stay on once started), recording the device's activity
only (kernels, copies, sets: recording every host operation would slow the
launch-bound walk by more than half again), and reduces the trace to what
the metric readers take: the seconds in which an operation ran on the
device (the union of their intervals), device time by operation name, and
the idle gaps by the benchmark span the host was in.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

#: longest operation name kept in a breakdown
NAME_MAX = 120


class Spans:
    def __init__(self):
        self.times = collections.defaultdict(list)
        self.stamps: list = []      # (start_ns, end_ns, name) while stamping
        self.stamping = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        """Time the block; while the profiler runs (which slows the host's
        launches) stamp it for the trace instead of counting its time."""
        if self.stamping:
            w0 = time.time_ns()
            yield
            self.stamps.append((w0, time.time_ns(), name))
            return
        t0 = time.perf_counter()
        yield
        self.times[name].append(time.perf_counter() - t0)

    def mean_ms(self, name: str):
        xs = self.times.get(name)
        return 1e3 * sum(xs) / len(xs) if xs else None


def _device_events(prof) -> list:
    """[(start_ns, end_ns, name)] of what ran on the device."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        user = getattr(e, "is_user_annotation", None)
        if user is not None and user():
            continue
        s = int(e.start_ns())
        out.append((s, s + int(e.duration_ns()), e.name()))
    return out


def _union(intervals) -> list:
    """Merged [start, end) intervals of a list sorted by start."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _label(mid: float, stamps: list, starts: list) -> str:
    """The benchmark span the host was in at ``mid``, if any."""
    i = bisect.bisect_right(starts, mid) - 1
    if i >= 0 and stamps[i][1] > mid:
        return f"host in {stamps[i][2]}"
    return "host outside the benchmark's spans"


def summarize(dev: list, stamps: list, window_s: float) -> dict:
    """Reduce device events and host span stamps to the record's entries."""
    dev = sorted(dev)
    merged = _union([(s, e) for s, e, _ in dev])
    by_name: dict = collections.defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        by_name[name][0] += (e - s) * 1e-9
        by_name[name][1] += 1
    stamps = sorted(stamps)
    starts = [s for s, _, _ in stamps]
    idle: dict = collections.defaultdict(float)
    for a, b in zip(merged, merged[1:]):
        idle[_label((a[1] + b[0]) / 2, stamps, starts)] += (b[0] - a[1]) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": sum(e - s for s, e in merged) * 1e-9,
        "window_s": window_s,
        "device_ops": {k: {"seconds": v[0], "count": v[1]} for k, v in by_name.items()},
        "breakdown": {
            "device_ops": [[k[:NAME_MAX], v[0]] for k, v in top[:10]],
            "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        },
    }


class Tracer:
    """The profiler over the last ``seconds`` of the window (``--trace 1``)."""

    def __init__(self, enabled: bool, seconds: float, spans: Spans, device):
        self.enabled = bool(enabled)
        self.seconds = float(seconds)
        self.spans = spans
        self.device = device
        self.active = False
        self.summary = None
        self._prof = None
        self._t0 = 0.0
        self._window_s = 0.0

    def start(self) -> None:
        if not self.enabled:
            return
        act = (torch.profiler.ProfilerActivity.CUDA if self.device.type == "cuda"
               else torch.profiler.ProfilerActivity.CPU)
        self._prof = torch.profiler.profile(activities=[act])
        self._prof.__enter__()
        self.spans.stamping = True
        self.active = True
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        """End the trace when the window closes (``reduce`` reads it later)."""
        if not self.active:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.spans.stamping = False
        self.active = False

    def reduce(self) -> None:
        """Reduce the stopped trace to ``summary`` (outside the window)."""
        if self._prof is not None and not self.active:
            dev = _device_events(self._prof) if self.device.type == "cuda" else []
            self.summary = summarize(dev, self.spans.stamps, self._window_s)
            self._prof = None
