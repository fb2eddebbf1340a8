"""Spans inside the program, recorded only while ``torch.profiler`` runs.

``span(name)`` marks a part of the work (``DiGraph.apply``'s allocation,
a walk step's gather, ...).  With the profiler off it is one flag check
that returns a shared no-op context manager: no clock is read, nothing is
allocated, no CUDA event is recorded.  With the profiler on (an operator's
``torch.profiler.profile``, or the benchmark's ``--trace 1`` window) each
span that closes appends one ``Span`` to a bounded in-memory ring, the
oldest dropped first:

- ``start_ns`` / ``end_ns`` on the epoch-nanosecond clock (``time.time_ns``)
  that kineto stamps the profiler's events with, so a span and the
  operations it launched can be read side by side;
- ``parent``, the ``index`` of the span open around it on the same thread
  (-1 for a root), and ``root``, the ``index`` of its root: one apply, one
  walk;
- with ``device=True``, a pair of CUDA timing events recorded on the
  current stream around the span; ``spans()`` turns them into
  ``device_ms`` once they have completed (read after a synchronise).

``count(**values)`` attaches one record of counters (a dict of numbers:
one launch's rows, bytes, ...) to the innermost span open on the thread,
in its ``counters`` list; with the profiler off it is the same one flag
check and keeps nothing.  A caller whose counters cost host work to
compute asks ``recording()`` first, so that work too runs only under the
profiler.

No span ever synchronises.  ``spans()`` returns the ring's records and
``clear()`` empties it; nothing is written anywhere.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

#: records kept; the oldest are dropped beyond it
RING = 1 << 16

_RING: collections.deque = collections.deque(maxlen=RING)
_SEQ = itertools.count()
_LOCAL = threading.local()
#: CUDA timing events of resolved spans, for reuse
_POOL: list = []
_RESOLVE = threading.Lock()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


def _event():
    try:
        return _POOL.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class Span:
    """One recorded span (see the module's docstring)."""

    __slots__ = ("name", "index", "parent", "root", "start_ns", "end_ns",
                 "device_ms", "counters", "_events")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device_ms = None
        self.counters = None
        self._events = (_event(), _event()) if device else None

    def __enter__(self):
        stack = _stack()
        self.index = next(_SEQ)
        if stack:
            self.parent, self.root = stack[-1].index, stack[-1].root
        else:
            self.parent, self.root = -1, self.index
        stack.append(self)
        if self._events is not None:
            self._events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record()
        _stack().pop()
        _RING.append(self)
        return False


def span(name: str, device: bool = False):
    """A context manager marking ``name``; ``device=True`` only where the
    span's work runs on the current CUDA stream."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, device)


def recording() -> bool:
    """True while spans and counters record (the profiler runs)."""
    return _profiler._is_profiler_enabled


def count(**values) -> None:
    """Append ``values`` as one record to the ``counters`` of the innermost
    span open on this thread; nothing with the profiler off or no span
    open."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _stack()
    if stack:
        top = stack[-1]
        if top.counters is None:
            top.counters = []
        top.counters.append(values)


def spans() -> list:
    """The ring's records, oldest first, with ``device_ms`` filled in for
    every device span whose events have completed."""
    out = list(_RING)
    with _RESOLVE:  # each span's events go back to the pool once
        for s in out:
            ev = s._events
            if ev is not None and ev[1].query():
                s.device_ms = ev[0].elapsed_time(ev[1])
                s._events = None
                _POOL.extend(ev)
    return out


def clear() -> None:
    _RING.clear()
