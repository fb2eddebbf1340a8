"""The port's program spans (``repro_torch.runtime.trace``).

Off (no profiler running) a span costs one flag check and records nothing;
under ``torch.profiler`` a ``DiGraph`` apply and reverse walk record their
spans with the right parents, one root id per call, on the clock kineto
stamps its events with.  The card's device times are checked by the
``gpu``-marked test:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_trace.py
"""
import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import DiGraph, csr, edgebatch, updates
from repro_torch.kernels.slot_update import ops as su_ops
from repro_torch.io import synthetic
from repro_torch.runtime import trace

APPLY_CHILDREN = {"apply.rows", "apply.alloc", "apply.groups", "slot_update.pack",
                  "slot_update.wait", "slot_update.count", "apply.free"}
WALK_CHILDREN = {"slot_walk.gather", "slot_walk.scan", "slot_walk.diff"}


@pytest.fixture(autouse=True)
def empty_ring():
    trace.clear()
    yield
    trace.clear()


def _graph(device="cpu"):
    rng = np.random.default_rng(3)
    src, dst = synthetic.uniform_edges(rng, 40, 200)
    return DiGraph.from_csr(csr.from_coo(src, dst, n=40, device=device), device=device)


def _mixed_plan(seed=5):
    """Deletions and insertions; vertex 0 gets 40 new edges, so its row grows
    out of its block."""
    rng = np.random.default_rng(seed)
    s = np.concatenate([np.zeros(40, np.int64), rng.integers(0, 40, 30)])
    d = np.concatenate([np.arange(40, 80), rng.integers(0, 40, 30)])
    w = rng.random(70).astype(np.float32)
    ds, dd = rng.integers(0, 40, 30), rng.integers(0, 40, 30)
    return updates.plan_update(inserts=edgebatch.from_arrays(s, d, w),
                               deletes=edgebatch.from_arrays(ds, dd))


def _apply_and_walk(g):
    g.apply(_mixed_plan())
    return g.reverse_walk(3, normalize=True)


def test_profiler_off_records_nothing_and_shares_one_span():
    g = _graph()
    _apply_and_walk(g)
    assert trace.spans() == []
    assert trace.span("a") is trace.span("b", device=True)


def test_profiler_off_reads_no_clock_allocates_nothing_records_no_event(monkeypatch):
    def forbidden(*_a, **_k):
        raise AssertionError("called with the profiler off")

    monkeypatch.setattr(trace.time, "time_ns", forbidden)
    monkeypatch.setattr(trace.torch.cuda, "Event", forbidden)
    monkeypatch.setattr(trace, "Span", forbidden)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with trace.span("x", device=True):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == trace.__file__ and d.size_diff > 0]
    assert grown == []


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_profiler_on_records_the_spans_of_apply_and_walk():
    g = _graph()
    with profile(activities=[ProfilerActivity.CPU]):
        _apply_and_walk(g)
    recs = trace.spans()
    by = _by_name(recs)
    assert set(by) == {"digraph.apply", "digraph.reverse_walk"} | APPLY_CHILDREN | WALK_CHILDREN
    (apply,), (walk,) = by["digraph.apply"], by["digraph.reverse_walk"]
    for root in (apply, walk):
        assert root.parent == -1 and root.root == root.index
    for name in APPLY_CHILDREN:
        (rec,) = by[name]
        assert (rec.parent, rec.root) == (apply.index, apply.index), name
        assert _inside(rec, apply), name
    # the merge's counters are computed after the spans the apply metrics read
    (pack,), (wait,) = by["slot_update.pack"], by["slot_update.wait"]
    (count,) = by["slot_update.count"]
    assert pack.end_ns <= wait.start_ns and wait.end_ns <= count.start_ns
    assert pack.counters is None and wait.counters is None
    assert count.counters[-1]["width"] > 32  # vertex 0's row, the widest group last
    for name in WALK_CHILDREN:
        assert len(by[name]) == 3, name
        for rec in by[name]:
            assert (rec.parent, rec.root) == (walk.index, walk.index), name
            assert _inside(rec, walk), name
    assert apply.end_ns <= walk.start_ns
    assert all(r.device_ms is None for r in recs)  # no device span off the card
    # one step's phases run in order
    steps = zip(by["slot_walk.gather"], by["slot_walk.scan"], by["slot_walk.diff"])
    for gather, scan, diff in steps:
        assert gather.end_ns <= scan.start_ns and scan.end_ns <= diff.start_ns


def test_spans_stop_with_the_profiler():
    g = _graph()
    with profile(activities=[ProfilerActivity.CPU]):
        g.apply(_mixed_plan())
    n = len(trace.spans())
    g.reverse_walk(3)
    assert len(trace.spans()) == n > 0
    trace.clear()
    assert trace.spans() == []


def test_an_aten_op_inside_a_span_lands_inside_it():
    a = torch.rand(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("mm") as s:
            torch.mm(a, a)
    (rec,) = trace.spans()
    assert rec is s
    mms = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert mms
    for e in mms:
        assert rec.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= rec.end_ns


def test_the_ring_drops_its_oldest_records_at_its_bound():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("first") as first:
            pass
        for _ in range(trace.RING + 2):
            with trace.span("x"):
                pass
    recs = trace.spans()
    assert len(recs) == trace.RING
    assert all(r.name == "x" for r in recs)
    assert recs[0].index == first.index + 3
    assert [r.index for r in recs] == sorted(r.index for r in recs)


def test_an_apply_on_a_second_thread_gets_a_root_of_its_own():
    g = _graph()
    done = []

    def writer():
        g.apply(_mixed_plan())
        done.append(True)

    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer") as outer:
            t = threading.Thread(target=writer)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive() and done
    by = _by_name(trace.spans())
    (apply,) = by["digraph.apply"]
    assert apply.parent == -1 and apply.root == apply.index != outer.root
    for name in APPLY_CHILDREN:
        (rec,) = by[name]
        assert rec.root == apply.index and rec.parent == apply.index
    assert by["outer"] == [outer] and outer.parent == -1


def _hand_graph(device="cpu"):
    """Row 0: 3 edges in a 4-slot block; row 1: 40 in 64 slots; row 4: 1 in 2;
    the other rows empty."""
    src = np.array([0] * 3 + [1] * 40 + [4], np.int64)
    dst = np.array([1, 2, 3, *range(10, 50), 0], np.int64)
    return DiGraph.from_csr(csr.from_coo(src, dst, n=50, device=device), device=device)


def _hand_plan():
    """Row 0 grows out of its block (2 inserts, 1 delete), row 3 opens a
    2-slot block, row 4 deletes an edge it lacks, row 1 (2 deletes, 1
    insert) stays in its 64-slot block."""
    ins = edgebatch.from_arrays(np.array([0, 0, 1, 3]), np.array([4, 5, 7, 1]),
                                np.ones(4, np.float32))
    dels = edgebatch.from_arrays(np.array([0, 1, 1, 4]), np.array([2, 10, 11, 9]))
    return updates.plan_update(inserts=ins, deletes=dels)


def _hand_counters(narrow_width):
    """The hand count of ``_hand_plan``'s two merges after a walk (which
    warms ``[lo, hi)``): rows 0, 3, 4 narrow, row 1 wide."""
    narrow = {"width": narrow_width, "rows": 3, "entries": 3 + 1 + 1, "live": 3 + 0 + 1,
              "new_cap": 8 + 2 + 2, "moved_new_cap": 8 + 2, "moved_old_cap": 4 + 0,
              "lohi": True, "scratch_bytes": 0}
    wide = {"width": 64, "rows": 1, "entries": 3, "live": 40, "new_cap": 64,
            "moved_new_cap": 0, "moved_old_cap": 0, "lohi": True, "scratch_bytes": 0}
    return [narrow, wide]


def _counted(recs):
    (count,) = [r for r in recs if r.name == "slot_update.count"]
    return count.counters


def test_profiler_off_counts_nothing_and_computes_no_counter(monkeypatch):
    def forbidden(*_a, **_k):
        raise AssertionError("a counter computed with the profiler off")

    monkeypatch.setattr(su_ops, "group_counters", forbidden)
    g = _hand_graph()
    g.reverse_walk(2)
    g.apply(_hand_plan())
    trace.count(rows=1)
    assert not trace.recording() and trace.spans() == []


def test_counters_equal_a_hand_count_of_a_small_plan():
    g = _hand_graph()
    g.reverse_walk(2)
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.recording()
        g.apply(_hand_plan())
    assert _counted(trace.spans()) == _hand_counters(8)  # width floor 8 off the card
    assert sorted(g.edges_of(0).tolist()) == [1, 3, 4, 5]


def test_count_attaches_to_the_innermost_open_span_only():
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count(x=1)  # no span open: kept nowhere
        with trace.span("outer") as outer:
            with trace.span("inner") as inner:
                trace.count(x=2)
                trace.count(y=3)
    assert inner.counters == [{"x": 2}, {"y": 3}] and outer.counters is None
    assert [r.name for r in trace.spans()] == ["inner", "outer"]


class _FakeEvent:
    made = 0
    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.at = None
        self.done = False

    def record(self):
        _FakeEvent.clock += 1.0
        self.at = _FakeEvent.clock

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.at - self.at


def test_device_spans_resolve_once_their_events_complete(monkeypatch):
    monkeypatch.setattr(trace.torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(trace, "_POOL", [])
    _FakeEvent.made = 0
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("d", device=True) as d:
            pass
        with trace.span("h") as h:
            pass
    assert _FakeEvent.made == 2 and h._events is None
    assert [r.device_ms for r in trace.spans()] == [None, None]  # not complete
    for ev in d._events:
        ev.done = True
    recs = trace.spans()
    assert recs[0].device_ms == 1.0 and recs[1].device_ms is None
    assert len(trace._POOL) == 2  # the events go back for reuse
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("again", device=True):
            pass
    assert _FakeEvent.made == 2 and trace._POOL == []


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_walk_step_spans_carry_device_time_on_the_card(cuda):
    g = _graph(cuda)
    _apply_and_walk(g)  # builds the kernels outside the profile
    with profile(activities=[ProfilerActivity.CUDA]):
        _apply_and_walk(g)
        torch.cuda.synchronize()
    by = _by_name(trace.spans())
    for name in WALK_CHILDREN:
        assert len(by[name]) == 3
        assert all(r.device_ms is not None and r.device_ms >= 0 for r in by[name]), name
    for name in APPLY_CHILDREN | {"digraph.apply", "digraph.reverse_walk"}:
        assert all(r.device_ms is None for r in by[name]), name


@pytest.mark.gpu
def test_merge_counters_match_the_launches_on_the_card(cuda):
    g = _hand_graph(cuda)
    g.reverse_walk(2)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.apply(_hand_plan())
        torch.cuda.synchronize()
    assert _counted(trace.spans()) == _hand_counters(32)  # one warp a row up to 32 slots
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert sum("merge_rows_warp_kernel" in n for n in names) == 1
    assert sum("merge_rows_block_kernel" in n for n in names) == 1
