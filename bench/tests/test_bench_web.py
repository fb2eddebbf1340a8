"""The directed web crawl (``rmat23-web``) against the plain reference, and
the merge's counters and byte count that its wide rows exercise.

The reference tests of ``test_bench_reference.py`` run on the web
configuration's own generator parameters (directed, the Graph500
quadrants) at tiny size, where rows grow wider than a warp; a tiny web
round's counters put rows in groups wider than 32 slots; and
``merge_roofline.merge_rows_bytes`` and its share are held to hand counts.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from bench import harness, merge_roofline, system
from bench.tests import test_bench_reference as base
from bench.tests import tiny
from repro_torch.core import DiGraph, csr, edgebatch, updates
from repro_torch.runtime import trace

NAME = "rmat23-web"
#: the configuration's generator parameters, as ``base.CONFIGS`` keeps them
WEB = {k: v for k, v in harness.load_json(harness.HERE / "configs" / f"{NAME}.json").items()
       if k in ("generator", "a", "b", "c", "edge_factor", "weight_range", "symmetric")}


@pytest.fixture(autouse=True)
def web_config(monkeypatch):
    monkeypatch.setitem(base.CONFIGS, NAME, WEB)


@pytest.fixture
def ring():
    trace.clear()
    yield
    trace.clear()


def test_web_config_is_directed_with_the_graph500_quadrants():
    assert WEB["symmetric"] is False and (WEB["a"], WEB["b"], WEB["c"]) == (0.57, 0.19, 0.19)


def test_web_generator_is_seeded_sorted_and_unique():
    base.test_generator_is_seeded_sorted_and_unique(NAME)


def test_web_reference_updates_match_the_program():
    base.test_reference_updates_match_the_program(NAME)


def test_web_reference_walks_match_the_program():
    base.test_reference_walks_match_the_program(NAME)


def test_tiny_web_rounds_merge_rows_wider_than_a_warp(ring):
    g, _, _, pool = base.graph_and_pool(NAME, 13, 3, 80)
    assert int(g.degrees.max()) > 32
    with profile(activities=[ProfilerActivity.CPU]):
        for r in range(3):
            g.apply(system.plan_round(pool, r))
    wide = [c for s in trace.spans() if s.name == "slot_update.count"
            for c in s.counters if c["width"] > 32]
    assert wide
    assert sum(c["rows"] for c in wide) >= 3 and sum(c["live"] for c in wide) > 32


def _hand_counted():
    """The program's counters of a plan: row 0 grows out of its 4-slot
    block (2 inserts, 1 delete), row 3 opens a 2-slot block, row 4 deletes
    an edge it lacks, row 1 (40 edges in 64 slots) takes 2 deletes and an
    insert; a walk first warms [lo, hi)."""
    src = np.array([0] * 3 + [1] * 40 + [4], np.int64)
    dst = np.array([1, 2, 3, *range(10, 50), 0], np.int64)
    g = DiGraph.from_csr(csr.from_coo(src, dst, n=50, device="cpu"), device="cpu")
    g.reverse_walk(2)
    ins = edgebatch.from_arrays(np.array([0, 0, 1, 3]), np.array([4, 5, 7, 1]),
                                np.ones(4, np.float32))
    dels = edgebatch.from_arrays(np.array([0, 1, 1, 4]), np.array([2, 10, 11, 9]))
    with profile(activities=[ProfilerActivity.CPU]):
        g.apply(updates.plan_update(inserts=ins, deletes=dels))
    (count,) = [s for s in trace.spans() if s.counters]
    return count.counters


def test_merge_rows_bytes_equals_a_hand_count(ring):
    narrow, wide = _hand_counted()
    # narrow: 3 real rows (13 pad rows and the runs' padding count nothing)
    want_narrow = (3 * (24 + 4)        # row_ops and counts
                   + 8 * (3 + 0 + 1)   # live prefixes of rows 0, 3, 4
                   + 12 * (3 + 1 + 1)  # run entries
                   + 8 * (8 + 2 + 2)   # new blocks
                   + 4 * (8 + 2)       # owner map over moved rows' new blocks
                   + 4 * 4             # SENTINEL over row 0's old block
                   + 3 * 8)            # [lo, hi)
    want_wide = 28 + 8 * 40 + 12 * 3 + 8 * 64 + 8
    assert merge_roofline.merge_rows_bytes(narrow) == want_narrow == 352
    assert merge_roofline.merge_rows_bytes(wide) == want_wide == 904
    assert merge_roofline.merge_rows_bytes({**wide, "lohi": False}) == want_wide - 8


MS = 1_000_000


def _record(ops, rounds=2):
    return {"spans": SimpleNamespace(stamps=[(0, 100 * MS, "apply")]),
            "trace": {"device_ops": ops}, "traced_walks": [(42, 1, 8)] * rounds}


@pytest.fixture
def program(monkeypatch):
    spans: list = []
    monkeypatch.setattr(merge_roofline.program_spans, "program_spans", lambda: list(spans))
    return spans


def _span(name, at, counters):
    return SimpleNamespace(name=name, index=at, parent=-1, root=at, start_ns=at * MS,
                           end_ns=(at + 1) * MS, device_ms=None, counters=counters)


def test_share_reads_the_counted_launches_over_their_kernel_time(program):
    c = {"width": 64, "rows": 1000, "entries": 3000, "live": 40000, "new_cap": 64000,
         "moved_new_cap": 0, "moved_old_cap": 0, "lohi": True, "scratch_bytes": 0}
    n = {**c, "width": 32}
    program += [_span("slot_update.count", 10, [n, c, c]),
                _span("slot_update.count", 20, [c]),
                _span("slot_update.pack", 30, None)]
    nbytes = 3 * merge_roofline.merge_rows_bytes(c)
    block = "void (anonymous namespace)::merge_rows_block_kernel(Args)"
    ops = {block: {"seconds": 1e-3, "count": 3}}
    got = merge_roofline.share(_record(ops), "wide")
    assert got == pytest.approx(100 * nbytes / 3.35e12 / 1e-3)
    assert merge_roofline.launches(_record(ops), "narrow") == [n]
    ops[block]["count"] = 4
    assert merge_roofline.share(_record(ops), "wide") is None  # launches differ
    assert merge_roofline.share(_record(ops), "narrow") is None  # no warp launch


def test_device_ms_is_the_kernel_s_traced_time_a_round():
    ops = {"merge_rows_block_kernel(Args)": {"seconds": 6e-3, "count": 22},
           "merge_rows_warp_kernel(Args)": {"seconds": 1e-4, "count": 2}}
    assert merge_roofline.device_ms(_record(ops), "wide") == pytest.approx(3.0)
    assert merge_roofline.device_ms(_record(ops), "narrow") == pytest.approx(0.05)
    assert merge_roofline.device_ms(_record(ops, rounds=0), "wide") is None
    assert merge_roofline.device_ms(_record({}), "wide") is None  # no launch traced


def test_a_program_without_counters_gives_no_share(program):
    program.append(SimpleNamespace(name="slot_update.count", index=1, parent=-1, root=1,
                                   start_ns=MS, end_ns=2 * MS, device_ms=None))
    ops = {"merge_rows_block_kernel": {"seconds": 1e-3, "count": 1}}
    assert merge_roofline.launches(_record(ops), "wide") == []
    assert merge_roofline.share(_record(ops), "wide") is None
    for name in ("merge_wide_roofline.stream", "merge_narrow_roofline.stream",
                 "merge_wide_device_ms.stream", "merge_narrow_device_ms.stream"):
        assert harness.metric_reader(name).read(_record({})) is None


def test_traced_tiny_web_run_is_correct_and_reads_no_device_metric():
    # off the card the trace holds no merge kernel to read
    result = tiny.run("web23-stream", traced=True, seconds=0.2)
    assert result["correct"] is True, result["checks"]
    assert not {m for m in result["metrics"] if m.startswith("merge_")}

