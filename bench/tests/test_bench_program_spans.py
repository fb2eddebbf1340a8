"""The per-layer metrics that read the program's own spans.

``program_spans.select`` keeps the spans inside the traced stamps; the
apply metrics divide by the selected ``digraph.apply`` roots, the walk
metrics by the selected steps; a traced tiny run on the CPU prints the
apply metrics and none of the device ones.
"""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from bench import harness, program_spans
from bench.tests import tiny

SPEC = harness.benchmark()
NEW = {m["name"]: m for m in SPEC["per_layer"] if m["source"] == "program_span"}
APPLY = sorted(n for n in NEW if n.startswith("apply_"))
DEVICE = sorted(n for n in NEW if n.startswith("walk_"))
MS = 1_000_000


class Stamps:
    def __init__(self, stamps):
        self.stamps = stamps


def _span(name, index, start_ms, end_ms, *, parent=-1, root=None, device_ms=None):
    return SimpleNamespace(name=name, index=index, parent=parent,
                           root=index if root is None else root,
                           start_ns=int(start_ms * MS), end_ns=int(end_ms * MS),
                           device_ms=device_ms)


def _apply_round(first, at):
    """A digraph.apply root at ``at`` ms with 1 ms of alloc, 2 of free, 3 of
    rows, 4 of groups, 5 of pack and 6 of wait."""
    kids = [("apply.alloc", 1), ("apply.free", 2), ("apply.rows", 3), ("apply.groups", 4),
            ("slot_update.pack", 5), ("slot_update.wait", 6)]
    out, t = [_span("digraph.apply", first, at, at + 30)], at
    for i, (name, ms) in enumerate(kids, 1):
        out.append(_span(name, first + i, t, t + ms, parent=first, root=first))
        t += ms
    return out


@pytest.fixture
def program(monkeypatch):
    spans: list = []
    monkeypatch.setattr(program_spans, "program_spans", lambda: list(spans))
    return spans


def test_select_keeps_the_spans_inside_the_traced_stamps(program):
    program += [_span("early", 0, 5, 6), _span("inside", 1, 10, 20),
                _span("straddles", 2, 95, 105), _span("late", 3, 200, 201)]
    record = {"spans": Stamps([(10 * MS, 50 * MS, "plan"), (60 * MS, 100 * MS, "walk")])}
    assert [s.name for s in program_spans.select(record)] == ["inside"]
    assert program_spans.select({"spans": Stamps([])}) == []


def test_apply_metrics_divide_by_the_selected_apply_roots(program):
    program += _apply_round(0, 0)          # before the traced stamps
    program += _apply_round(10, 100)
    program += _apply_round(20, 200)
    # a fused_apply under another root (a walk image's patch) is not apply's
    program += [_span("walk_image.patch", 30, 240, 260),
                _span("slot_update.pack", 31, 241, 259, parent=30, root=30)]
    record = {"spans": Stamps([(100 * MS, 300 * MS, "apply")])}
    want = {"apply_alloc_ms.stream": 3.0, "apply_groups_ms.stream": 7.0,
            "apply_pack_ms.stream": 5.0, "apply_wait_ms.stream": 6.0}
    for name in APPLY:
        assert harness.metric_reader(name).read(record) == pytest.approx(want[name]), name
    assert harness.metric_reader("apply_pack_ms.stream").read(
        {"spans": Stamps([(500 * MS, 600 * MS, "apply")])}) is None


def test_walk_metrics_are_device_ms_per_step(program):
    program += [_span("digraph.reverse_walk", 0, 10, 90)]
    for step in range(4):
        for k, name in enumerate(("slot_walk.gather", "slot_walk.scan", "slot_walk.diff")):
            program.append(_span(name, 1 + 3 * step + k, 11 + step, 11.5 + step, parent=0,
                                 root=0, device_ms=(k + 1) * (step + 1)))
    record = {"spans": Stamps([(0, 100 * MS, "walk")])}
    want = {"gather": 2.5, "scan": 5.0, "diff": 7.5}  # (k + 1) × mean(1, 2, 3, 4)
    for name in DEVICE:
        phase = name.split("_")[1]
        assert harness.metric_reader(name).read(record) == pytest.approx(want[phase]), name
    program[-1].device_ms = None  # an unresolved event: no number
    assert program_spans.device_ms_per_span(record, "slot_walk.diff") is None
    assert program_spans.device_ms_per_span(record, "slot_walk.gather") == pytest.approx(2.5)


def test_a_program_without_spans_gives_nothing(monkeypatch):
    import repro_torch.runtime

    # as at a parent commit: no ``repro_torch.runtime.trace`` to import
    monkeypatch.delattr(repro_torch.runtime, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    assert program_spans.program_spans() == []
    record = {"spans": Stamps([(0, 100 * MS, "apply")])}
    assert all(harness.metric_reader(n).read(record) is None for n in NEW)


def test_traced_tiny_road_run_prints_the_apply_metrics_and_no_device_one():
    result = tiny.run("road-europe-stream", traced=True)
    assert result["correct"] is True
    metrics = result["metrics"]
    for name in APPLY:
        assert isinstance(metrics[name]["value"], float) and metrics[name]["value"] >= 0, name
        assert metrics[name]["unit"] == "ms"
    assert not set(DEVICE) & set(metrics)


def test_traced_tiny_walk16_run_prints_no_device_metric():
    result = tiny.run("social22-walk16", traced=True)
    assert result["correct"] is True
    assert not set(NEW) & set(result["metrics"])
