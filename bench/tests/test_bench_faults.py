"""``correct`` comes out false when the timed path is broken underneath.

Each cell runs at a tiny size on the CPU (the harness's look for a card
skipped) with one fault of ``bench/faults.py`` planted in the program: an
update that leaves the graph as it was, a walk that returns its input,
half of each batch left out, each walk's largest visit count altered where
it is produced, and its small visit counts altered.
The control (the plain reference in bfloat16 in the program's place) fails
too, and the same runs with nothing planted pass.  A cell on one chip has
no exchange between chips to leave out.
"""
from __future__ import annotations

import pytest

from bench import faults
from bench.tests import tiny

CELLS = tiny.CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = tiny.run(cell, seconds=0.2)
    assert r["correct"] is True, r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = tiny.run(cell, seconds=0.2, control=True)
    assert r["correct"] is False
    assert r["checks"]["walk_gap"]["value"] > r["checks"]["walk_gap"]["limit"]
    assert r["checks"]["walk_l1"]["value"] > r["checks"]["walk_l1"]["limit"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    faults.plant(fault, monkeypatch.setattr)
    try:
        r = tiny.run(cell, seconds=0.2)
    except RuntimeError as e:
        # a walk that does no work can outrun the mix's pool: the run then
        # ends without a result, which fails the check as well
        assert "ran out" in str(e)
        return
    assert r["correct"] is False, (fault, r["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_small_visits_altered_fail_walk_l1(cell, monkeypatch):
    faults.plant("small_visits_altered", monkeypatch.setattr)
    r = tiny.run(cell, seconds=0.2)
    assert r["checks"]["walk_l1"]["value"] > r["checks"]["walk_l1"]["limit"], r["checks"]
