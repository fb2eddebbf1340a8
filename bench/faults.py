"""Faults planted under the timed path, to see ``correct`` come out false.

Each fault names the attributes it replaces; ``plant(name, setattr_)``
sets them with the caller's ``setattr`` (pytest's ``monkeypatch.setattr``
in the tests, the builtin in ``control.py``, whose process ends after):

* ``apply_unchanged``: an update that leaves the graph as it was;
* ``walk_unchanged``: a walk that returns its input;
* ``half_batch``: half of each batch left out;
* ``answer_altered``: each walk's largest visit count altered by 1%;
* ``small_visits_altered``: each walk's nonzero visits below their
  median (the many vertices of small degree) altered by half.
"""
from __future__ import annotations

import torch

from repro_torch.core.digraph import DiGraph
from repro_torch.core.walk_image import WalkImage

from . import system


def _apply_unchanged():
    return [(DiGraph, "apply", lambda self, plan, **kw: (self, 0))]


def _walk_unchanged():
    def walk(self, steps, *, backend="auto", normalize=False, visits0=None):
        v = visits0 if visits0 is not None else torch.ones(self.nv, device=self.device)
        return torch.as_tensor(v, dtype=torch.float32).clone()
    return [(WalkImage, "walk", walk)]


def _half_batch():
    plan_round = system.plan_round

    def half(pool, r):
        return plan_round({k: v[:, : max(v.shape[1] // 2, 1)] for k, v in pool.items()}, r)
    return [(system, "plan_round", half)]


def _altered(alter):
    walk = WalkImage.walk

    def altered(self, *a, **kw):
        out = walk(self, *a, **kw)
        for row in out.reshape(-1, out.shape[-1]):
            alter(row)
        return out
    return [(WalkImage, "walk", altered)]


def _top(row):
    i = row.argmax()
    row[i] = row[i] * 1.01


def _small(row):
    live = row[row > 0]
    if live.numel():
        row[(row > 0) & (row < live.median())] *= 1.5


FAULTS = {
    "apply_unchanged": _apply_unchanged,
    "walk_unchanged": _walk_unchanged,
    "half_batch": _half_batch,
    "answer_altered": lambda: _altered(_top),
    "small_visits_altered": lambda: _altered(_small),
}


def plant(name: str, setattr_=setattr) -> None:
    for obj, attr, value in FAULTS[name]():
        setattr_(obj, attr, value)
