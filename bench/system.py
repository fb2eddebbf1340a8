"""The benchmark's calls into the program under test (``repro_torch``).

Everything the loops take from the program goes through here: the graph's
build (``csr.from_coo`` → ``DiGraph.from_csr``), a round's planning
(``edgebatch.from_arrays`` → ``updates.plan_update``), its apply, the walk,
and the walk image's tile count.  The program sees only the
arrays the benchmark generated.
"""
from __future__ import annotations

import torch

from repro_torch.core import csr as csr_mod
from repro_torch.core import edgebatch, updates
from repro_torch.core.digraph import DiGraph

from . import gen


def build_graph(cfg: dict, seed: int, device):
    """Generate the configuration's graph on ``device`` and load it.
    -> (DiGraph, device arrays (src, dst, wgt), n)."""
    src, dst, wgt, n = gen.make_graph(cfg, seed, device)
    c = csr_mod.from_coo(src, dst, wgt, n=n, dedup=False, presorted=True, device=device)
    g = DiGraph.from_csr(c, device=device)
    return g, (src, dst, wgt), n


def plan_round(pool: dict, r: int):
    """Round ``r`` of a batch pool as a fresh UpdatePlan (new EdgeBatch
    objects every call, so the plan cache never answers)."""
    dels = edgebatch.from_arrays(pool["del_src"][r], pool["del_dst"][r])
    ins = edgebatch.from_arrays(pool["ins_src"][r], pool["ins_dst"][r], pool["ins_wgt"][r])
    return updates.plan_update(inserts=ins, deletes=dels)


def round_batch(pool: dict, r: int):
    """Round ``r`` as the reference takes it."""
    return (pool["del_src"][r], pool["del_dst"][r],
            pool["ins_src"][r], pool["ins_dst"][r], pool["ins_wgt"][r])


def walk(g: DiGraph, steps: int, visits0=None) -> torch.Tensor:
    return g.reverse_walk(steps, normalize=True, visits0=visits0)


def walk_tiles(g: DiGraph) -> int:
    """128-slot tiles the last walk covered (the image it walked)."""
    return -(-g.to_walk_image().edges_hi() // 128)


def graph_arrays(g: DiGraph):
    """The graph as (rows, cols, weights) device tensors, CSR order."""
    c = g.to_csr()
    rows = torch.repeat_interleave(
        torch.arange(c.n, device=c.offsets.device),
        (c.offsets[1:] - c.offsets[:-1]).to(torch.int64))
    return rows, c.dst, c.wgt


def arena_bump(g: DiGraph) -> int:
    """Slots of the arena's allocated prefix (what a walk covers)."""
    return int(g.layout.bump)
