"""The benchmark's plain reference against ``repro_torch`` on small graphs.

The reference (``bench/reference``) re-applies batches to the generated
arrays and walks in float64; here it is held against the program's
``DiGraph.apply`` and ``reverse_walk`` on the CPU (the plain versions of
the kernels), and against hand-made cases of the update semantics.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench import gen, system
from bench.reference import walk as ref_walk
from bench.reference.graph import RefGraph
from bench.tests import tiny

CPU = torch.device("cpu")
CONFIGS = {
    "rmat22-social": {"generator": "rmat", "a": 0.45, "b": 0.25, "c": 0.15,
                      "edge_factor": 8, "weight_range": [0.5, 1.5], "symmetric": True},
    "road-europe-osm": {"generator": "road", "avg_degree": 2.1, "max_hop": 10,
                   "weight_range": [0.5, 1.5], "symmetric": True},
}


def config(name: str) -> dict:
    return {**CONFIGS[name], **tiny.config_sizes(CONFIGS[name])}


def graph_and_pool(name: str, seed: int, rounds: int, k: int):
    g, (src, dst, wgt), n = system.build_graph(config(name), seed, CPU)
    pool = gen.host_pool(src, dst, n, rounds, k // 2, k - k // 2, [0.5, 1.5],
                         gen.generator(seed, "traffic", CPU))
    return g, (src, dst, wgt), n, pool


def state(ref: RefGraph) -> dict:
    return {int(k): float(w) for k, w in zip(ref.keys, ref.wgt)}


def test_update_semantics_by_hand():
    n = 10
    ref = RefGraph([0, 0, 1], [1, 2, 2], [1.0, 2.0, 3.0], n, CPU)
    # delete (0,1) and (5,5) (absent); insert (0,1) again, (0,2) twice, (3,4)
    ref.apply([([0, 5], [1, 5], [0, 0, 0, 3], [1, 2, 2, 4], [7.0, 8.0, 9.0, 4.0])])
    assert state(ref) == {1: 7.0, 2: 8.0, 12: 3.0, 34: 4.0}
    ref.apply([([0, 3], [2, 4], [], [], [])])
    assert state(ref) == {1: 7.0, 12: 3.0}


def test_many_batches_at_once_equal_one_by_one():
    rng = np.random.default_rng(5)
    n = 12
    s, d = rng.integers(0, n, 60), rng.integers(0, n, 60)
    batches = [(rng.integers(0, n, 15), rng.integers(0, n, 15), rng.integers(0, n, 20),
                rng.integers(0, n, 20), rng.random(20).astype(np.float32)) for _ in range(6)]
    w = rng.random(60).astype(np.float32)
    one, many = RefGraph(s, d, w, n, CPU), RefGraph(s, d, w, n, CPU)
    for b in batches:
        one.apply([b])
    many.apply(batches)
    assert torch.equal(one.keys, many.keys) and torch.equal(one.wgt, many.wgt)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generator_is_seeded_sorted_and_unique(name):
    a = gen.make_graph(config(name), 77, CPU)
    b = gen.make_graph(config(name), 77, CPU)
    c = gen.make_graph(config(name), 78, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    assert not torch.equal(a[1], c[1])
    keys = a[0].to(torch.int64) * a[3] + a[1]
    assert bool((keys[1:] > keys[:-1]).all())
    assert float(a[2].min()) >= 0.5 and float(a[2].max()) < 1.5


def test_pool_deletes_live_edges_once():
    _, (src, dst, _), n, pool = graph_and_pool("rmat22-social", 3, 20, 40)
    keys = set((src.to(torch.int64) * n + dst).tolist())
    dels = (pool["del_src"].astype(np.int64) * n + pool["del_dst"]).ravel()
    assert len(set(dels.tolist())) == dels.size and set(dels.tolist()) <= keys


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_updates_match_the_program(name):
    g, base, n, pool = graph_and_pool(name, 11, 9, 80)
    ref = RefGraph(*base, n, CPU)
    for r in range(9):
        g.apply(system.plan_round(pool, r))
        ref.apply([system.round_batch(pool, r)])
        assert ref_walk.edges_wrong(*system.graph_arrays(g), ref) == 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_walks_match_the_program(name):
    g, base, n, pool = graph_and_pool(name, 12, 4, 80)
    ref = RefGraph(*base, n, CPU)
    for r in range(4):
        g.apply(system.plan_round(pool, r))
    ref.apply([system.round_batch(pool, r) for r in range(4)])
    rows, cols = ref.rows_cols()
    ones = torch.ones((1, n))
    want = ref_walk.walk(rows, cols, n, ones, 42, normalize=True)
    assert ref_walk.walk_gap(system.walk(g, 42).reshape(1, n), want) < 1e-6
    v0 = gen.seed_visits(np.array([[1, 2, 3, 3], [7, 0, 9, 200]]), n, CPU)
    want = ref_walk.walk(rows, cols, n, v0, 42, normalize=True)
    assert ref_walk.walk_gap(system.walk(g, 42, v0), want) < 1e-6
    want = ref_walk.walk(rows, cols, n, v0, 4, normalize=False)
    assert ref_walk.walk_gap(g.reverse_walk(4, visits0=v0), want) < 1e-6
    # the control: the reference in bfloat16 is far off
    low = ref_walk.walk(rows, cols, n, ones, 42, normalize=True, dtype=torch.bfloat16)
    assert ref_walk.walk_gap(low, ref_walk.walk(rows, cols, n, ones, 42, normalize=True)) > 1e-3


def test_walk_gap_and_edges_wrong_count_what_differs():
    ref = RefGraph([0, 1, 2], [1, 2, 0], [1.0, 2.0, 3.0], 3, CPU)
    rows, cols, w = torch.tensor([0, 1, 2]), torch.tensor([1, 2, 0]), torch.tensor([1.0, 2.0, 3.0])
    assert ref_walk.edges_wrong(rows, cols, w, ref) == 0
    assert ref_walk.edges_wrong(rows, cols, torch.tensor([1.0, 2.5, 3.0]), ref) == 1
    assert ref_walk.edges_wrong(rows[:2], cols[:2], w[:2], ref) == 1
    assert ref_walk.edges_wrong(torch.tensor([0, 0, 1, 2]), torch.tensor([1, 1, 2, 0]),
                                torch.tensor([1.0, 1.0, 2.0, 3.0]), ref) == 1
    v = torch.tensor([[1.0, 2.0, 4.0]])
    assert ref_walk.walk_gap(v, v.double()) == 0.0
    assert ref_walk.walk_gap(v * (1 + 2**-10), v.double()) == pytest.approx(2**-10)
    assert ref_walk.walk_gap(torch.full((1, 3), float("nan")), v.double()) == float("inf")


def test_walk_l1_weighs_the_small_visits():
    want = torch.tensor([[1000.0, 1.0, 1.0, 1.0, 1.0]], dtype=torch.float64)
    got = want.clone()
    got[0, 1:] *= 1.5                   # every small count off by half
    assert ref_walk.walk_gap(got, want) == pytest.approx(5e-4)
    assert ref_walk.walk_l1(got, want) == pytest.approx(2 / 1004)
    assert ref_walk.walk_l1(want, want) == 0.0
    rows = torch.cat([want, got])       # the worst row counts
    assert ref_walk.walk_l1(rows, torch.cat([want, want])) == pytest.approx(2 / 1004)
    assert ref_walk.walk_readings(got, want) == {
        "walk_gap": ref_walk.walk_gap(got, want), "walk_l1": ref_walk.walk_l1(got, want)}
    assert ref_walk.walk_l1(torch.full((1, 5), float("nan")), want) == float("inf")


@pytest.mark.gpu
def test_reference_matches_the_kernels_on_card():
    """On the card: the program's CUDA path (merge_rows_fused, tile_cumsum)
    against the reference, at scale 14."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cfg = {**CONFIGS["rmat22-social"], "scale": 14, "vertices": 1 << 14, "edges": 16 << 14}
    g, (src, dst, wgt), n = system.build_graph(cfg, 21, dev)
    pool = gen.host_pool(src, dst, n, 5, 600, 600, [0.5, 1.5], gen.generator(21, "traffic", dev))
    ref = RefGraph(src, dst, wgt, n, dev)
    for r in range(5):
        g.apply(system.plan_round(pool, r))
    ref.apply([system.round_batch(pool, r) for r in range(5)])
    assert ref_walk.edges_wrong(*system.graph_arrays(g), ref) == 0
    rows, cols = ref.rows_cols()
    want = ref_walk.walk(rows, cols, n, torch.ones((1, n)), 42, normalize=True)
    assert ref_walk.walk_gap(system.walk(g, 42).reshape(1, n), want) < 1e-5
