"""The slice end to end: one graph and one batch stream through both
packages' DiGraph (load, clone, delete/insert/mixed apply, grow-buffer,
compaction, walk), with ``state_tree()`` bit-identical after every step,
a graph built by ``repro`` carried over through its ``state_tree()``, plus
the port's own snapshot / copy-on-write / clone isolation.
"""
import numpy as np
import pytest
import torch

from repro.core import DiGraph as JDiGraph
from repro.core import edgebatch as j_eb
from repro.core import updates as j_updates
from repro.io import synthetic as j_syn
from repro_torch.core import DiGraph, csr, edgebatch, traversal, updates
from repro_torch.io import synthetic


def _same_state(g, jg, what):
    a, b = g.state_tree(), jg.state_tree()
    assert a.keys() == b.keys()
    for key in b:
        x, y = a[key], np.asarray(b[key])
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what}: {key}"
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {key}")


def _walk_checks(g, jg, steps=5):
    nv = g.n_max_vertex() + 1
    got = g.reverse_walk(steps).numpy()
    exp = traversal.reverse_walk_dense_oracle(g.to_csr().to_dense(), steps)[:nv]
    np.testing.assert_allclose(got, exp, rtol=1e-4)
    # both packages sit within 1e-4 of the oracle; against each other the
    # intra-tile sums (added in different orders) may differ by the
    # documented hub-row envelope of the uncompensated intra-tile level
    np.testing.assert_allclose(got, np.asarray(jg.reverse_walk(steps)), rtol=5e-4)


def test_slice_stream_matches_repro():
    c = synthetic.make_graph("social", scale=6, edge_factor=3, seed=11, device="cpu")
    g = DiGraph.from_csr(c, device="cpu")
    jg = JDiGraph.from_csr(j_syn.make_graph("social", scale=6, edge_factor=3, seed=11))
    _same_state(g, jg, "load")
    cl, jcl = g.clone(), jg.clone()
    _same_state(cl, jcl, "clone")
    ra, rb = np.random.default_rng(12), np.random.default_rng(12)
    n = c.n
    steps = [
        ("delete", lambda r, eb, up, h: up.plan_update(
            deletes=eb.random_deletions(r, h.to_csr(), 40))),
        ("insert", lambda r, eb, up, h: up.plan_update(
            inserts=eb.random_insertions(r, n, 40, weighted_range=(0.5, 1.5)))),
        ("mixed", lambda r, eb, up, h: up.plan_update(
            inserts=eb.random_insertions(r, n + 20, 60),
            deletes=eb.random_deletions(r, h.to_csr(), 60))),
        # hub rows outgrow their blocks and the arena buffer itself
        ("grow", lambda r, eb, up, h: up.plan_update(
            inserts=eb.from_arrays(np.repeat(np.arange(10), n + 20),
                                   np.tile(np.arange(n + 20), 10)))),
    ]
    cap_e0 = g.cap_e
    for name, make in steps:
        p, jp = make(ra, edgebatch, updates, g), make(rb, j_eb, j_updates, jg)
        _, dm = g.apply(p)
        _, jdm = jg.apply(jp)
        assert dm == jdm, name
        assert g.m == int(g.degrees.sum())
        _same_state(g, jg, name)
    assert g.cap_e > cap_e0
    _walk_checks(g, jg)
    _same_state(cl, jcl, "clone after the stream")  # clones untouched

    # the graph ``repro`` built carries over through its state_tree and
    # goes on taking updates in the port
    carried = DiGraph.from_state_tree(
        {k: np.asarray(v) for k, v in jg.state_tree().items()}, device="cpu")
    _same_state(carried, jg, "carried over")
    np.testing.assert_array_equal(carried.reverse_walk(5).numpy(),
                                  g.reverse_walk(5).numpy())
    carried.add_edges(edgebatch.random_insertions(ra, n + 30, 50))
    jg.add_edges(j_eb.random_insertions(rb, n + 30, 50))
    _same_state(carried, jg, "continued")


def test_compaction_matches_repro():
    rng = np.random.default_rng(4)
    src, dst = synthetic.uniform_edges(rng, 100, 1500)
    g = DiGraph.from_csr(csr.from_coo(src, dst, n=100, device="cpu"), device="cpu")
    from repro.core import csr as j_csr

    jg = JDiGraph.from_csr(j_csr.from_coo(src, dst, n=100))
    ra, rb = np.random.default_rng(5), np.random.default_rng(5)
    g.remove_edges(edgebatch.random_deletions(ra, g.to_csr(), 1200))
    jg.remove_edges(j_eb.random_deletions(rb, jg.to_csr(), 1200))
    assert g.live_fraction < 0.5
    assert g.maybe_compact() and jg.maybe_compact()
    _same_state(g, jg, "compact")
    g.add_edges(edgebatch.random_insertions(ra, 100, 150))
    jg.add_edges(j_eb.random_insertions(rb, 100, 150))
    _same_state(g, jg, "insert after compact")
    _walk_checks(g, jg)


def test_empty_graph_and_out_of_place_apply():
    g = DiGraph.empty(4, device="cpu")
    jg = JDiGraph.empty(4)
    _same_state(g, jg, "empty")
    b = edgebatch.from_arrays([0, 1, 2], [1, 2, 3])
    g2, dm = g.add_edges(b, inplace=False)
    jg2, _ = jg.add_edges(j_eb.from_arrays([0, 1, 2], [1, 2, 3]), inplace=False)
    assert dm == 3 and g.m == 0 and g2.m == 3
    _same_state(g2, jg2, "first edges")
    assert g2.to_edge_sets()[:4] == [{1}, {2}, {3}, set()]
    np.testing.assert_allclose(g2.reverse_walk(2).numpy(), [1, 1, 0, 0])


def _dense(g, n=64):
    a = np.zeros((n, n), np.float32)
    d = g.to_csr().to_dense()
    a[: d.shape[0], : d.shape[1]] = d
    return a


def test_snapshot_and_clone_isolation():
    rng = np.random.default_rng(23)
    src, dst = synthetic.uniform_edges(rng, 48, 300)
    g = DiGraph.from_csr(csr.from_coo(src, dst, n=48, device="cpu"), device="cpu")
    snap = g.snapshot()
    frozen = _dense(snap)
    cl = g.clone()
    for _ in range(3):
        g.add_edges(edgebatch.random_insertions(rng, 60, 20))
        g.remove_edges(edgebatch.random_deletions(rng, g.to_csr(), 8))
        np.testing.assert_array_equal(_dense(snap), frozen)
        np.testing.assert_array_equal(_dense(cl), frozen)
    after = _dense(g)
    cl.add_edges(edgebatch.random_insertions(rng, 60, 30))
    snap.remove_edges(edgebatch.random_deletions(rng, snap.to_csr(), 10))
    np.testing.assert_array_equal(_dense(g), after)


def test_cow_detaches_only_touched_buffers():
    """A non-growing post-snapshot update must keep sharing slot_rows."""
    rng = np.random.default_rng(29)
    src, dst = synthetic.uniform_edges(rng, 32, 400)
    g = DiGraph.from_csr(csr.from_coo(src, dst, n=32, device="cpu"), device="cpu")
    snap = g.snapshot()
    assert g.sealed and snap.sealed
    before = {f: getattr(snap, f).clone() for f in ("dst", "wgt", "slot_rows")}
    g.remove_edges(edgebatch.random_deletions(rng, g.to_csr(), 4))
    assert g.slot_rows is snap.slot_rows, "owner map should stay shared"
    assert g.dst is not snap.dst and g.wgt is not snap.wgt
    assert "slot_rows" in g._sealed and "dst" not in g._sealed
    # a growing update (class spill) must now detach the owner map too
    hub = np.zeros(600, np.int64)
    g.add_edges(edgebatch.from_arrays(hub, 40 + np.arange(600)))
    assert g.slot_rows is not snap.slot_rows
    for f, t in before.items():
        assert torch.equal(getattr(snap, f), t), f


def test_walk_image_tracks_updates_in_place():
    """The shared image re-points at the updated buffers and its interval
    cache is refreshed by the apply, not rebuilt on the host."""
    rng = np.random.default_rng(31)
    src, dst = synthetic.uniform_edges(rng, 64, 600)
    g = DiGraph.from_csr(csr.from_coo(src, dst, n=64, device="cpu"), device="cpu")
    img = g.to_walk_image()
    lo0, _ = img.device_blocks()
    g.add_edges(edgebatch.random_insertions(rng, 64, 20))
    assert g.to_walk_image() is img and img.dst is g.dst
    lo1, hi1 = img._blocks
    assert lo1 is not lo0
    starts = g.starts[:64]
    np.testing.assert_array_equal(lo1.numpy(), np.where(starts >= 0, starts, 0))
    np.testing.assert_array_equal(hi1.numpy(), np.where(starts >= 0, starts + g.degrees[:64], 0))


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_backend_choice_keeps_results(backend):
    rng = np.random.default_rng(3)
    src, dst = synthetic.uniform_edges(rng, 50, 400)
    g = DiGraph.from_csr(csr.from_coo(src, dst, n=50, device="cpu"), device="cpu")
    ref = g.clone()
    plan = updates.plan_update(inserts=edgebatch.random_insertions(rng, 50, 40),
                               deletes=edgebatch.random_deletions(rng, g.to_csr(), 40))
    g.apply(plan, backend=backend)
    ref.apply(plan)
    for key, val in ref.state_tree().items():
        np.testing.assert_array_equal(g.state_tree()[key], val)
    with pytest.raises(ValueError):
        g.apply(plan, backend="cuda")
