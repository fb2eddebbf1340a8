"""The sharded graph in local mode in the port (``repro_torch.core.distributed``,
``repro_torch.kernels.slot_walk.sharded``), on the CPU.

The local cases of ``tests/test_distributed.py`` run through both packages
on the same numpy inputs: the sharded walk (one and batched) bit for bit
against ``repro``'s local walk and the port's own single-image walk (the
walks are unweighted, so the visits are small integers, exact in f32 on
these graphs); routed applies, vertex growth and a grown row's rebuild
against the host oracle ``_host_apply``; ``gather_csr``; the checkpoint
round trip.  Across the packages: ``route_updates``' subplans,
``state_trees()`` and the CRC descriptors bit for bit, and step
directories written by one package restored by the other.  A ``mesh``
that is not a ``launch.mesh.Mesh`` raises ``TypeError``, and one whose
rank count is not the shard count ``ValueError`` (the mesh mode itself is
held by ``tests/test_torch_mesh.py``).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.core import csr as j_csr
from repro.core import distributed as j_dist
from repro.core import edgebatch as j_eb
from repro.core import updates as j_up
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import csr, distributed as dist, edgebatch, updates
from repro_torch.core.walk_image import WalkImage
from repro_torch.kernels.csr_build import ref as csr_ref
from repro_torch.kernels.slot_walk import sharded as sw_sharded
from repro_torch.launch.mesh import Mesh
from repro_torch.runtime import durable

STEPS = 4
CPU = {"device": "cpu"}


def _coo(seed, n, m):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, m), rng.integers(0, n, m), rng.random(m).astype(np.float32)


def _csrs(seed, n, m):
    """The same random graph as a CSR of the port and of ``repro``."""
    src, dst, w = _coo(seed, n, m)
    return csr.from_coo(src, dst, w, n=n, **CPU), j_csr.from_coo(src, dst, w, n=n)


def _single_walk(c, steps, visits0=None):
    """The port's single-device image walk of a (port or host) CSR."""
    o = np.asarray(c.offsets)
    img = WalkImage.from_csr_arrays(o, np.asarray(c.dst), np.asarray(c.wgt), c.n, **CPU)
    v0 = None if visits0 is None else torch.from_numpy(np.asarray(visits0, np.float32))
    return img.walk(steps, visits0=v0).numpy()


def _plan(mod, ins=None, dels=None):
    """A plan of ``mod`` (``updates`` of either package)."""
    eb = edgebatch if mod is updates else j_eb
    return mod.plan_update(eb.from_arrays(*ins) if ins is not None else None,
                           eb.from_arrays(*dels) if dels is not None else None)


def _oracle(base, plans, n):
    """The host oracle: ``base`` (a port CSR) with ``plans`` applied by
    ``_host_apply``, as a host CSR."""
    o = base.offsets.numpy()
    s, d, w = np.repeat(np.arange(base.n), np.diff(o)), base.dst.numpy(), base.wgt.numpy()
    for p in plans:
        s, d, w = dist._host_apply(s, d, w, p)
    return csr.from_coo(s, d, w, n=n, dedup=False, **CPU)


def _same_csr(a, b, *, wgt=True):
    np.testing.assert_array_equal(np.asarray(a.offsets), np.asarray(b.offsets))
    np.testing.assert_array_equal(np.asarray(a.dst)[: a.m], np.asarray(b.dst)[: b.m])
    if wgt:
        np.testing.assert_array_equal(np.asarray(a.wgt)[: a.m], np.asarray(b.wgt)[: b.m])


def _same_trees(ta, tb):
    assert sorted(ta) == sorted(tb)
    for s in ta:
        assert ta[s].keys() == tb[s].keys()
        for k in ta[s]:
            x, y = np.asarray(ta[s][k]), np.asarray(tb[s][k])
            assert x.dtype == y.dtype and x.shape == y.shape, (s, k)
            np.testing.assert_array_equal(x, y, err_msg=f"shard {s}: {k}")


# ---------------------------------------------------------------------------
# local-mode parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_walk_parity_local(n_shards):
    c, jc = _csrs(0, 23, 140)
    g = dist.shard_csr(c, n_shards, **CPU)
    got = g.reverse_walk(STEPS)
    assert got.dtype == torch.float32 and got.shape == (c.n,)
    np.testing.assert_array_equal(got.numpy(), _single_walk(c, STEPS))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_dist.shard_csr(jc, n_shards).reverse_walk(STEPS)))


def test_multi_walk_parity_local():
    c, jc = _csrs(1, 19, 90)
    v0 = np.random.default_rng(1).integers(0, 3, (3, c.n)).astype(np.float32)
    got = dist.shard_csr(c, 4, **CPU).reverse_walk(STEPS, visits0=torch.from_numpy(v0))
    assert got.shape == (3, c.n)
    np.testing.assert_array_equal(got.numpy(), _single_walk(c, STEPS, visits0=v0))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_dist.shard_csr(jc, 4).reverse_walk(STEPS, visits0=v0)))
    # numpy rows are taken as they are; a row of the wrong width is refused
    np.testing.assert_array_equal(dist.reverse_walk(dist.shard_csr(c, 4, **CPU), STEPS,
                                                    visits0=v0).numpy(), got.numpy())
    with pytest.raises(ValueError, match="visits0"):
        dist.shard_csr(c, 4, **CPU).reverse_walk(STEPS, visits0=v0[:, :-1])


def test_local_walk_is_cached_per_shape():
    c, _ = _csrs(0, 23, 140)
    g = dist.shard_csr(c, 4, **CPU)
    sw_sharded.make_local_walk.cache_clear()
    g.reverse_walk(2)
    g.reverse_walk(2)
    assert sw_sharded.make_local_walk.cache_info().hits >= 1
    assert g.collective_bytes_per_step(2) == 0


def test_apply_routes_and_matches_single_device():
    c, jc = _csrs(2, 29, 160)
    src, dst, _ = _coo(2, 29, 160)
    rng = np.random.default_rng(2)
    ins = (rng.integers(0, 29, 40), rng.integers(0, 29, 40), rng.random(40).astype(np.float32))
    dels = (src[:25].copy(), dst[:25].copy())
    plan, jplan = _plan(updates, ins, dels), _plan(j_up, ins, dels)
    g = dist.shard_csr(c, 4, **CPU)
    base = dist.gather_csr(g)
    routed = dist.route_updates(plan, g.n_shards, g.rows_max)
    assert sum(p.n_ops for _, p in routed) == plan.n_ops
    for sid, sub in routed:
        lo, hi = sid * g.rows_max, (sid + 1) * g.rows_max
        assert int(sub.q_src.min()) >= lo and int(sub.q_src.max()) < hi
    # the subplans are repro's, array for array
    jrouted = j_dist.route_updates(jplan, g.n_shards, g.rows_max)
    assert [s for s, _ in routed] == [s for s, _ in jrouted]
    for (_, a), (_, b) in zip(routed, jrouted):
        for f in ("q_src", "q_dst", "q_wgt", "q_del", "rows", "run_first", "run_count",
                  "ins_count"):
            x, y = getattr(a, f), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert g.apply(plan) is None  # mutates in place
    want = _oracle(base, [plan], base.n)
    got = dist.gather_csr(g)
    _same_csr(got, want)
    np.testing.assert_array_equal(g.reverse_walk(STEPS).numpy(), _single_walk(want, STEPS))
    # the same plan through repro's sharded graph: the same state and walk
    jg = j_dist.shard_csr(jc, 4)
    jg.apply(jplan)
    _same_trees(g.state_trees(), jg.state_trees())
    np.testing.assert_array_equal(g.reverse_walk(STEPS).numpy(), np.asarray(jg.reverse_walk(STEPS)))


def test_vertex_growth_reshards_across_boundary():
    """New vertices land beyond the last shard's range: one re-shard."""
    c, _ = _csrs(3, 16, 80)
    g = dist.shard_csr(c, 4, **CPU)
    rows_max0, gen0 = g.rows_max, g.generation
    base = dist.gather_csr(g)
    n_new = 16 + 9  # forces rows_max to grow: old boundaries all move
    plan = _plan(updates, ins=(np.array([n_new - 1, 0, 7]), np.array([0, n_new - 1, n_new - 2]),
                               np.ones(3, np.float32)))
    g.apply(plan)
    assert g.n == n_new and g.rows_max > rows_max0 and g.generation == gen0 + 1
    want = _oracle(base, [plan], n_new)
    _same_csr(dist.gather_csr(g), want)
    np.testing.assert_array_equal(g.reverse_walk(STEPS).numpy(), _single_walk(want, STEPS))
    g.audit()


def test_grown_row_overflow_rebuilds():
    """A hub row outgrowing its shard's bump slack takes the rebuild path
    (relocation through gather + re-shard) and stays correct."""
    c, _ = _csrs(4, 12, 40)
    g = dist.shard_csr(c, 4, **CPU)
    cap0, gen0 = g.cap_e, g.generation
    base = dist.gather_csr(g)
    hub = np.arange(1, 12, dtype=np.int64)
    plans = []
    for rep in range(6):
        dsts = (hub + rep) % 12
        plans.append(_plan(updates, ins=(np.zeros_like(dsts) + (rep % 3), dsts,
                                         np.full(dsts.shape[0], 1.0, np.float32))))
        g.apply(plans[-1])
        g.audit()
    want = _oracle(base, plans, 12)
    _same_csr(dist.gather_csr(g), want)
    np.testing.assert_array_equal(g.reverse_walk(STEPS).numpy(), _single_walk(want, STEPS))
    assert g.cap_e >= cap0 and g.generation > gen0  # rebuilt, re-sized slot space


def test_gather_csr_matches_reference_oracle():
    src, dst, w = _coo(5, 17, 110)
    g = dist.shard_csr(csr.from_coo(src, dst, w, n=17, **CPU), 4, **CPU)
    got = dist.gather_csr(g)
    assert got.offsets.device.type == "cpu"
    ro, rd, rw = csr_ref.coo_to_csr_reference(src, dst, w, n=17, dedup=True)
    np.testing.assert_array_equal(got.offsets.numpy(), ro)
    np.testing.assert_array_equal(got.dst.numpy(), rd)
    np.testing.assert_array_equal(got.wgt.numpy(), rw)


def test_gather_csr_rejects_row_count_mismatch():
    c, _ = _csrs(6, 16, 60)
    g = dist.shard_csr(c, 4, **CPU)
    # corrupt shard 1's geometry: claim an edge on a row shard 0 owns
    img = g.shards[1]
    img.degs[0] = 1
    img.starts[0] = 0
    with pytest.raises(ValueError, match="row-count mismatch"):
        dist.gather_csr(g)


def test_sharded_checkpoint_roundtrip(tmp_path):
    c, _ = _csrs(7, 21, 120)
    g = dist.shard_csr(c, 4, **CPU)
    d = str(tmp_path / "ck")
    g.save(d, 3)
    # one file per shard under one step manifest
    step_dir = os.path.join(d, "step_0000000003")
    assert sorted(os.listdir(step_dir)) == ["manifest.json", "shard_0.npz", "shard_1.npz",
                                            "shard_2.npz", "shard_3.npz"]
    g2 = dist.ShardedGraph.restore(d, **CPU)
    assert (g2.n, g2.n_shards, g2.rows_max, g2.dense) == (g.n, g.n_shards, g.rows_max, g.dense)
    _same_trees(g2.state_trees(), g.state_trees())
    np.testing.assert_array_equal(g2.reverse_walk(STEPS).numpy(), g.reverse_walk(STEPS).numpy())
    # the single-shard restore API addresses one shard of the manifest
    arrays, step = ckpt.restore_arrays(d, shard_id=2)
    assert step == 3 and "dst" in arrays
    with pytest.raises(FileNotFoundError):
        ckpt.restore_arrays(d, shard_id=9)


@pytest.mark.parametrize("writer,reader", [("repro", "port"), ("port", "repro")])
def test_step_directories_across_packages(writer, reader, tmp_path):
    """A sharded step written by one package restores in the other, and
    both packages write the same manifest."""
    c, jc = _csrs(8, 21, 120)
    graphs = {"port": dist.shard_csr(c, 4, **CPU), "repro": j_dist.shard_csr(jc, 4)}
    for pkg, g in graphs.items():
        g.save(str(tmp_path / pkg), 5)
    raw = {pkg: (tmp_path / pkg / "step_0000000005" / "manifest.json").read_bytes()
           for pkg in graphs}
    assert json.loads(raw["port"]) == json.loads(raw["repro"])
    assert raw["port"] == raw["repro"]
    d = str(tmp_path / writer)
    if reader == "port":
        got = dist.ShardedGraph.restore(d, **CPU)
    else:
        got = j_dist.ShardedGraph.restore(d)
    _same_trees(got.state_trees(), graphs[writer].state_trees())
    np.testing.assert_array_equal(np.asarray(got.reverse_walk(STEPS)),
                                  np.asarray(graphs[writer].reverse_walk(STEPS)))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_state_and_descriptors_match_repro(n_shards):
    """``state_trees()`` and every shard's CRC descriptor are ``repro``'s,
    bit for bit, as built and after two routed plans."""
    c, jc = _csrs(9, 37, 260)
    g, jg = dist.shard_csr(c, n_shards, **CPU), j_dist.shard_csr(jc, n_shards)
    for k in range(3):
        _same_trees(g.state_trees(), jg.state_trees())
        for s in range(n_shards):
            assert g.shard_descriptor(s) == jg.shard_descriptor(s), (k, s)
        if k == 2:
            break
        rng = np.random.default_rng(20 + k)
        ins = (rng.integers(0, 37, 30), rng.integers(0, 37, 30), rng.random(30).astype(np.float32))
        dels = (rng.integers(0, 37, 12), rng.integers(0, 37, 12))
        g.apply(_plan(updates, ins, dels))
        jg.apply(_plan(j_up, ins, dels))


def test_hypothesis_sweep_parity():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=12, deadline=None)
    @given(
        n=st.integers(min_value=4, max_value=40),
        m=st.integers(min_value=0, max_value=160),
        n_shards=st.sampled_from([2, 3, 4]),
        steps=st.integers(min_value=1, max_value=4),
        seed=st.integers(min_value=0, max_value=2**31 - 1),
        n_ins=st.integers(min_value=0, max_value=30),
        n_del=st.integers(min_value=0, max_value=30),
    )
    def sweep(n, m, n_shards, steps, seed, n_ins, n_del):
        if n < n_shards:
            return
        rng = np.random.default_rng(seed)
        src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
        w = rng.random(m).astype(np.float32)
        c = csr.from_coo(src, dst, w, n=n, **CPU)
        g = dist.shard_csr(c, n_shards, **CPU)
        base = dist.gather_csr(g)
        np.testing.assert_array_equal(g.reverse_walk(steps).numpy(), _single_walk(c, steps))
        ins = (rng.integers(0, n, n_ins), rng.integers(0, n, n_ins),
               rng.random(n_ins).astype(np.float32)) if n_ins else None
        dels = (rng.integers(0, n, n_del), rng.integers(0, n, n_del)) if n_del else None
        if ins is None and dels is None:
            return
        plan = _plan(updates, ins, dels)
        g.apply(plan)
        want = _oracle(base, [plan], n)
        _same_csr(dist.gather_csr(g), want, wgt=False)
        np.testing.assert_array_equal(g.reverse_walk(steps).numpy(), _single_walk(want, steps))

    sweep()


# ---------------------------------------------------------------------------
# what a mesh must be; the default device is the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("entry", ["shard_csr", "ShardedGraph", "from_state_trees", "restore",
                                   "recover"])
def test_mesh_other_than_none_raises(entry, tmp_path):
    """Each entry point refuses a ``mesh`` that is not a ``Mesh`` (TypeError)
    and a ``Mesh`` whose rank count is not the shard count (ValueError,
    before any collective)."""
    c, _ = _csrs(10, 16, 60)
    g = dist.shard_csr(c, 2, **CPU)
    g.save(str(tmp_path / "ck"), 1)
    durable.DurableGraph(g, str(tmp_path / "w"), str(tmp_path / "c")).close()
    three = Mesh(group=None, rank=0, size=3, device=torch.device("cpu"), backend="gloo")
    calls = {
        "shard_csr": lambda mesh: dist.shard_csr(c, 2, mesh=mesh, **CPU),
        "ShardedGraph": lambda mesh: dist.ShardedGraph(shards=g.shards, n=g.n,
                                                       rows_max=g.rows_max, n_shards=2,
                                                       mesh=mesh),
        "from_state_trees": lambda mesh: dist.ShardedGraph.from_state_trees(
            g.state_trees(), mesh=mesh, **CPU),
        "restore": lambda mesh: dist.ShardedGraph.restore(str(tmp_path / "ck"), mesh=mesh,
                                                          **CPU),
        "recover": lambda mesh: durable.DurableGraph.recover(
            str(tmp_path / "w"), str(tmp_path / "c"), mesh=mesh, **CPU),
    }
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        calls[entry](object())
    with pytest.raises(ValueError, match="mesh device count != n_shards"):
        calls[entry](three)


def test_shards_live_on_the_requested_device():
    c, _ = _csrs(11, 16, 60)
    g = dist.shard_csr(c, 4, **CPU)
    assert g.device == torch.device("cpu")
    assert all(img.dst.device.type == "cpu" for img in g.shards)
    assert len({img.cap_e for img in g.shards}) == 1  # one shared capacity
    with pytest.raises(ValueError, match="n_shards"):
        dist.shard_csr(c, 0, **CPU)
