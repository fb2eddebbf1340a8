"""The four other representations (SortedCOO, LazyCSR, ChunkedGraph,
Vector2D) through both packages on the same numpy inputs: every case of
``tests/test_core_reps.py`` and ``examples/quickstart.py``, with
``to_csr()`` and ``state_tree()`` bit for bit against ``repro`` and the
walks at rtol 1e-4; plus the ``bitset`` words.
"""
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import bitset as j_bitset
from repro.io import synthetic as j_syn
import repro_torch.core as T
from repro_torch.core import bitset, csr, traversal

NAMES = ["coo", "lazy", "chunked", "vector2d"]
WALK_RTOL = 1e-4
#: hub-heavy graphs after 8 steps: the uncompensated intra-tile prefix of
#: the interval walk (both packages) keeps ~ulp of a hub tile's running sum
HUB_WALK_RTOL = 2e-3


def _graphs(n, m, seed, weighted=False):
    """The same random graph as a ``repro`` CSR and a port CSR (on the CPU)."""
    rng = np.random.default_rng(seed)
    src, dst = j_syn.uniform_edges(rng, n, m)
    w = rng.uniform(0.5, 1.5, m).astype(np.float32) if weighted else None
    return (J.from_coo(src, dst, w, n=n), csr.from_coo(src, dst, w, n=n, device="cpu"),
            rng)


def _twins(name, n, m, seed, weighted=False):
    jc, tc, rng = _graphs(n, m, seed, weighted)
    return J.REPRESENTATIONS[name].from_csr(jc), T.REPRESENTATIONS[name].from_csr(
        tc, device="cpu"), rng


def _same_csr(jc, tc, what):
    assert jc.n == tc.n and jc.m == tc.m, what
    for f in ("offsets", "dst", "wgt"):
        a = np.asarray(getattr(jc, f))
        b = getattr(tc, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}: {f}"
        np.testing.assert_array_equal(b, a, err_msg=f"{what}: {f}")


def _same_state(jg, tg, what):
    a, b = jg.state_tree(), tg.state_tree()
    assert a.keys() == b.keys(), what
    for key in a:
        x, y = np.asarray(a[key]), b[key]
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what}: {key}"
        np.testing.assert_array_equal(y, x, err_msg=f"{what}: {key}")


def _same_walk(jg, tg, steps=5):
    got = tg.reverse_walk(steps).numpy()
    np.testing.assert_allclose(got, np.asarray(jg.reverse_walk(steps)), rtol=WALK_RTOL)
    cc = tg.to_csr()
    exp = traversal.reverse_walk_dense_oracle(cc.to_dense(), steps)
    np.testing.assert_allclose(got[: cc.n], exp, rtol=WALK_RTOL)


def _apply_both(jg, tg, jplan, tplan, what):
    jg, jdm = jg.apply(jplan)
    tg, tdm = tg.apply(tplan)
    assert jdm == tdm, what
    return jg, tg


def test_registry_mirrors_repro():
    assert list(T.REPRESENTATIONS) == list(J.REPRESENTATIONS)
    a = np.random.default_rng(1).uniform(0.5, 2.0, (9, 9)).astype(np.float32)
    a[a < 1.2] = 0
    _same_csr(J.from_dense(a), T.from_dense(a, device="cpu"), "from_dense")


@pytest.mark.parametrize("name", NAMES)
def test_from_csr_roundtrip(name):
    jg, tg, _ = _twins(name, 64, 400, 0, weighted=True)
    _same_csr(jg.to_csr(), tg.to_csr(), name)
    _same_state(jg, tg, name)
    assert tg.to_edge_sets()[:64] == jg.to_edge_sets()[:64]
    restored = T.REPRESENTATIONS[name].from_state_tree(
        {k: np.asarray(v) for k, v in jg.state_tree().items()}, device="cpu")
    _same_state(jg, restored, f"{name}: carried over")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [3, 7, 11])
def test_random_update_sequence_matches_repro(name, seed):
    """Random insert and delete batches (some on new vertices): both
    packages' CSR and state bit for bit after every batch, and a set
    oracle."""
    n = 40
    jg, tg, rng = _twins(name, n, 200, seed)
    oracle = [set(x) for x in tg.to_edge_sets()]
    for it in range(6):
        if rng.integers(0, 2) == 0:
            nv = n + int(rng.integers(0, 4))
            cnt = int(rng.integers(1, 30))
            s0 = rng.bit_generator.state
            b = T.edgebatch.random_insertions(rng, nv, cnt)
            rng.bit_generator.state = s0
            jb = J.edgebatch.random_insertions(rng, nv, cnt)
            jg, tg = _apply_both(jg, tg, J.plan_update(inserts=jb),
                                 T.plan_update(inserts=b), f"{name} it{it}")
            s, d, _ = b.to_numpy()
            while len(oracle) < int(max(s.max(), d.max())) + 1:
                oracle.append(set())
            for u, v in zip(s.tolist(), d.tolist()):
                oracle[u].add(v)
        else:
            cc = tg.to_csr()
            if cc.m == 0:
                continue
            cnt = int(rng.integers(1, min(30, cc.m + 1)))
            s0 = rng.bit_generator.state
            b = T.edgebatch.random_deletions(rng, cc, cnt)
            rng.bit_generator.state = s0
            jb = J.edgebatch.random_deletions(rng, jg.to_csr(), cnt)
            jg, tg = _apply_both(jg, tg, J.plan_update(deletes=jb),
                                 T.plan_update(deletes=b), f"{name} it{it}")
            s, d, _ = b.to_numpy()
            for u, v in zip(s.tolist(), d.tolist()):
                oracle[u].discard(v)
        _same_csr(jg.to_csr(), tg.to_csr(), f"{name} it{it}")
        _same_state(jg, tg, f"{name} it{it}")
        got = tg.to_edge_sets()
        got += [set()] * (len(oracle) - len(got))
        assert got == oracle + [set()] * (len(got) - len(oracle)), f"{name} it{it}"
    _same_walk(jg, tg)


@pytest.mark.parametrize("name", NAMES)
def test_new_instance_updates_leave_original(name):
    jg, tg, rng = _twins(name, 32, 150, 5, weighted=True)
    before, state = tg.to_csr(), tg.state_tree()
    b = T.edgebatch.random_insertions(rng, 32, 20, weighted_range=(2.0, 3.0))
    # an upsert of an existing edge too: the original keeps its weight
    s, d, _ = b.to_numpy()
    s, d = np.append(s, int(before.row_ids()[0])), np.append(d, int(before.dst[0]))
    b = T.edgebatch.from_arrays(s, d, np.full(s.shape[0], 7.0, np.float32))
    jb = J.edgebatch.from_arrays(s, d, np.full(s.shape[0], 7.0, np.float32))
    tg2, _ = tg.add_edges(b, inplace=False)
    jg2, _ = jg.add_edges(jb, inplace=False)
    after = tg.to_csr()
    for f in ("offsets", "dst", "wgt"):
        assert torch.equal(getattr(after, f), getattr(before, f)), f"{name}: original {f}"
    for k, v in tg.state_tree().items():
        np.testing.assert_array_equal(v, state[k], err_msg=f"{name}: original {k}")
    _same_csr(jg2.to_csr(), tg2.to_csr(), name)
    _same_state(jg2, tg2, name)


@pytest.mark.parametrize("name", NAMES)
def test_snapshot_isolation(name):
    jg, tg, rng = _twins(name, 32, 150, 9)
    snap = tg.snapshot()
    before = snap.to_csr()
    tg, _ = tg.add_edges(T.edgebatch.random_insertions(rng, 32, 25), inplace=True)
    tg, _ = tg.remove_edges(T.edgebatch.random_deletions(rng, tg.to_csr(), 10), inplace=True)
    after = snap.to_csr()
    for f in ("offsets", "dst", "wgt"):
        assert torch.equal(getattr(after, f), getattr(before, f)), f"{name}: snapshot {f}"
    _same_csr(jg.to_csr(), after, name)  # the snapshot is still the loaded graph
    np.testing.assert_allclose(snap.reverse_walk(4).numpy(), np.asarray(jg.reverse_walk(4)),
                               rtol=WALK_RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_clone_independence(name):
    jg, tg, rng = _twins(name, 32, 150, 13)
    cl = tg.clone()
    _same_state(jg, cl, name)
    tg, _ = tg.add_edges(T.edgebatch.random_insertions(rng, 32, 25), inplace=True)
    assert cl.to_csr().m != tg.to_csr().m or cl.to_edge_sets() != tg.to_edge_sets()
    _same_state(jg, cl, f"{name}: clone after the update")


def test_weight_upsert_semantics():
    """Re-inserting an existing edge updates its weight (documented policy)."""
    src, dst, w = [0, 0, 1], [1, 2, 2], [1.0, 2.0, 3.0]
    jc = J.from_coo(src, dst, w, n=3)
    tc = csr.from_coo(src, dst, w, n=3, device="cpu")
    for name in NAMES:
        jg = J.REPRESENTATIONS[name].from_csr(jc)
        tg = T.REPRESENTATIONS[name].from_csr(tc, device="cpu")
        jg, tg = _apply_both(
            jg, tg, J.plan_update(inserts=J.edgebatch.from_arrays([0], [1], [9.0])),
            T.plan_update(inserts=T.edgebatch.from_arrays([0], [1], [9.0])), name)
        cc = tg.to_csr()
        row = dict(zip(cc.dst[:2].tolist(), cc.wgt[:2].tolist()))
        assert row[1] == pytest.approx(9.0), f"{name}: weight not upserted"
        assert cc.m == 3, f"{name}: duplicate edge created"
        _same_csr(jg.to_csr(), cc, name)


@pytest.mark.parametrize("name", NAMES)
def test_quickstart_tasks_match_repro(name):
    """``examples/quickstart.py`` per representation: load, snapshot and
    clone, insert then delete in place, walk 8 steps on the updated graph."""
    jc = j_syn.make_graph("web", scale=8, edge_factor=8, seed=0)
    tc = T.from_coo(np.repeat(np.arange(jc.n), np.diff(np.asarray(jc.offsets))),
                    np.asarray(jc.dst), None if jc.wgt is None else np.asarray(jc.wgt),
                    n=jc.n, device="cpu")
    _same_csr(jc, tc, "graph")
    ra, rb = np.random.default_rng(0), np.random.default_rng(0)
    jins, jdel = J.edgebatch.random_insertions(ra, jc.n, 200), J.edgebatch.random_deletions(
        ra, jc, 200)
    tins, tdel = T.edgebatch.random_insertions(rb, tc.n, 200), T.edgebatch.random_deletions(
        rb, tc, 200)
    jg, tg = J.REPRESENTATIONS[name].from_csr(jc), T.REPRESENTATIONS[name].from_csr(
        tc, device="cpu")
    snap, deep = tg.snapshot(), tg.clone()
    jg, dm_in = jg.add_edges(jins, inplace=True)
    tg, tdm_in = tg.add_edges(tins, inplace=True)
    jg, dm_out = jg.remove_edges(jdel, inplace=True)
    tg, tdm_out = tg.remove_edges(tdel, inplace=True)
    assert (tdm_in, tdm_out) == (dm_in, dm_out)
    _same_csr(jg.to_csr(), tg.to_csr(), name)
    np.testing.assert_allclose(tg.reverse_walk(4).numpy(), np.asarray(jg.reverse_walk(4)),
                               rtol=WALK_RTOL)
    # at 8 steps the web graph's hub rows reach the envelope of the walk's
    # uncompensated intra-tile prefix in BOTH packages (up to 1.1e-3 here
    # for the port, 6.4e-4 for repro, against the float64 oracle)
    got = tg.reverse_walk(8).numpy()
    exp = traversal.reverse_walk_dense_oracle(tg.to_csr().to_dense(), 8)
    np.testing.assert_allclose(got, exp, rtol=HUB_WALK_RTOL)
    np.testing.assert_allclose(got, np.asarray(jg.reverse_walk(8)), rtol=HUB_WALK_RTOL)
    assert snap.to_csr().m == tc.m and deep.to_csr().m == tc.m, "snapshot must be isolated"


def test_bitset_words_match_repro():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    idx = rng.integers(0, 200, 90)
    tb, jb = bitset.make(200, device="cpu"), j_bitset.make(200)
    assert bitset.capacity(tb) == j_bitset.capacity(jb)
    tb, jb = bitset.set_many(tb, idx), j_bitset.set_many(jb, jnp.asarray(idx))
    np.testing.assert_array_equal(tb.numpy().view(np.uint32), np.asarray(jb))
    for i in (31, 63, 5, 199):  # bit 31 is the int32 word's sign bit
        for value in (True, False, True):
            tb = bitset.set_(tb, [i], value)
            jb = j_bitset.set_(jb, jnp.asarray([i]), value)
            np.testing.assert_array_equal(tb.numpy().view(np.uint32), np.asarray(jb))
    probe = np.arange(-3, 260)
    np.testing.assert_array_equal(bitset.get(tb, probe).numpy(),
                                  np.asarray(j_bitset.get(jb, jnp.asarray(probe))))
    assert bitset.count(tb) == int(j_bitset.count(jb))
    tg, jgr = bitset.grow(tb, 1000), j_bitset.grow(jb, 1000)
    np.testing.assert_array_equal(tg.numpy().view(np.uint32), np.asarray(jgr))


def _util_case(name, rng):
    """(repro result, port result) of one ``core.util`` helper on the same
    numpy inputs."""
    import jax.numpy as jnp
    from repro.core import util as ju
    from repro_torch.core import util as tu

    sent = np.iinfo(np.int32).max
    rows = np.sort(rng.integers(0, 50, (6, 12)).astype(np.int32), axis=1)
    rows[:, 9:] = sent
    queries = rng.integers(0, 55, (6, 5)).astype(np.int32)
    s = rng.integers(0, 9, 40).astype(np.int32)
    d = rng.integers(-3, 9, 40).astype(np.int32)  # negative secondaries too
    w = rng.random(40, dtype=np.float32)
    ss, ds = ju.coo_sort(jnp.asarray(np.abs(s)), jnp.asarray(np.abs(d)))
    ss, ds = np.asarray(ss), np.asarray(ds)
    j = lambda *a: [jnp.asarray(x) for x in a]  # noqa: E731
    t = lambda *a: [torch.from_numpy(np.array(x)) for x in a]  # noqa: E731
    cases = {
        "lexsort2": (lambda f, *a: f.lexsort2(*a), (s, d)),
        "dedup_sorted_rows": (lambda f, k, v: f.dedup_sorted_rows(k, v),
                              (np.sort(rng.integers(0, 6, (4, 10)).astype(np.int32), axis=1),
                               rng.random((4, 10), dtype=np.float32))),
        "searchsorted_rows": (lambda f, *a: f.searchsorted_rows(*a), (rows, queries)),
        "row_contains": (lambda f, *a: f.row_contains(*a), (rows, queries)),
        "segment_sum": (lambda f, v, i: f.segment_sum(v, i, 7),
                        (rng.random((30, 3), dtype=np.float32),
                         rng.integers(-2, 9, 30).astype(np.int32))),
        "coo_sort": (lambda f, *a: f.coo_sort(*a), (s, d, w)),
        "coo_dedup_mask": (lambda f, *a: f.coo_dedup_mask(*a), (ss, ds)),
        "binsearch_window": (lambda f, flat, lo, hi, q: f.binsearch_window(flat, lo, hi, q),
                             (np.concatenate([np.arange(0, 20, 2), np.arange(1, 30, 3)]
                                             ).astype(np.int32),
                              np.array([0, 0, 10, 10, 3, 20], np.int32),
                              np.array([10, 10, 20, 20, 3, 20], np.int32),
                              np.array([4, 5, 7, 28, 6, 1], np.int32))),
        "searchsorted_2d": (lambda f, *a: f.searchsorted_2d(*a),
                            (np.append(ss, sent), np.append(ds, sent),
                             np.array([0, 3, 8, 9, sent], np.int32),
                             np.array([2, 0, 8, 0, sent], np.int32))),
    }
    fn, args = cases[name]
    return fn(ju, *j(*args)), fn(tu, *t(*args))


@pytest.mark.parametrize("name", [
    "lexsort2", "dedup_sorted_rows", "searchsorted_rows", "row_contains", "segment_sum",
    "coo_sort", "coo_dedup_mask", "binsearch_window", "searchsorted_2d"])
def test_util_helpers_match_repro(name):
    exp, got = _util_case(name, np.random.default_rng(len(name)))
    exp = exp if isinstance(exp, tuple) else (exp,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(exp) == len(got)
    for e, g in zip(exp, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e).astype(g.numpy().dtype),
                                      err_msg=name)
