"""The walk image's maintenance contract (``tests/test_walk_image.py``)
through both packages on the same plans: after every plan the port's image
geometry (starts, caps, degs, bump, live), ``dst`` over [0, bump) and
``wgt``/``rows`` on live slots equal ``repro``'s bit for bit, the walks
agree at rtol 1e-4, and the patch / rebuild counters move alike.
"""
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import walk_image as j_wi
from repro.io import synthetic as j_syn
import repro_torch.core as T
from repro_torch.core import csr, traversal, walk_image
from repro_torch.runtime import faultinject

STEPS = 4
NAMES = ["coo", "lazy", "chunked", "vector2d"]
WALK_RTOL = 1e-4


def _twins(name, n=200, m=1600, seed=7):
    rng = np.random.default_rng(seed)
    src, dst = j_syn.uniform_edges(rng, n, m)
    jc, tc = J.from_coo(src, dst, n=n), csr.from_coo(src, dst, n=n, device="cpu")
    return (J.REPRESENTATIONS[name].from_csr(jc),
            T.REPRESENTATIONS[name].from_csr(tc, device="cpu"), tc)


def _plans(seed, c, n_ins, n_del):
    """The same mixed plan for both packages (``c``: the port's CSR)."""
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    n = c.n
    tp = T.plan_update(inserts=T.edgebatch.random_insertions(ra, n, n_ins),
                       deletes=T.edgebatch.random_deletions(ra, c, n_del) if n_del else None)
    jp = J.plan_update(inserts=J.edgebatch.random_insertions(rb, n, n_ins),
                       deletes=J.edgebatch.random_deletions(rb, c, n_del) if n_del else None)
    return jp, tp


def _hub_plans(u, k, n):
    s, d = np.full(k, u, np.int64), np.arange(k, dtype=np.int64) % n
    return (J.plan_update(inserts=J.edgebatch.from_arrays(s, d)),
            T.plan_update(inserts=T.edgebatch.from_arrays(s, d)))


def _same_image(ji, ti, what):
    assert (ti.nv, ti.bump, ti.live, ti.cap_e) == (ji.nv, ji.bump, ji.live, ji.cap_e), what
    nv = ti.nv
    for f in ("starts", "caps", "degs"):
        np.testing.assert_array_equal(getattr(ti, f)[:nv], np.asarray(getattr(ji, f))[:nv],
                                      err_msg=f"{what}: {f}")
    np.testing.assert_array_equal(ti.dst.numpy()[: ti.bump], np.asarray(ji.dst)[: ji.bump],
                                  err_msg=f"{what}: dst")
    degs, starts = ti.degs[:nv], ti.starts[:nv]
    live = np.repeat(starts, degs) + (np.arange(int(degs.sum()))
                                      - np.repeat(np.cumsum(degs) - degs, degs))
    for f in ("wgt", "rows"):
        np.testing.assert_array_equal(getattr(ti, f).numpy()[live],
                                      np.asarray(getattr(ji, f))[live], err_msg=f"{what}: {f}")


def _walks(jg, tg, steps=STEPS):
    got = tg.reverse_walk(steps).numpy()
    np.testing.assert_allclose(got, np.asarray(jg.reverse_walk(steps)), rtol=WALK_RTOL)
    cc = tg.to_csr()
    np.testing.assert_allclose(
        got[: cc.n], traversal.reverse_walk_dense_oracle(cc.to_dense(), steps), rtol=WALK_RTOL)
    return got


def _counted(fn):
    """(result, port STATS delta, repro STATS delta) of ``fn()``."""
    t0, j0 = walk_image.stats_snapshot(), j_wi.stats_snapshot()
    out = fn()
    t1, j1 = walk_image.stats_snapshot(), j_wi.stats_snapshot()
    return out, {k: t1[k] - t0[k] for k in t0}, {k: j1[k] - j0[k] for k in j0}


# ---------------------------------------------------------------------------
# back-to-back walks and in-place patches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_back_to_back_walks_do_no_host_image_work(name):
    jg, tg, _ = _twins(name)
    _walks(jg, tg)  # builds and caches the images
    img = tg.to_walk_image()
    _, dt, dj = _counted(lambda: _walks(jg, tg))
    assert tg.to_walk_image() is img
    assert dt["builds"] == dj["builds"] == 0 and dt["patches"] == dj["patches"] == 0
    _same_image(jg.to_walk_image(), img, name)


@pytest.mark.parametrize("name", NAMES)
def test_update_patches_cached_image_in_place(name):
    """A mixed plan, then a walk: one patch of the cached image (no build),
    which equals repro's patched image; a second plan, flushed eagerly,
    patches again."""
    jg, tg, c = _twins(name)
    _walks(jg, tg)
    img = tg.to_walk_image()
    jp, tp = _plans(5, c, 60, 60)
    jg, _ = jg.apply(jp)
    tg, _ = tg.apply(tp)
    _, dt, dj = _counted(lambda: _walks(jg, tg))
    assert tg.to_walk_image() is img, name
    assert dt == dj and dt["patches"] == 1 and dt["builds"] == 0, (dt, dj)
    _same_image(jg.to_walk_image(), img, name)
    jp, tp = _plans(6, tg.to_csr(), 40, 40)
    jg, _ = jg.apply(jp)
    tg, _ = tg.apply(tp)
    _, dt, dj = _counted(lambda: (jg.to_walk_image(), tg.to_walk_image()))
    assert dt == dj and dt["patches"] == 1 and dt["builds"] == 0, (dt, dj)
    _same_image(jg.to_walk_image(), img, f"{name}: flushed")
    assert img.audit()["bump"] == img.bump


@pytest.mark.parametrize("name", NAMES)
def test_walk_flush_equals_flush_then_walk(name):
    """The fused flush→walk and the eager flush followed by a walk give the
    same image and the same visits, bit for bit."""
    jg, ta, c = _twins(name)
    tb = T.REPRESENTATIONS[name].from_csr(c, device="cpu")
    ta.reverse_walk(STEPS)
    tb.reverse_walk(STEPS)
    _, tp = _plans(9, c, 50, 50)
    ta, _ = ta.apply(tp)
    tb, _ = tb.apply(tp)
    va, dt, _ = _counted(lambda: ta._image.walk_flush(STEPS))
    assert dt["dispatches"] == 1 and dt["patches"] == 1
    assert tb._image.flush()
    vb = tb._image.walk(STEPS)
    assert torch.equal(va, vb)
    ia, ib = ta._image, tb._image
    for f in ("dst", "wgt", "rows"):
        assert torch.equal(getattr(ia, f), getattr(ib, f)), f
    for f in ("starts", "caps", "degs"):
        np.testing.assert_array_equal(getattr(ia, f), getattr(ib, f))
    for x, y in zip(ia.device_blocks(), ib.device_blocks()):
        assert torch.equal(x, y)
    v0 = torch.from_numpy(np.random.default_rng(1).random((2, ia.nv), dtype=np.float32))
    _, tp = _plans(10, ta.to_csr(), 20, 20)
    ta, _ = ta.apply(tp)
    tb, _ = tb.apply(tp)
    va = ta.reverse_walk(STEPS, visits0=v0, normalize=True)
    vb = tb.to_walk_image().walk(STEPS, visits0=v0, normalize=True)
    assert va.shape == (2, ia.nv) and torch.equal(va, vb)


# ---------------------------------------------------------------------------
# patch-vs-rebuild decisions, each against repro's
# ---------------------------------------------------------------------------
def test_row_outgrows_slack_falls_back_to_rebuild():
    jg, tg, c = _twins("coo", n=64, m=256)
    _walks(jg, tg)
    img = tg.to_walk_image()
    # densify to the complete graph: every row outgrows its slack and the
    # summed relocation demand exceeds the bump headroom
    uu, vv = np.meshgrid(np.arange(64), np.arange(64))
    jg, _ = jg.apply(J.plan_update(inserts=J.edgebatch.from_arrays(uu.ravel(), vv.ravel())))
    tg, _ = tg.apply(T.plan_update(inserts=T.edgebatch.from_arrays(uu.ravel(), vv.ravel())))
    _, dt, dj = _counted(lambda: _walks(jg, tg))
    assert dt == dj and dt["rebuilds"] == 1 and dt["builds"] == 1, (dt, dj)
    assert tg.to_walk_image() is not img
    _same_image(jg.to_walk_image(), tg.to_walk_image(), "rebuilt")


def test_small_growth_patches_without_rebuild():
    jg, tg, c = _twins("lazy")
    _walks(jg, tg)
    img = tg.to_walk_image()
    # grow one row past its CP2AA class but well inside the bump headroom:
    # the block relocates, nothing rebuilds
    deg = np.diff(c.offsets.numpy())
    u = int(np.argmax(deg))
    jp, tp = _hub_plans(u, 2 * int(deg[u]) + 4, c.n)
    jg, _ = jg.apply(jp)
    tg, _ = tg.apply(tp)
    _, dt, dj = _counted(lambda: _walks(jg, tg))
    assert dt == dj and dt["rebuilds"] == 0 and dt["patches"] == 1, (dt, dj)
    assert tg.to_walk_image() is img
    assert img.starts[u] >= img.bump - img.caps[u]  # relocated to the bump frontier
    _same_image(jg.to_walk_image(), img, "relocated")


def test_vertex_growth_rebuilds_image():
    jg, tg, _ = _twins("chunked", n=50, m=300)
    _walks(jg, tg)
    s, d = np.array([3, 70]), np.array([70, 3])
    jg, _ = jg.apply(J.plan_update(inserts=J.edgebatch.from_arrays(s, d)))
    tg, _ = tg.apply(T.plan_update(inserts=T.edgebatch.from_arrays(s, d)))
    _, dt, dj = _counted(lambda: _walks(jg, tg))
    assert dt == dj and dt["rebuilds"] == 1, (dt, dj)
    assert tg.to_walk_image().nv >= 71
    _same_image(jg.to_walk_image(), tg.to_walk_image(), "grown")


def test_queue_overflow_rebuilds_instead_of_replaying():
    jg, tg, _ = _twins("vector2d", n=64, m=256)
    _walks(jg, tg)
    ra, rb = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(walk_image.MAX_PENDING + 1):
        jg, _ = jg.apply(J.plan_update(inserts=J.edgebatch.random_insertions(ra, 64, 2)))
        tg, _ = tg.apply(T.plan_update(inserts=T.edgebatch.random_insertions(rb, 64, 2)))
    assert tg._image._stale and not tg._image._pending
    _, dt, dj = _counted(lambda: _walks(jg, tg))
    assert dt == dj and dt["rebuilds"] == 1 and dt["patches"] == 0, (dt, dj)
    _same_image(jg.to_walk_image(), tg.to_walk_image(), "rebuilt")


def test_compaction_rebuilds_once_dead_slots_dominate():
    """Deleting most edges drops the image's occupancy under half of its
    build-time occupancy: the flush patches, then asks for a dense rebuild."""
    jg, tg, c = _twins("coo")
    _walks(jg, tg)
    jp, tp = _plans(3, c, 0, 1200)
    jg, _ = jg.apply(jp)
    tg, _ = tg.apply(tp)
    _, dt, dj = _counted(lambda: (jg.to_walk_image(), tg.to_walk_image()))
    assert dt == dj and dt["patches"] == 1 and dt["rebuilds"] == 1 and dt["builds"] == 1
    img = tg.to_walk_image()
    assert img.occupancy == img.base_occupancy  # repacked as built
    _same_image(jg.to_walk_image(), img, "compacted")
    _walks(jg, tg)


def test_chunked_dense_image_strips_page_slack():
    """ChunkedGraph's image drops PAGE tails (occupancy ~1) and keeps
    patching under a stream: grown rows move into the deep bump reserve."""
    jg, tg, _ = _twins("chunked", n=150, m=1200)
    img = tg.to_walk_image()
    assert img.occupancy > 0.95 and img.base_occupancy > 0.95
    _same_image(jg.to_walk_image(), img, "dense")
    for seed in range(3):
        jp, tp = _plans(seed, tg.to_csr(), 30, 30)
        jg, _ = jg.apply(jp)
        tg, _ = tg.apply(tp)
        _, dt, dj = _counted(lambda: _walks(jg, tg))
        assert dt == dj and dt["patches"] == 1 and dt["builds"] == 0, (dt, dj)
    _same_image(jg.to_walk_image(), tg.to_walk_image(), "patched")


def test_snapshot_gets_private_image():
    for name in NAMES:
        jg, tg, c = _twins(name)
        tg.reverse_walk(STEPS)
        s = tg.snapshot()
        ra = np.random.default_rng(4)
        tg, _ = tg.apply(T.plan_update(inserts=T.edgebatch.random_insertions(ra, c.n, 40)))
        # the snapshot keeps walking the PRE-update graph
        np.testing.assert_allclose(s.reverse_walk(STEPS).numpy(), np.asarray(
            jg.reverse_walk(STEPS)), rtol=WALK_RTOL, err_msg=name)
        cc = tg.to_csr()
        np.testing.assert_allclose(tg.reverse_walk(STEPS).numpy()[: cc.n],
                                   traversal.reverse_walk_dense_oracle(cc.to_dense(), STEPS),
                                   rtol=WALK_RTOL, err_msg=name)


# ---------------------------------------------------------------------------
# sealed generations, audit, block ranges
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["digraph"] + NAMES)
def test_seal_isolation_under_in_place_patches(name):
    """A sealed generation keeps its buffers and its walk while the live
    image patches in place; it refuses plans."""
    jg, tg, c = _twins(name)
    tg.reverse_walk(STEPS)
    gen = walk_image.seal_generation(tg, 3)
    assert gen.generation == 3 and gen._frozen
    bufs = [t.clone() for t in (gen.dst, gen.wgt, gen.rows)]
    v_gen = gen.walk(STEPS)
    _, tp = _plans(8, c, 60, 60)
    tg, _ = tg.apply(tp)
    tg.reverse_walk(STEPS)
    tg, _ = tg.apply(_plans(9, tg.to_csr(), 30, 30)[1])
    tg.reverse_walk(STEPS)
    for a, b in zip((gen.dst, gen.wgt, gen.rows), bufs):
        assert torch.equal(a, b), name
    assert torch.equal(gen.walk(STEPS), v_gen)
    np.testing.assert_allclose(v_gen.numpy(), np.asarray(jg.reverse_walk(STEPS)),
                               rtol=WALK_RTOL)
    with pytest.raises(RuntimeError, match="read-only"):
        gen.queue(tp)
    if name != "digraph":
        live = tg.to_walk_image()
        assert live.dst.data_ptr() != gen.dst.data_ptr()  # the patch copied first
        assert not live._cow
        tg, _ = tg.apply(_plans(11, tg.to_csr(), 5, 5)[1])
        with pytest.raises(ValueError, match="unflushed"):
            tg._image.seal()


def test_audit_raises_on_a_corrupted_slack_slot():
    jg, tg, c = _twins("coo")
    img = tg.to_walk_image()
    info = img.audit()
    assert info == jg.to_walk_image().audit()
    slack = np.nonzero(img.caps[: img.nv] > img.degs[: img.nv])[0][0]
    img.dst[int(img.starts[slack] + img.degs[slack])] = 0  # a ghost edge
    with pytest.raises(faultinject.AuditError, match="slack"):
        img.audit()


def test_block_ranges_match_repro():
    jg, tg, c = _twins("lazy")
    rows = np.array([0, 5, 17, 199, 3])
    np.testing.assert_array_equal(tg.to_walk_image().block_ranges(rows),
                                  jg.to_walk_image().block_ranges(rows))
    deg = np.diff(c.offsets.numpy())
    jp, tp = _hub_plans(5, 2 * int(deg[5]) + 9, c.n)
    jg, _ = jg.apply(jp)
    tg, _ = tg.apply(tp)
    ti, ji = tg.to_walk_image(), jg.to_walk_image()
    np.testing.assert_array_equal(ti.block_ranges(rows), ji.block_ranges(rows))
    (lo, hi), = ti.block_ranges(np.array([5]))
    assert hi == ti.starts[5] + ti.caps[5] and lo >= ti.bump - ti.caps[5]  # moved to the frontier
