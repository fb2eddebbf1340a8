"""Shard failover in the port (DESIGN.md §17): quarantine, degraded walks,
integrity descriptors, online rebuild and reintegration, and serving a
``ShardedGraph`` (``repro_torch.core.distributed``,
``repro_torch.runtime.failover``, ``repro_torch.runtime.durable``,
``repro_torch.runtime.serve``), on the CPU.

The counterparts of ``tests/test_failover.py``'s cases on the port:

* representation level — a ``shard.patch`` fault quarantines exactly the
  faulted shard (the rest still patch, routed updates spool), degraded
  walks mask the lost rows to exact zeros, integrity descriptors catch the
  silent weight corruption the structural audit can't, and
  ``DurableGraph.rebuild_shard`` restores + replays the one lost shard back
  to bit parity with an uncrashed twin;
* serving level — ``WalkServer`` keeps serving through a shard loss with
  explicit per-response ``coverage`` / ``down_shards``, writer-paced
  audits detect corruption, ``run_on_writer`` serialises admin mutations.

Besides: the same fault and the same corruption in ``repro`` (the same
quarantine, spool and damaged slot), and the copy-on-write that keeps a
sealed generation's buffers when a shard is patched or damaged in place.
Every ticket wait has a timeout and every server stops in a ``finally``.
"""
import time

import numpy as np
import pytest
import torch

from repro.core import csr as j_csr
from repro.core import distributed as j_dist
from repro.core import edgebatch as j_eb
from repro.core import updates as j_up
from repro.runtime import failover as j_failover
from repro.runtime import faultinject as j_fi
from repro_torch.core import csr, distributed as dist, edgebatch, updates
from repro_torch.launch import serve as launch_serve
from repro_torch.runtime import durable, failover, faultinject
from repro_torch.runtime import serve as serve_mod

N_V = 48
S = 4
CPU = {"device": "cpu"}
WAIT_S = 30.0


@pytest.fixture(autouse=True)
def _port_faultinject_leak_guard():
    """Fail a test that leaks an armed point of the port's registry (the
    conftest guard watches ``repro``'s only)."""
    faultinject.disarm()
    yield
    leaked = faultinject.armed()
    if leaked:
        faultinject.disarm()
        pytest.fail(f"test leaked armed port faultinject points: {leaked}")


def _coo():
    rng = np.random.default_rng(5)
    m = 260
    return (rng.integers(0, N_V, m), rng.integers(0, N_V, m),
            rng.random(m).astype(np.float32))


@pytest.fixture(scope="module")
def base_csr():
    return csr.from_coo(*_coo(), n=N_V, **CPU)


def make_plan(seed=0, k=12, n=N_V, mod=updates):
    """A mixed plan of ``mod`` (``updates`` of either package)."""
    eb = edgebatch if mod is updates else j_eb
    rng = np.random.default_rng(seed)
    ib = eb.from_arrays(rng.integers(0, n, k), rng.integers(0, n, k),
                        rng.random(k).astype(np.float32))
    db = eb.from_arrays(rng.integers(0, n, 4), rng.integers(0, n, 4))
    return mod.plan_update(inserts=ib, deletes=db)


def masked_walk_oracle(g, steps, down_rows):
    """Numpy reverse walk with the §17 coverage mask: a down shard's rows
    accumulate nothing at every step while edges from healthy rows still
    read the full visit vector."""
    c = dist.gather_csr(g)
    off = c.offsets.numpy().astype(np.int64)
    rows = np.repeat(np.arange(N_V, dtype=np.int64), np.diff(off))
    d = c.dst.numpy()[: c.m].astype(np.int64)
    v = np.ones(N_V, np.float64)
    for _ in range(steps):
        nxt = np.zeros(N_V, np.float64)
        np.add.at(nxt, rows, v[d])
        if len(down_rows):
            nxt[down_rows] = 0.0
        v = nxt
    return v


def assert_parity(g, twin):
    ca, cb = dist.gather_csr(g), dist.gather_csr(twin)
    for f in ("offsets", "dst", "wgt"):
        x, y = getattr(ca, f).numpy(), getattr(cb, f).numpy()
        if f != "offsets":
            x, y = x[: ca.m], y[: cb.m]
        np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(g.reverse_walk(3).numpy(), twin.reverse_walk(3).numpy())


# ---------------------------------------------------------------------------
# representation level: quarantine / degraded walk / guards
# ---------------------------------------------------------------------------


def test_patch_fault_quarantines_only_faulted_shard(base_csr):
    g = dist.shard_csr(base_csr, S, **CPU)
    twin = dist.shard_csr(base_csr, S, **CPU)
    plan = make_plan(seed=1)
    routed = dist.route_updates(plan, S, g.rows_max)
    subs = dict(routed)
    assert len(routed) >= 2  # the plan must span shards for the test
    victim = routed[1][0]  # hits run in routed order
    faultinject.arm("shard.patch", after=1, times=1)
    g.apply(plan)  # non-raising: healthy shards still patch
    faultinject.disarm()
    assert g.down == {victim} and g.coverage < 1.0
    assert len(g.spooled(victim)) == 1
    for sid, sub in subs.items():
        if sid != victim:
            twin.shards[sid].queue(sub)
            assert twin.shards[sid].flush()
    for sid in range(S):
        if sid != victim:
            assert torch.equal(g.shards[sid].dst, twin.shards[sid].dst)
    g.apply(make_plan(seed=2))  # a second routed update for the victim spools too
    assert len(g.spooled(victim)) == 2
    assert all(s is not None for s in g.spooled(victim))


def test_patch_fault_matches_repro(base_csr):
    """The same fault in both packages: the same quarantine, the same
    spooled subplans, the same healthy shards."""
    jc = j_csr.from_coo(*_coo(), n=N_V)
    g, jg = dist.shard_csr(base_csr, S, **CPU), j_dist.shard_csr(jc, S)
    faultinject.arm("shard.patch", after=1, times=1)
    j_fi.arm("shard.patch", after=1, times=1)
    try:
        g.apply(make_plan(seed=1))
        jg.apply(make_plan(seed=1, mod=j_up))
    finally:
        faultinject.disarm()
        j_fi.disarm()
    assert g.down == jg.down and g.coverage == jg.coverage
    (victim,) = g.down
    for a, b in zip(g.spooled(victim), jg.spooled(victim)):
        for f in ("q_src", "q_dst", "q_wgt", "q_del"):
            np.testing.assert_array_equal(getattr(a, f), np.asarray(getattr(b, f)))
    np.testing.assert_array_equal(g.down_rows(), jg.down_rows())
    for sid in range(S):
        if sid != victim:
            assert g.shard_descriptor(sid) == jg.shard_descriptor(sid)
    np.testing.assert_array_equal(g.reverse_walk(3).numpy(), np.asarray(jg.reverse_walk(3)))


def test_degraded_walk_masks_down_rows(base_csr):
    g = dist.shard_csr(base_csr, S, **CPU)
    full = dist.shard_csr(base_csr, S, **CPU)
    g.reverse_walk(3)  # memoizes the walk operands: quarantine must drop them
    sid = 1
    g.quarantine(sid)
    down = g.down_rows()
    lo, hi = g.owned_range(sid)
    np.testing.assert_array_equal(down, np.arange(lo, hi))
    got = g.reverse_walk(3).numpy().astype(np.float64)
    np.testing.assert_array_equal(got, masked_walk_oracle(full, 3, down))
    assert np.all(got[down] == 0.0)


def test_walk_fault_raises_shard_fault_error(base_csr):
    g = dist.shard_csr(base_csr, S, **CPU)
    sid = 2
    faultinject.arm("shard.walk", after=sid, times=1)
    with pytest.raises(dist.ShardFaultError) as ei:
        g.reverse_walk(2)
    faultinject.disarm()
    assert ei.value.sid == sid and ei.value.stage == "walk"
    assert isinstance(ei.value.__cause__, faultinject.InjectedKernelError)
    g.reverse_walk(2)  # the fire is spent: the next walk succeeds


@pytest.mark.parametrize("guard", ["state_trees", "gather_csr", "growth", "audit_down",
                                   "sealed_apply"])
def test_degraded_guards(guard, base_csr):
    g = dist.shard_csr(base_csr, S, **CPU)
    g.quarantine(0)
    growth = updates.plan_update(inserts=edgebatch.from_arrays([N_V + 3], [0], [1.0]))
    calls = {
        "state_trees": (dist.ShardDownError, g.state_trees),  # would persist garbage
        "gather_csr": (dist.ShardDownError, lambda: dist.gather_csr(g)),
        "growth": (dist.ShardDownError, lambda: g.apply(growth)),
        "audit_down": (dist.ShardDownError, lambda: g.audit_shard(0)),
        "sealed_apply": (RuntimeError, lambda: g.seal_generation(1).apply(make_plan())),
    }
    exc, call = calls[guard]
    with pytest.raises(exc):
        call()


def test_quarantine_rejects_unknown_shard(base_csr):
    g = dist.shard_csr(base_csr, S, **CPU)
    with pytest.raises(ValueError, match="no shard"):
        g.quarantine(S)
    g.quarantine(1)
    g.quarantine(1)  # idempotent
    assert g.down == {1}


def test_reintegrate_validates_geometry(base_csr):
    g = dist.shard_csr(base_csr, S, **CPU)
    g.quarantine(3)
    other = dist.shard_csr(base_csr, 2, **CPU)  # wrong layout on purpose
    with pytest.raises((ValueError, dist.ShardFaultError)):
        g.reintegrate(3, other.shards[0])
    assert 3 in g.down  # a rejected reintegration leaves the shard down
    with pytest.raises(ValueError, match="not quarantined"):
        g.reintegrate(0, g.shards[0])


def test_sealed_generation_keeps_down_mask(base_csr):
    g = dist.shard_csr(base_csr, S, **CPU)
    g.quarantine(2)
    sealed = g.seal_generation(7)
    assert sealed.down == {2} and sealed._frozen
    assert sealed.coverage == g.coverage
    got = sealed.reverse_walk(2).numpy()
    assert np.all(got[sealed.down_rows()] == 0.0)


def test_sealed_generation_keeps_its_buffers(base_csr):
    """A patch and a corruption of live shards copy before they write: the
    sealed generation's walk and payload stay as sealed."""
    g = dist.shard_csr(base_csr, S, **CPU)
    sealed = g.seal_generation(1)
    before = [(img.dst.clone(), img.wgt.clone()) for img in sealed.shards]
    walk0 = sealed.reverse_walk(3)
    g.apply(make_plan(seed=4, k=30))
    failover.corrupt_shard(g, 0, kind="dst")
    failover.corrupt_shard(g, 1, kind="wgt")
    for (d, w), img in zip(before, sealed.shards):
        assert torch.equal(img.dst, d) and torch.equal(img.wgt, w)
    assert torch.equal(sealed.reverse_walk(3), walk0)
    assert not torch.equal(g.reverse_walk(3), walk0)


# ---------------------------------------------------------------------------
# integrity descriptors + audit scheduling
# ---------------------------------------------------------------------------


def test_corrupt_weight_caught_only_by_integrity(base_csr):
    g = dist.shard_csr(base_csr, S, **CPU)
    g.enable_integrity()
    sid = 1
    slot = failover.corrupt_shard(g, sid, kind="wgt")
    assert slot is not None
    g.shards[sid].audit()  # structurally valid: the plain audit passes
    with pytest.raises(dist.ShardIntegrityError, match="wgt"):
        g.verify_shard(sid)


def test_corrupt_dst_caught_without_integrity(base_csr):
    g = dist.shard_csr(base_csr, S, **CPU)  # integrity OFF
    sid = 0
    assert failover.corrupt_shard(g, sid, kind="dst") is not None
    with pytest.raises(faultinject.AuditError):
        g.audit_shard(sid)  # a structural violation trips the content sweep
    with pytest.raises(faultinject.AuditError):
        faultinject.audit(g)  # the recovery gate delegates to the graph's audit


def test_corruption_matches_repro(base_csr):
    """Both packages damage the same slot, and the descriptors they
    maintain name the same damaged chunk."""
    jc = j_csr.from_coo(*_coo(), n=N_V)
    g, jg = dist.shard_csr(base_csr, S, **CPU), j_dist.shard_csr(jc, S)
    g.enable_integrity()
    jg.enable_integrity()
    for kind, sid in (("wgt", 1), ("dst", 2)):
        assert failover.corrupt_shard(g, sid, kind=kind) == \
            j_failover.corrupt_shard(jg, sid, kind=kind)
        assert g.shard_descriptor(sid) == jg.shard_descriptor(sid)
        with pytest.raises(dist.ShardIntegrityError) as a:
            g.verify_shard(sid)
        with pytest.raises(j_dist.ShardIntegrityError) as b:
            jg.verify_shard(sid)
        assert str(a.value) == str(b.value)
    with pytest.raises(ValueError, match="unknown kind"):
        failover.corrupt_shard(g, 0, kind="rows")


def test_corrupt_tick_flips_a_weight_after_a_patch(base_csr):
    g = dist.shard_csr(base_csr, S, **CPU)
    g.enable_integrity()
    faultinject.arm("shard.corrupt", times=1)
    g.apply(make_plan(seed=3))  # no exception escapes the update path
    faultinject.disarm()
    hits = [s for s in range(S) if _fails(lambda s=s: g.verify_shard(s))]
    assert len(hits) == 1


def _fails(call) -> bool:
    try:
        call()
    except dist.ShardIntegrityError:
        return True
    return False


def test_audit_scheduler_round_robin_detection(base_csr):
    g = dist.shard_csr(base_csr, S, **CPU)
    g.enable_integrity()
    sched = failover.AuditScheduler(g)
    for _ in range(S):  # one clean sweep: no false positives
        assert sched.tick() is None
    sid = 2
    failover.corrupt_shard(g, sid, kind="wgt")
    hits = [sched.tick() for _ in range(S)]
    det = [h for h in hits if h is not None]
    assert len(det) == 1 and det[0][0] == sid
    g.quarantine(sid)
    for _ in range(S):  # the scheduler keeps sweeping the healthy remainder
        assert sched.tick() is None


def test_no_false_positives_after_patches(base_csr):
    g = dist.shard_csr(base_csr, S, **CPU)
    g.enable_integrity()
    for seed in range(4):
        g.apply(make_plan(seed=seed))
        for sid in range(S):
            g.audit_shard(sid)  # descriptors refreshed per patch


# ---------------------------------------------------------------------------
# online rebuild + reintegration (DurableGraph.rebuild_shard)
# ---------------------------------------------------------------------------


def _durable_pair(base_csr, tmp_path):
    wd, cd = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    dg = durable.DurableGraph(dist.shard_csr(base_csr, S, **CPU), wd, cd, diff=True,
                              full_every=8)
    return dg, dist.shard_csr(base_csr, S, **CPU)


def test_rebuild_shard_crash_stop_roundtrip(base_csr, tmp_path):
    dg, twin = _durable_pair(base_csr, tmp_path)
    assert dg.rep_name == "sharded"
    dg.rep.enable_integrity()
    plans = [make_plan(seed=s) for s in range(6)]
    for p in plans[:2]:
        dg.apply(p)
        twin.apply(p)
    dg.checkpoint()  # bounds the single-shard replay window
    victim_plan = plans[2]
    victim = dist.route_updates(victim_plan, S, dg.rep.rows_max)[0][0]
    faultinject.arm("shard.patch", times=1)
    dg.apply(victim_plan)
    faultinject.disarm()
    twin.apply(victim_plan)
    assert dg.rep.down == {victim}
    for p in plans[3:]:  # degraded window: the victim's subs spool
        dg.apply(p)
        twin.apply(p)
    with pytest.raises(dist.ShardDownError):
        dg.checkpoint()
    assert victim in dg.rep.down
    for sid in sorted(dg.rep.down):
        stats = {}
        records = dg.rebuild_shard(sid, stats=stats)
        assert records >= 1 and stats["records"] == records
    assert not dg.rep.down and dg.rep.coverage == 1.0
    dg.rep.audit()
    for sid in range(S):
        dg.rep.verify_shard(sid)
    assert_parity(dg.rep, twin)
    dg.checkpoint()  # the rebuilt shard persists in full; the chain restores
    r = durable.DurableGraph.recover(str(tmp_path / "wal"), str(tmp_path / "ckpt"), diff=True,
                                     **CPU)
    assert_parity(r.rep, twin)


def test_rebuild_shard_discards_silent_corruption(base_csr, tmp_path):
    dg, twin = _durable_pair(base_csr, tmp_path)
    dg.rep.enable_integrity()
    for s in range(3):
        p = make_plan(seed=s)
        dg.apply(p)
        twin.apply(p)
    dg.checkpoint()
    sid = 1
    failover.corrupt_shard(dg.rep, sid, kind="wgt")
    sched = failover.AuditScheduler(dg.rep)
    det = next(h for h in (sched.tick() for _ in range(S)) if h is not None)
    assert det[0] == sid
    dg.rep.quarantine(sid)
    dg.rebuild_shard(sid)
    assert not dg.rep.down
    assert_parity(dg.rep, twin)  # the flipped weight is gone


@pytest.mark.parametrize("case", ["healthy", "single_device"])
def test_rebuild_shard_guards(case, base_csr, tmp_path):
    if case == "healthy":
        dg, _ = _durable_pair(base_csr, tmp_path)
        with pytest.raises(ValueError):
            dg.rebuild_shard(0)  # healthy shard: refuse to clobber
    else:
        from repro_torch.core import DiGraph

        dg = durable.DurableGraph(DiGraph.from_csr(base_csr, **CPU), str(tmp_path / "w"),
                                  str(tmp_path / "c"))
        with pytest.raises(TypeError, match="no shards"):
            dg.rebuild_shard(0)


def test_rebuild_shard_refuses_stale_layout(base_csr, tmp_path):
    """A checkpoint that predates a global re-shard (vertex growth) can't
    seed a single-shard rebuild — the block partition moved."""
    dg, _ = _durable_pair(base_csr, tmp_path)
    dg.apply(make_plan(seed=0))
    dg.checkpoint()
    growth = updates.plan_update(inserts=edgebatch.from_arrays([N_V + 5], [0], [1.0]))
    dg.apply(growth)  # global re-shard: n grows, rows_max moves
    dg.rep.quarantine(2)
    with pytest.raises(dist.ShardDownError, match="re-shard|recover"):
        dg.rebuild_shard(2)


# ---------------------------------------------------------------------------
# serving level: coverage lifecycle, admin plane
# ---------------------------------------------------------------------------


def _drain(tickets, timeout=WAIT_S):
    for t in tickets:
        assert t.wait(timeout), "ticket still pending"
    return tickets


def _wait_until(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def test_serve_sharded_steady_full_coverage(base_csr):
    g = dist.shard_csr(base_csr, S, **CPU)
    oracle = launch_serve.GenerationOracle(dist.gather_csr(g))
    srv = serve_mod.WalkServer(g, batch_max=4).start()
    try:
        plan = make_plan(seed=3)
        upd = srv.submit_update(plan)
        walks = _drain([srv.submit_walk([i % N_V, (i * 7) % N_V], steps=2, timeout=10.0)
                        for i in range(6)])
        assert isinstance(upd.result(WAIT_S), int)  # ΔM may be negative
    finally:
        stats = srv.stop(timeout=WAIT_S)
    srv.assert_no_lost()
    assert stats["served"] >= 1 and stats["served_degraded"] == 0
    for t in walks:
        if t.status == serve_mod.SERVED:
            assert t.coverage == 1.0 and t.down_shards == ()
            assert t.visits.device.type == "cpu"
    torn, checked = launch_serve.count_torn_reads(oracle, walks, [(upd, plan)])
    assert torn == 0 and checked == len([t for t in walks if t.status == serve_mod.SERVED])


def test_serve_degraded_coverage_lifecycle(base_csr):
    g = dist.shard_csr(base_csr, S, **CPU)
    oracle = launch_serve.GenerationOracle(dist.gather_csr(g))
    sid = 1
    srv = serve_mod.WalkServer(g, batch_max=4, dispatch_retries=4, retry_backoff=0.002).start()
    upds = []
    try:
        walks = _drain([srv.submit_walk([3], steps=2, timeout=10.0)])
        faultinject.arm("shard.walk", after=sid, times=1)
        # the faulted batch must be retried, not lost; the writer
        # quarantines and reseals degraded
        walks += _drain([srv.submit_walk([5], steps=2, timeout=10.0)])
        faultinject.disarm()
        _wait_until(lambda: srv.stats()["coverage"] < 1.0, "never resealed degraded")
        assert g.down == {sid}
        degraded = _drain([srv.submit_walk([7, 9], steps=2, timeout=10.0) for _ in range(3)])
        served = [t for t in degraded if t.status == serve_mod.SERVED]
        assert served and all(t.coverage < 1.0 and sid in t.down_shards for t in served)
        walks += degraded
        # updates are still accepted while degraded (the victim's slice spools)
        plan = make_plan(seed=9)
        upds.append((srv.submit_update(plan), plan))
        assert isinstance(upds[-1][0].result(WAIT_S), int)
        walks += _drain([srv.submit_walk([7, 9], steps=2, timeout=10.0)])
        # the admin plane reads the spool depth on the writer thread
        assert srv.run_on_writer(lambda s: len(g.spooled(sid))).result(WAIT_S) >= 1
    finally:
        faultinject.disarm()
        stats = srv.stop(timeout=WAIT_S)
    srv.assert_no_lost()
    assert stats["shard_quarantines"] >= 1 and stats["served_degraded"] >= 1
    assert stats["failed"] == 0  # the retry path, never a lost batch
    down_rows = g.down_rows()
    torn, checked = launch_serve.count_torn_reads(
        oracle, walks, upds, down_rows_of=lambda t: down_rows if t.down_shards else None)
    assert torn == 0 and checked == len(walks)


def test_serve_audit_pacing_detects_corruption(base_csr):
    g = dist.shard_csr(base_csr, S, **CPU)
    g.enable_integrity()
    sid = 2
    srv = serve_mod.WalkServer(g, batch_max=4, audit_every=1).start()
    try:
        _drain([srv.submit_walk([1], steps=2, timeout=10.0)])
        srv.run_on_writer(lambda s: failover.corrupt_shard(g, sid, kind="wgt")).result(WAIT_S)
        _wait_until(lambda: srv.stats()["audit_detections"] > 0, "paced audit never detected")
        assert sid in g.down
        _wait_until(lambda: srv.stats()["coverage"] < 1.0, "never resealed degraded")
        t = _drain([srv.submit_walk([1], steps=2, timeout=10.0)])[0]
        assert t.status == serve_mod.SERVED and t.coverage < 1.0
    finally:
        stats = srv.stop(timeout=WAIT_S)
    srv.assert_no_lost()
    assert stats["audit_detections"] >= 1


def test_serve_reintegration_restores_full_coverage(base_csr, tmp_path):
    """A shard lost while serving a DurableGraph is rebuilt on the writer
    thread; the next generation serves at full coverage again."""
    dg = durable.DurableGraph(dist.shard_csr(base_csr, S, **CPU), str(tmp_path / "w"),
                              str(tmp_path / "c"), diff=True)
    srv = serve_mod.WalkServer(dg, batch_max=4).start()
    try:
        assert isinstance(srv.submit_update(make_plan(seed=5)).result(WAIT_S), int)
        srv.request_quarantine(3)
        _wait_until(lambda: srv.stats()["coverage"] < 1.0, "never resealed degraded")
        assert isinstance(srv.submit_update(make_plan(seed=6)).result(WAIT_S), int)
        assert srv.run_on_writer(lambda s: dg.rebuild_shard(3), reseal=True).result(WAIT_S) == 2
        _wait_until(lambda: srv.stats()["coverage"] == 1.0, "never resealed at full coverage")
        t = _drain([srv.submit_walk([1, 2], steps=2, timeout=10.0)])[0]
        assert t.status == serve_mod.SERVED and t.coverage == 1.0 and t.down_shards == ()
    finally:
        stats = srv.stop(timeout=WAIT_S)
    srv.assert_no_lost()
    assert stats["shard_quarantines"] == 1 and not dg.rep.down


def test_run_on_writer_serializes_and_accounts(base_csr):
    g = dist.shard_csr(base_csr, S, **CPU)
    srv = serve_mod.WalkServer(g).start()
    try:
        assert srv.run_on_writer(lambda s: s is srv).result(WAIT_S) is True
        bad = srv.run_on_writer(lambda s: 1 / 0)
        with pytest.raises(RuntimeError):
            bad.result(WAIT_S)
        assert srv.stats()["admin_ops"] == 1  # failures don't count
    finally:
        srv.stop(timeout=WAIT_S)
    late = srv.run_on_writer(lambda s: None)
    assert late.status == serve_mod.REJECTED  # after stop: a clean reject


def test_retry_backoff_exponential_capped_jittered():
    srv = serve_mod.WalkServer(object(), retry_backoff=0.01, retry_max_backoff=0.08)
    for attempt in (1, 2, 3, 4, 5, 8):
        base = min(0.01 * 2 ** (attempt - 1), 0.08)
        samples = [srv._retry_sleep_s(attempt) for _ in range(50)]
        assert all(0.5 * base <= s <= 1.5 * base for s in samples)
    # the jitter spreads (not a constant)
    assert len({round(s, 6) for s in (srv._retry_sleep_s(3) for _ in range(20))}) > 1
