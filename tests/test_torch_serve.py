"""Walk serving in the port (``repro_torch.runtime.serve``,
``repro_torch.launch.serve``, ``repro_torch.runtime.failover``), on the CPU.

Two halves:

* the port against ``repro`` on the same numpy inputs: the generation
  oracles on the same plans and rows (rtol 1e-12), one run of both
  packages' ``WalkServer`` on the same graph and traffic (the visits per
  ticket at rtol 1e-4, the deterministic stats counters equal), and both
  packages' ``AuditScheduler`` over one stub mesh;
* the port alone: the counterparts of ``tests/test_serve.py``'s serving
  cases (the oracle on all five representations, the sealed generation
  under the writer, the seal guards, the reader/writer sweeps, admission,
  shedding, bad seeds, shutdown, the enqueue / dispatch / seal faults and
  the soak), the kernel-site fault points, which raise once with no chain
  behind them (a ``slot_walk.torch`` fault mid-traffic is served by the
  server's retry on the same backend), and the CLI on the CPU.

``repro``'s breaker tests have no counterpart: ``kernels/fallback.py`` is
not ported.  Every wait has a timeout and every server stops in a
``finally``, so a hang fails a test instead of eating the suite's clock.
"""
import ctypes
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as J
from repro.launch import serve as j_launch
from repro.runtime import failover as j_failover
from repro.runtime import serve as j_serve
import repro_torch.core as T
from repro_torch.core import csr, walk_image
from repro_torch.kernels import _build
from repro_torch.kernels.slot_walk import ops as sw_ops
from repro_torch.launch import serve as launch_serve
from repro_torch.runtime import failover, faultinject
from repro_torch.runtime import serve as serve_mod

N_V = 48
CPU = {"device": "cpu"}
WAIT_S = 60.0
#: stats counters a run with every update acked before the walks makes
#: the same in both packages (batches, max_batch and the EMA follow timing)
DETERMINISTIC = (
    "submitted", "served", "shed_expired", "rejected_backpressure", "rejected_other",
    "failed", "updates_submitted", "updates_applied", "updates_failed",
    "updates_rejected", "seals", "seal_failures", "dispatch_retries",
    "breaker_fallbacks", "shard_quarantines", "audit_detections", "served_degraded",
    "admin_ops", "generation", "queue_depth", "update_depth", "coverage", "down_shards",
)


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


def _coo(seed=23, m=220):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N_V, m), rng.integers(0, N_V, m),
            rng.random(m).astype(np.float32))


@pytest.fixture(scope="module")
def base_csr():
    return csr.from_coo(*_coo(), n=N_V, **CPU)


def make_plan(rng, n=N_V, n_ins=12, n_del=6, pkg=T):
    """A mixed plan of ``pkg`` (``repro.core`` or ``repro_torch.core``)."""
    ib = pkg.edgebatch.from_arrays(
        rng.integers(0, n, n_ins), rng.integers(0, n, n_ins),
        rng.random(n_ins).astype(np.float32),
    )
    db = pkg.edgebatch.from_arrays(rng.integers(0, n, n_del), rng.integers(0, n, n_del))
    return pkg.plan_update(inserts=ib, deletes=db)


class running:
    """``with running(rep, **kw) as srv``: a started server, always stopped."""

    def __init__(self, rep, module=serve_mod, **kw):
        self.srv = module.WalkServer(rep, **kw)

    def __enter__(self):
        return self.srv.start()

    def __exit__(self, *exc):
        self.srv.stop(drain=exc[0] is None, timeout=WAIT_S)


def wait_all(tickets, timeout=WAIT_S):
    for t in tickets:
        assert t.wait(timeout), "ticket still pending"


def serve_and_verify(rep_kind, base, *, requests=24, update_every=4, seed=3, **server_kw):
    """Mixed traffic against ``rep_kind``: (stats, torn, checked), the
    zero-lost ledger asserted."""
    rep = T.REPRESENTATIONS[rep_kind].from_csr(base, **CPU)
    rng = np.random.default_rng(seed)
    walks, upds = [], []
    with running(rep, **server_kw) as srv:
        for i in range(requests):
            if update_every and i % update_every == 0:
                plan = make_plan(rng)
                upds.append((srv.submit_update(plan), plan))
            walks.append(srv.submit_walk(rng.integers(0, N_V, 3), steps=3))
        wait_all(walks)
    stats = srv.assert_no_lost()
    torn, checked = launch_serve.count_torn_reads(
        launch_serve.GenerationOracle(base), walks, upds
    )
    return stats, torn, checked


# ---------------------------------------------------------------------------
# the port against repro
# ---------------------------------------------------------------------------


def _oracle_twins():
    src, dst, wgt = _coo(seed=5, m=400)
    return (j_launch.GenerationOracle(J.from_coo(src, dst, wgt, n=N_V)),
            launch_serve.GenerationOracle(csr.from_coo(src, dst, wgt, n=N_V, **CPU)))


@pytest.mark.parametrize("drop", [False, True], ids=["full", "dropped_rows"])
def test_generation_oracle_matches_repro(drop):
    jo, to = _oracle_twins()
    ra, rb = np.random.default_rng(8), np.random.default_rng(8)
    for gen in range(1, 5):
        jo.record(gen, make_plan(ra, n_ins=20, n_del=30, pkg=J))
        to.record(gen, make_plan(rb, n_ins=20, n_del=30, pkg=T))
    rng = np.random.default_rng(9)
    drop_rows = np.array([3, 17, 40]) if drop else None
    for gen in (0, 1, 1, 3, 4):
        row = rng.random(N_V).astype(np.float32)
        seeds = rng.integers(0, N_V, 5)
        for r_j, r_t in ((row, torch.from_numpy(row)),
                         (j_launch.seed_visits_row(N_V, seeds),
                          launch_serve.seed_visits_row(N_V, seeds, **CPU))):
            np.testing.assert_array_equal(r_t.numpy(), r_j)
            exp = jo.walk(gen, r_j, 4, drop_rows=drop_rows)
            got = to.walk(gen, r_t, 4, drop_rows=drop_rows)
            assert got.dtype == torch.float64 and got.shape == (N_V,)
            np.testing.assert_allclose(got.numpy(), exp, rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="rewind"):
        to.walk(2, np.ones(N_V), 1)


def test_oracle_edge_set_follows_plans():
    """The key tensor equals the set a plain Python replay keeps."""
    _, to = _oracle_twins()
    edges = {(int(k) // N_V, int(k) % N_V) for k in to._keys}
    rng = np.random.default_rng(4)
    for gen in range(1, 4):
        plan = make_plan(rng, n_ins=15, n_del=25)
        to.record(gen, plan)
        for s, d, rm in zip(plan.q_src.tolist(), plan.q_dst.tolist(), plan.q_del.tolist()):
            (edges.discard if rm else edges.add)((s, d))
        to.walk(gen, np.ones(N_V), 1)
        keys = to._keys.numpy()
        assert np.all(np.diff(keys) > 0), "keys sorted and unique"
        assert {(int(k) // N_V, int(k) % N_V) for k in keys} == edges


@pytest.mark.parametrize("rep_kind", ["digraph", "chunked"])
def test_served_walks_match_repro(rep_kind):
    """Both packages' WalkServer on the same graph and traffic: every
    update acked before the walks, so each ticket's generation, its visits
    (rtol 1e-4) and the deterministic counters agree."""
    src, dst, wgt = _coo()
    reps = {"repro": (J.REPRESENTATIONS[rep_kind].from_csr(J.from_coo(src, dst, wgt, n=N_V)),
                      j_serve, J),
            "port": (T.REPRESENTATIONS[rep_kind].from_csr(
                csr.from_coo(src, dst, wgt, n=N_V, **CPU), **CPU), serve_mod, T)}
    out = {}
    for name, (rep, module, pkg) in reps.items():
        rng = np.random.default_rng(21)
        walks = []
        with running(rep, module=module, batch_max=4) as srv:
            for _ in range(3):
                ut = srv.submit_update(make_plan(rng, pkg=pkg))
                assert ut.wait(WAIT_S) and ut.status == module.SERVED
            for i in range(10):
                seeds = rng.integers(0, N_V, 3)
                if i % 3 == 2:
                    walks.append(srv.submit_walk(seeds, weights=[0.5, 2.0, 1.0], steps=3))
                elif i % 3 == 1:
                    walks.append(srv.submit_walk(visits0=rng.random(N_V).astype(np.float32),
                                                 steps=2))
                else:
                    walks.append(srv.submit_walk(seeds, steps=3))
            walks.append(srv.submit_walk([N_V + 1], steps=3))  # rejected in both
            wait_all(walks)
        out[name] = (walks, srv.assert_no_lost())
    (jw, js), (tw, ts) = out["repro"], out["port"]
    assert {k: ts[k] for k in DETERMINISTIC} == {k: js[k] for k in DETERMINISTIC}
    assert ts["breaker_fallbacks"] == 0 and ts["seals"] == 4
    for a, b in zip(jw, tw):
        assert (b.status, b.reason, b.generation) == (a.status, a.reason, a.generation)
        if a.status == j_serve.SERVED:
            assert isinstance(b.visits, torch.Tensor) and b.visits.device.type == "cpu"
            np.testing.assert_allclose(b.result().numpy(), np.asarray(a.result()), rtol=1e-4)


def test_audit_scheduler_matches_repro():
    """Both packages' scheduler over one stub mesh: the same sweep order,
    the same detections, down shards skipped."""

    class Mesh:
        def __init__(self):
            self.n_shards, self.down, self.audited = 4, {1}, []

        def audit_shard(self, sid):
            self.audited.append(sid)
            if sid == 2:
                raise ValueError("shard 2 corrupt")

    res = {}
    for name, mod in (("repro", j_failover), ("port", failover)):
        mesh = Mesh()
        sched = mod.AuditScheduler(mesh)
        hits = []
        for i in range(7):
            if i == 5:
                mesh.down = {0, 1, 2, 3}
            hit = sched.tick()
            hits.append(None if hit is None else (hit[0], str(hit[1])))
        res[name] = (hits, mesh.audited, sched.ticks, [s for s, _ in sched.detections])
    assert res["port"] == res["repro"]
    assert res["port"][0][1] == (2, "shard 2 corrupt")


# ---------------------------------------------------------------------------
# snapshot isolation: every served walk is consistent with its generation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rep_kind", list(T.REPRESENTATIONS))
def test_served_walks_match_generation_oracle(rep_kind, base_csr):
    stats, torn, checked = serve_and_verify(rep_kind, base_csr)
    assert stats["served"] == 24
    assert checked == 24 and torn == 0
    assert stats["seals"] >= 2  # updates actually advanced generations


@pytest.mark.parametrize("rep_kind", list(T.REPRESENTATIONS))
def test_sealed_generation_immutable_under_writer(rep_kind, base_csr):
    """A sealed generation's walk result must not change while the live
    rep keeps applying plans (the port's copy-on-write)."""
    rep = T.REPRESENTATIONS[rep_kind].from_csr(base_csr, **CPU)
    gen = walk_image.seal_generation(rep, 1)
    before = gen.walk(3).clone()
    payload = [t.clone() for t in (gen.dst, gen.wgt, gen.rows)]
    rng = np.random.default_rng(5)
    for _ in range(4):
        rep, _ = rep.apply(make_plan(rng))
        rep.reverse_walk(2)  # force the live image's flush/patch
    assert torch.equal(gen.walk(3), before)
    for a, b in zip(payload, (gen.dst, gen.wgt, gen.rows)):
        assert torch.equal(a, b)


def test_seal_api_guards(base_csr):
    rep = T.REPRESENTATIONS["chunked"].from_csr(base_csr, **CPU)
    img = rep.to_walk_image()
    gen = img.seal(7)
    assert gen.generation == 7 and gen._frozen
    with pytest.raises(RuntimeError, match="read-only"):
        gen.queue(make_plan(np.random.default_rng(0)))
    img.queue(make_plan(np.random.default_rng(1)))
    with pytest.raises(ValueError, match="unflushed"):
        img.seal(8)
    shared = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU).to_walk_image()
    with pytest.raises(ValueError, match="shared"):
        shared.seal(9)


@pytest.mark.parametrize("rep_kind", ["digraph", "chunked"])
def test_concurrent_reader_writer_sweep(rep_kind, base_csr):
    """A writer applies+seals while three reader threads walk, with a
    shortened switch interval; every served walk matches the oracle for
    its own sealed generation — no torn reads."""
    rep = T.REPRESENTATIONS[rep_kind].from_csr(base_csr, **CPU)
    rng = np.random.default_rng(17)
    upds, walks, stop = [], [], threading.Event()
    lock = threading.Lock()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with running(rep, batch_max=4) as srv:

            def reader(seed):
                r = np.random.default_rng(seed)
                while not stop.is_set():
                    t = srv.submit_walk(r.integers(0, N_V, 2), steps=2)
                    t.wait(WAIT_S)
                    with lock:
                        walks.append(t)

            threads = [threading.Thread(target=reader, args=(s,)) for s in (31, 32, 33)]
            for th in threads:
                th.start()
            try:
                for _ in range(8):
                    plan = make_plan(rng)
                    upds.append((srv.submit_update(plan), plan))
                    time.sleep(0.01)
                wait_all([t for t, _ in upds])
            finally:
                stop.set()
                for th in threads:
                    th.join(WAIT_S)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    srv.assert_no_lost()
    torn, checked = launch_serve.count_torn_reads(
        launch_serve.GenerationOracle(base_csr), walks, upds
    )
    assert checked > 0 and torn == 0


def test_hypothesis_reader_writer_sweep(base_csr):
    """Hypothesis-driven schedules over the same contract."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=5, deadline=None)
    @hyp.given(
        seed=st.integers(0, 2**16),
        n_updates=st.integers(1, 6),
        batch_max=st.sampled_from([1, 2, 8]),
        rep_kind=st.sampled_from(["digraph", "chunked"]),
    )
    def inner(seed, n_updates, batch_max, rep_kind):
        rep = T.REPRESENTATIONS[rep_kind].from_csr(base_csr, **CPU)
        rng = np.random.default_rng(seed)
        walks, upds = [], []
        with running(rep, batch_max=batch_max) as srv:
            for _ in range(n_updates):
                plan = make_plan(rng)
                upds.append((srv.submit_update(plan), plan))
                for _ in range(int(rng.integers(1, 4))):
                    walks.append(srv.submit_walk(rng.integers(0, N_V, 2), steps=2))
            wait_all(walks)
        srv.assert_no_lost()
        torn, checked = launch_serve.count_torn_reads(
            launch_serve.GenerationOracle(base_csr), walks, upds
        )
        assert torn == 0 and checked == len(walks)

    inner()


def test_batch_walks_exactly_its_live_rows(base_csr, monkeypatch):
    """No pow-2 padding: a batch of b tickets walks a [b, V] block, and
    each ticket's visits are its row of it, on the server's device."""
    rep = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    shapes = []
    inner = walk_image.WalkImage.walk

    def spy(self, steps, **kw):
        shapes.append(tuple(kw["visits0"].shape))
        return inner(self, steps, **kw)

    monkeypatch.setattr(walk_image.WalkImage, "walk", spy)
    with running(rep, batch_max=8) as srv:
        tickets = [srv.submit_walk([i, i + 1], steps=2) for i in range(3)]
        wait_all(tickets)
    assert all(s[0] in (1, 2, 3) for s in shapes) and sum(s[0] for s in shapes) == 3
    nv = srv.generation.image.nv
    for t in tickets:
        v = t.result(1.0)
        assert v.dtype == torch.float32 and v.shape == (nv,) and v.device.type == "cpu"
        exp = launch_serve.GenerationOracle(base_csr).walk(
            0, launch_serve.seed_visits_row(nv, t.seeds, **CPU), 2)
        np.testing.assert_allclose(v.numpy(), exp.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# admission control: backpressure, deadlines, shedding
# ---------------------------------------------------------------------------


def test_backpressure_rejects_with_retry_after(base_csr):
    rep = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    with running(rep, max_queue=4, batch_max=2) as srv:
        tickets = [srv.submit_walk([1, 2], steps=2) for _ in range(120)]
        wait_all(tickets)
    stats = srv.assert_no_lost()
    rejected = [t for t in tickets if t.status == serve_mod.REJECTED]
    assert stats["rejected_backpressure"] == len(rejected) > 0
    for t in rejected:
        assert t.reason == "backpressure"
        assert t.retry_after is not None and t.retry_after > 0
        with pytest.raises(serve_mod.RejectedError, match="backpressure"):
            t.result()


def test_expired_requests_are_shed_not_walked(base_csr):
    rep = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    with running(rep, batch_max=1, max_queue=512) as srv:
        tickets = [srv.submit_walk([1], steps=2, timeout=1e-4) for _ in range(60)]
        wait_all(tickets)
    stats = srv.assert_no_lost()
    assert stats["shed_expired"] > 0
    shed = [t for t in tickets if t.reason == "expired"]
    assert len(shed) == stats["shed_expired"]
    assert all(t.visits is None for t in shed)


def test_bad_requests_rejected_cleanly(base_csr):
    rep = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    with running(rep) as srv:
        bad = srv.submit_walk([N_V + 100], steps=2)
        empty = srv.submit_walk([], steps=2)
        short = srv.submit_walk(visits0=np.ones(N_V - 1, np.float32), steps=2)
        mism = srv.submit_walk([1, 2], weights=[1.0], steps=2)
        ok = srv.submit_walk([1], steps=2)
        wait_all([bad, empty, short, mism, ok])
    stats = srv.assert_no_lost()
    assert (bad.reason, empty.reason) == ("seed_out_of_range", "seed_out_of_range")
    assert (short.reason, mism.reason) == ("shape_mismatch", "shape_mismatch")
    assert ok.status == serve_mod.SERVED and stats["rejected_other"] == 4


def test_shutdown_rejects_new_requests(base_csr):
    rep = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    srv = serve_mod.WalkServer(rep).start()
    srv.stop()
    t = srv.submit_walk([1], steps=2)
    u = srv.submit_update(make_plan(np.random.default_rng(0)))
    a = srv.run_on_writer(lambda s: 1)
    assert t.status == serve_mod.REJECTED and t.reason == "shutdown"
    assert u.reason == "shutdown" and a.reason == "shutdown"
    srv.assert_no_lost()


def test_walk_backend_resolves_on_the_image_device(base_csr):
    rep = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    for bad in ("cuda", "pallas"):
        srv = serve_mod.WalkServer(rep, walk_backend=bad)
        with pytest.raises(ValueError):
            srv.start()
        assert not srv._threads
    with running(rep, walk_backend="torch") as srv:
        assert srv._backend == "torch"
        assert srv.submit_walk([1], steps=2).result(WAIT_S).shape == (N_V,)


def test_control_plane_inert_on_single_device(base_csr):
    """Quarantine requests and audit ticks do nothing to a rep without
    shards; admin ops run on the writer and may reseal."""
    rep = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    with running(rep, audit_every=1) as srv:
        srv.request_quarantine(0)
        a = srv.run_on_writer(lambda s: s._rep.m, reseal=True)
        assert a.result(WAIT_S) == rep.m
        deadline = time.monotonic() + WAIT_S
        while srv.stats()["generation"] < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        boom = srv.run_on_writer(lambda s: 1 / 0)
        assert boom.wait(WAIT_S) and boom.status == serve_mod.FAILED
        w = srv.submit_walk([1, 2], steps=2)
        assert w.wait(WAIT_S)
    stats = srv.assert_no_lost()
    assert (stats["admin_ops"], stats["shard_quarantines"], stats["audit_detections"]) == (1, 0, 0)
    assert stats["seals"] == 2 and w.generation == 1 and w.coverage == 1.0
    assert stats["coverage"] == 1.0 and stats["down_shards"] == ()


# ---------------------------------------------------------------------------
# fault-injected audits: enqueue / seal / dispatch boundaries, kernel sites
# ---------------------------------------------------------------------------


def test_enqueue_fault_is_clean_rejection(base_csr):
    rep = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    try:
        with running(rep) as srv:
            faultinject.arm("serve.enqueue", times=1)
            t1 = srv.submit_walk([1], steps=2)
            t2 = srv.submit_walk([2], steps=2)
            assert t1.status == serve_mod.REJECTED and t1.reason == "enqueue_fault"
            assert isinstance(t1.error, faultinject.InjectedKernelError)
            assert t2.wait(WAIT_S) and t2.status == serve_mod.SERVED
    finally:
        faultinject.disarm()
    srv.assert_no_lost()


def test_dispatch_fault_retried_zero_lost(base_csr):
    rep = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    try:
        with running(rep) as srv:
            faultinject.arm("serve.dispatch", times=1)
            tickets = [srv.submit_walk([1, 2], steps=2) for _ in range(8)]
            wait_all(tickets)
    finally:
        faultinject.disarm()
    stats = srv.assert_no_lost()
    assert stats["served"] == 8 and stats["dispatch_retries"] >= 1


def test_dispatch_fault_exhausted_fails_visibly(base_csr):
    rep = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    try:
        with running(rep, dispatch_retries=1) as srv:
            faultinject.arm("serve.dispatch", times=50)
            t = srv.submit_walk([1], steps=2)
            assert t.wait(WAIT_S)
    finally:
        faultinject.disarm()
    stats = srv.assert_no_lost()
    assert t.status == serve_mod.FAILED and stats["failed"] == 1
    with pytest.raises(RuntimeError, match="request failed"):
        t.result()


def test_seal_fault_keeps_readers_on_previous_generation(base_csr):
    rep = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    plan = make_plan(np.random.default_rng(9))
    try:
        with running(rep) as srv:
            faultinject.arm("serve.seal", times=1)
            ut = srv.submit_update(plan)
            assert ut.wait(WAIT_S)  # writer retried the seal and acked
            wt = srv.submit_walk([1, 2], steps=2)
            assert wt.wait(WAIT_S)
    finally:
        faultinject.disarm()
    stats = srv.assert_no_lost()
    assert stats["seal_failures"] >= 1
    assert ut.status == serve_mod.SERVED and ut.generation == 1
    assert wt.generation >= 1
    torn, checked = launch_serve.count_torn_reads(
        launch_serve.GenerationOracle(base_csr), [wt], [(ut, plan)]
    )
    assert checked == 1 and torn == 0


def test_walks_during_failed_seal_read_the_previous_generation(base_csr):
    """While the seal keeps failing the update stays unacked and readers
    walk generation 0 (without it); once the seal succeeds the update acks
    as generation 1 and readers see it."""
    rep = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    plan = make_plan(np.random.default_rng(9))
    try:
        with running(rep, retry_backoff=0.01) as srv:
            faultinject.arm("serve.seal", times=10**6)
            ut = srv.submit_update(plan)
            deadline = time.monotonic() + WAIT_S
            while srv.stats()["seal_failures"] < 2 and time.monotonic() < deadline:
                time.sleep(0.005)
            before = srv.submit_walk([1, 2, 5], steps=2)
            assert before.wait(WAIT_S) and not ut.done
            faultinject.disarm("serve.seal")
            assert ut.wait(WAIT_S)
            after = srv.submit_walk([1, 2, 5], steps=2)
            assert after.wait(WAIT_S)
    finally:
        faultinject.disarm()
    stats = srv.assert_no_lost()
    assert stats["seal_failures"] >= 2
    assert (before.generation, ut.generation, after.generation) == (0, 1, 1)
    torn, checked = launch_serve.count_torn_reads(
        launch_serve.GenerationOracle(base_csr), [before, after], [(ut, plan)]
    )
    assert checked == 2 and torn == 0


def test_slot_walk_fault_mid_traffic_served_by_retry(base_csr):
    """The port's counterpart of repro's pallas trip: an injected
    ``slot_walk.torch`` failure is retried on the same backend (no chain,
    no other backend), with zero lost requests."""
    rep = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    try:
        with running(rep, batch_max=4) as srv:
            faultinject.arm("slot_walk.torch", times=2)
            tickets = [srv.submit_walk([1, 2], steps=2) for _ in range(12)]
            wait_all(tickets)
            fired = faultinject.fired("slot_walk.torch")
    finally:
        faultinject.disarm()
    stats = srv.assert_no_lost()
    assert srv._backend == "torch" and fired == 2
    assert stats["served"] == 12 and stats["failed"] == 0
    assert stats["dispatch_retries"] >= 1 and stats["breaker_fallbacks"] == 0
    assert max(t.attempts for t in tickets) >= 1


def test_slot_walk_fault_persistent_fails_visibly(base_csr):
    rep = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    try:
        with running(rep, dispatch_retries=2) as srv:
            faultinject.arm("slot_walk.torch", times=10**6)
            t = srv.submit_walk([1], steps=2)
            assert t.wait(WAIT_S)
            fired = faultinject.fired("slot_walk.torch")
    finally:
        faultinject.disarm()
    stats = srv.assert_no_lost()
    assert fired == 3  # the first attempt and two retries, nothing else
    assert t.status == serve_mod.FAILED and stats["failed"] == 1
    assert isinstance(t.error, faultinject.InjectedKernelError)
    with pytest.raises(RuntimeError, match="request failed") as exc:
        t.result()
    assert "slot_walk.torch" in str(exc.value.__cause__)


def test_slot_update_fault_fails_the_update_visibly(base_csr):
    rep = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    rng = np.random.default_rng(12)
    bad, good = make_plan(rng), make_plan(rng)
    try:
        with running(rep) as srv:
            faultinject.arm("slot_update.torch", times=1)
            u1 = srv.submit_update(bad)
            u2 = srv.submit_update(good)
            wait_all([u1, u2])
            w = srv.submit_walk([1, 2, 3], steps=3)
            assert w.wait(WAIT_S)
    finally:
        faultinject.disarm()
    stats = srv.assert_no_lost()
    assert u1.status == serve_mod.FAILED and u2.status == serve_mod.SERVED
    assert (stats["updates_failed"], stats["updates_applied"]) == (1, 1)
    torn, checked = launch_serve.count_torn_reads(
        launch_serve.GenerationOracle(base_csr), [w], [(u1, bad), (u2, good)]
    )
    assert checked == 1 and torn == 0


def test_poisoned_device_fails_every_ticket_visibly(base_csr, monkeypatch):
    """A sticky device error (every device call raises, as after an
    illegal address) fails each walk after its retries and each update at
    once; nothing hangs and nothing is lost."""
    rep = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)

    def poisoned(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with running(rep, dispatch_retries=2, retry_backoff=1e-4) as srv:
        monkeypatch.setattr(serve_mod.WalkServer, "_initial_visits", staticmethod(poisoned))
        monkeypatch.setattr(rep, "apply", poisoned)
        walks = [srv.submit_walk([1, i], steps=2) for i in range(6)]
        upd = srv.submit_update(make_plan(np.random.default_rng(1)))
        wait_all(walks + [upd])
    stats = srv.assert_no_lost()
    assert all(t.status == serve_mod.FAILED for t in walks + [upd])
    assert (stats["failed"], stats["updates_failed"], stats["served"]) == (6, 1, 0)
    assert all(t.attempts == 3 for t in walks)
    with pytest.raises(RuntimeError, match="request failed") as exc:
        walks[0].result()
    assert "illegal memory access" in str(exc.value.__cause__)


def test_kernel_fault_points_fire_once_with_no_chain(base_csr):
    """``slot_walk`` and ``fused_apply`` fire ``<site>.<backend>`` once
    before their one attempt; the error reaches the caller, operands
    untouched, and the next call runs."""
    g = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    img = g.to_walk_image()
    exp = img.walk(3)
    with faultinject.injected("slot_walk.torch"):
        with pytest.raises(faultinject.InjectedKernelError, match="slot_walk.torch"):
            img.walk(3)
        assert faultinject.fired("slot_walk.torch") == 1
        assert torch.equal(img.walk(3), exp)
    with faultinject.injected("slot_walk.cuda"):  # not this backend's point
        assert torch.equal(sw_ops.slot_walk_image(img, 3), exp)
        assert faultinject.fired("slot_walk.cuda") == 0
    before = [t.clone() for t in (g.dst, g.wgt, g.slot_rows)]
    m = g.m
    with faultinject.injected("slot_update.torch"):
        with pytest.raises(faultinject.InjectedKernelError, match="slot_update.torch"):
            g.apply(make_plan(np.random.default_rng(2)))
    for a, b in zip(before, (g.dst, g.wgt, g.slot_rows)):
        assert torch.equal(a, b)
    assert g.m == m and int(g.degrees.sum()) == m
    # the walk that walk_flush queues behind its patch fires no slot_walk.* point
    c = T.REPRESENTATIONS["coo"].from_csr(base_csr, **CPU)
    c.reverse_walk(2)
    c, _ = c.apply(make_plan(np.random.default_rng(3)))
    with faultinject.injected("slot_walk.torch", times=10):
        assert c.reverse_walk(2).shape == (N_V,)  # walk_flush: one fused_apply
        assert faultinject.fired("slot_walk.torch") == 0


def test_serve_soak_mixed_traffic(base_csr):
    """Sustained mixed traffic with a mid-run injected dispatch fault;
    everything resolves, torn_reads == 0."""
    rep = T.REPRESENTATIONS["chunked"].from_csr(base_csr, **CPU)
    rng = np.random.default_rng(41)
    walks, upds = [], []
    try:
        with running(rep, batch_max=8, max_queue=64) as srv:
            for i in range(120):
                if i % 6 == 0:
                    plan = make_plan(rng)
                    upds.append((srv.submit_update(plan), plan))
                if i == 60:
                    faultinject.arm("serve.dispatch", times=2)
                walks.append(srv.submit_walk(rng.integers(0, N_V, 2), steps=2))
            wait_all(walks, timeout=120.0)
    finally:
        faultinject.disarm()
    stats = srv.assert_no_lost()
    torn, checked = launch_serve.count_torn_reads(
        launch_serve.GenerationOracle(base_csr), walks, upds
    )
    assert torn == 0 and checked == stats["served"] > 0


# ---------------------------------------------------------------------------
# the CLI, the traffic helpers, the kernel build lock
# ---------------------------------------------------------------------------


def test_cli_main_on_cpu(capsys):
    stats = launch_serve.main(["--device", "cpu", "--scale", "6", "--requests", "40",
                               "--update-every", "8", "--update-size", "32",
                               "--verify", "1.0", "--batch-max", "8"])
    out = capsys.readouterr().out
    assert stats["served"] == stats["submitted"] == 40 and stats["updates_applied"] == 5
    assert "torn_reads=0/40 checked" in out and "device=cpu" in out


def test_run_traffic_and_percentiles(base_csr):
    rep = T.REPRESENTATIONS["coo"].from_csr(base_csr, **CPU)
    with running(rep, batch_max=16) as srv:
        walks, upds = launch_serve.run_traffic(srv, N_V, requests=30, steps=2,
                                               update_every=5, update_size=16, seed=13)
        wait_all(walks)
        wait_all([t for t, _ in upds])
    srv.assert_no_lost()
    assert len(walks) == 30 and len(upds) == 6
    assert [p.n_del > 0 for _, p in upds] == [False, False, False, True, False, False]
    pct = launch_serve.percentiles([t.latency_s for t in walks])
    assert 0 < pct["p50_ms"] <= pct["p95_ms"] <= pct["p99_ms"]
    assert np.isnan(launch_serve.percentiles([])["p99_ms"])
    for t, _ in upds:
        assert t.resolved_at >= t.submitted_at
    torn, checked = launch_serve.count_torn_reads(
        launch_serve.GenerationOracle(base_csr), walks, upds, sample=0.5, seed=7)
    assert torn == 0 and 0 < checked < 30


def test_first_kernel_build_is_serialised(monkeypatch, tmp_path):
    """Two threads that launch their first kernels together build once:
    ``library()`` holds one lock around the build and the load."""
    builds, loads = [], []

    def fake_compile(sources, lib_path):
        builds.append(threading.current_thread().name)
        time.sleep(0.05)  # a slow nvcc: the other thread arrives meanwhile
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        lib_path.write_bytes(b"")

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    def fake_cdll(path):
        loads.append(path)
        return FakeLib()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    _build._load.cache_clear()
    try:
        out = []
        threads = [threading.Thread(target=lambda: out.append(_build.library()),
                                    name=f"t{i}") for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT_S)
        assert not any(th.is_alive() for th in threads)
    finally:
        _build._load.cache_clear()
    assert len(builds) == 1 and len(loads) == 1
    assert len(out) == 4 and all(lib is out[0] for lib in out)
