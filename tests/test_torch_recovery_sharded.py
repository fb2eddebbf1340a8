"""Sharded durability in the port (DESIGN.md §15): owner-routed parallel WAL
replay, group commit, and tracked differential checkpoints of a
``ShardedGraph`` (``repro_torch.runtime.durable``), on the CPU.

The cases of ``tests/test_recovery_sharded.py`` on the port: the crash
matrix (crash points × S ∈ {2, 4} × full / differential checkpoints) and
the single-device differential matrix, group commit and its torn tail,
parallel against serial replay, growth epochs, the recovery stats, the
differential chain's compaction, its dirty hints and the post-recovery
full checkpoint.  A recovered graph is held against an uncrashed twin:
``gather_csr`` and the walk bit for bit, and every shard's
``state_trees()`` whenever neither side took a global re-shard.

Across the packages: the same durable stream writes the same WAL segments
and the same step directories (manifests byte for byte, the dirty-hinted
differential steps included), and a crash recovery written by one package
is recovered by the other, bit for bit against the writer's twin.
"""
import os
import pathlib

import numpy as np
import pytest

from repro.core import csr as j_csr
from repro.core import distributed as j_dist
from repro.core import edgebatch as j_eb
from repro.core import updates as j_up
from repro.runtime import durable as j_dur
from repro.runtime import faultinject as j_fi
import repro_torch.core as T
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import csr, distributed as dist, edgebatch, updates
from repro_torch.runtime import durable, faultinject

N_V = 48
CRASH_POINTS = ("durable.pre_append", "durable.post_append", "durable.post_apply")
CPU = {"device": "cpu"}


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
    rng = np.random.default_rng(11)
    m = 220
    return (rng.integers(0, N_V, m), rng.integers(0, N_V, m),
            rng.random(m).astype(np.float32))


@pytest.fixture(scope="module")
def base_csr():
    return csr.from_coo(*_coo(), n=N_V, **CPU)


def make_plans(k=6, seed=7, n=N_V, pkg="port"):
    eb, up = (edgebatch, updates) if pkg == "port" else (j_eb, j_up)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        ib = eb.from_arrays(rng.integers(0, n, 12), rng.integers(0, n, 12),
                            rng.random(12).astype(np.float32))
        db = eb.from_arrays(rng.integers(0, n, 6), rng.integers(0, n, 6))
        out.append(up.plan_update(inserts=ib, deletes=db))
    return out


def _trees(g):
    return {s: {k: np.asarray(v) for k, v in t.items()} for s, t in g.state_trees().items()}


def assert_sharded_parity(g, twin, *, state=None):
    """Content bit for bit: the gathered CSR streams and the exact
    (unweighted small-integer) walk; and every shard's ``state_trees()``
    unless ``state`` is False (a side re-sharded: another layout)."""
    ca, cb = dist.gather_csr(g), dist.gather_csr(twin)
    for f in ("offsets", "dst", "wgt"):
        x, y = getattr(ca, f).numpy(), getattr(cb, f).numpy()
        if f != "offsets":
            x, y = x[: ca.m], y[: cb.m]
        np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(g.reverse_walk(3).numpy(), twin.reverse_walk(3).numpy())
    if state is None:
        state = g.generation == twin.generation == 0
    if state:
        ta, tb = _trees(g), _trees(twin)
        assert sorted(ta) == sorted(tb)
        for s in ta:
            for k in ta[s]:
                np.testing.assert_array_equal(ta[s][k], tb[s][k], err_msg=f"shard {s}: {k}")


# ---------------------------------------------------------------------------
# the crash matrix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("point", CRASH_POINTS)
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("diff", [False, True])
def test_sharded_crash_matrix(base_csr, tmp_path, point, n_shards, diff):
    """Crash at every pipeline point × shard width × checkpoint kind;
    parallel owner-routed replay must reproduce the uncrashed twin."""
    wd, cd = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    g = durable.DurableGraph(dist.shard_csr(base_csr, n_shards, **CPU), wd, cd, diff=diff,
                             full_every=4)
    twin = dist.shard_csr(base_csr, n_shards, **CPU)
    plans = make_plans(6, seed=29)
    kcrash = 3
    faultinject.arm(point, after=kcrash)
    try:
        for i, p in enumerate(plans):
            g.apply(p)
            if i == 1:
                g.checkpoint()  # mid-stream snapshot (diff or full)
    except faultinject.SimulatedCrash:
        pass
    else:
        raise AssertionError("crash point never fired")
    finally:
        faultinject.disarm(point)
    # pre_append dies before the record is durable; the post_* points die
    # after it — the twin must replay exactly the durable prefix
    upto = kcrash if point == "durable.pre_append" else kcrash + 1
    for p in plans[:upto]:
        twin.apply(p)
    g2 = durable.DurableGraph.recover(wd, cd, parallel=True, diff=diff, **CPU)
    assert g2.rep_name == "sharded" and g2.seq == upto
    assert_sharded_parity(g2.rep, twin)
    faultinject.audit(g2.rep)


@pytest.mark.parametrize("point", CRASH_POINTS)
@pytest.mark.parametrize("rep_name", ["digraph", "lazy"])
def test_single_device_diff_crash_matrix(base_csr, tmp_path, point, rep_name):
    """The single-device matrix, rerun over differential checkpoints
    (hash-compare dirty detection)."""
    wd, cd = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    g = durable.DurableGraph(T.REPRESENTATIONS[rep_name].from_csr(base_csr, **CPU), wd, cd,
                             diff=True, full_every=3)
    twin = T.REPRESENTATIONS[rep_name].from_csr(base_csr, **CPU)
    plans = make_plans(6, seed=41)
    kcrash = 3
    faultinject.arm(point, after=kcrash)
    try:
        for i, p in enumerate(plans):
            g.apply(p)
            if i in (0, 2):
                g.checkpoint()  # two diff steps on the chain
    except faultinject.SimulatedCrash:
        pass
    else:
        raise AssertionError("crash point never fired")
    finally:
        faultinject.disarm(point)
    upto = kcrash if point == "durable.pre_append" else kcrash + 1
    for p in plans[:upto]:
        twin, _ = twin.apply(p)
    g2 = durable.DurableGraph.recover(wd, cd, diff=True, **CPU)
    c1, c2 = g2.to_csr(), twin.to_csr()
    for f in ("offsets", "dst", "wgt"):
        x, y = getattr(c1, f).numpy(), getattr(c2, f).numpy()
        if f != "offsets":
            x, y = x[: c1.m], y[: c2.m]
        np.testing.assert_array_equal(x, y, err_msg=f)
    faultinject.audit(g2.rep)


# ---------------------------------------------------------------------------
# group commit
# ---------------------------------------------------------------------------
def test_group_commit_one_flush_per_round(base_csr, tmp_path):
    g = durable.DurableGraph(dist.shard_csr(base_csr, 2, **CPU), str(tmp_path / "w"),
                             str(tmp_path / "c"))
    twin = dist.shard_csr(base_csr, 2, **CPU)
    plans = make_plans(9, seed=53)
    for r in range(3):
        round_plans = plans[3 * r: 3 * r + 3]
        f0 = g.journal.flushes
        assert g.apply_group(round_plans) == (g, 0)  # a ShardedGraph reports no ΔM
        assert g.journal.flushes - f0 == 1
        for p in round_plans:
            twin.apply(p)
    assert g.seq == 9  # seqs are contiguous and individually framed
    g2 = durable.DurableGraph.recover(str(tmp_path / "w"), str(tmp_path / "c"), parallel=True,
                                      **CPU)
    assert_sharded_parity(g2.rep, twin)


def test_group_commit_empty_and_filtered(base_csr, tmp_path):
    g = durable.DurableGraph(T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU),
                             str(tmp_path / "w"), str(tmp_path / "c"))
    _, dm = g.apply_group([])
    assert dm == 0 and g.seq == 0
    empty = updates.plan_update()
    g.apply_group([empty, empty])
    assert g.seq == 0 and g.journal.flushes == 0


def test_torn_group_commit_tail(base_csr, tmp_path):
    """Tear bytes off a group's suffix: recovery keeps the complete record
    prefix (never acked past it) and stays bit-identical."""
    wd, cd = str(tmp_path / "w"), str(tmp_path / "c")
    g = durable.DurableGraph(dist.shard_csr(base_csr, 2, **CPU), wd, cd)
    twin = dist.shard_csr(base_csr, 2, **CPU)
    plans = make_plans(6, seed=61)
    g.apply_group(plans[:3])
    for p in plans[:3]:
        twin.apply(p)
    g.apply_group(plans[3:])  # this group's tail gets torn
    g.close()
    faultinject.tear_tail(g.journal.segments()[-1], 17)  # into the last payload
    g2 = durable.DurableGraph.recover(wd, cd, parallel=True, **CPU)
    for p in plans[3:5]:  # records 4, 5 survived; record 6 was torn off
        twin.apply(p)
    assert g2.seq == 5
    assert_sharded_parity(g2.rep, twin)
    g2.rep.audit()


# ---------------------------------------------------------------------------
# parallel replay semantics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_plans", [3, 8])
def test_parallel_matches_serial_replay(base_csr, tmp_path, n_plans):
    """Parallel and serial replay agree bit for bit: every slot of every
    shard while no shard overflows (3 plans), the content and the walk
    once one does (8 plans: each replay re-shards at its own point, as the
    live stream did at its own)."""
    wd, cd = str(tmp_path / "w"), str(tmp_path / "c")
    g = durable.DurableGraph(dist.shard_csr(base_csr, 4, **CPU), wd, cd)
    for p in make_plans(n_plans, seed=67):
        g.apply(p)
    gp = durable.DurableGraph.recover(wd, cd, parallel=True, **CPU)
    gs = durable.DurableGraph.recover(wd, cd, parallel=False, **CPU)
    assert gp.seq == gs.seq == n_plans
    assert (gp.rep.generation == 0) == (n_plans == 3)
    assert_sharded_parity(gp.rep, gs.rep)
    assert_sharded_parity(gs.rep, g.rep, state=True)  # serial replay retraces the stream


def test_parallel_replay_growth_epochs(base_csr, tmp_path):
    """Growth records fence the fan-out: records after a growth see the
    re-sharded geometry, exactly like the live path."""
    wd, cd = str(tmp_path / "w"), str(tmp_path / "c")
    g = durable.DurableGraph(dist.shard_csr(base_csr, 2, **CPU), wd, cd)
    twin = dist.shard_csr(base_csr, 2, **CPU)
    gb = edgebatch.from_arrays(np.array([N_V + 9, 5]), np.array([5, N_V + 9]),
                               np.ones(2, np.float32))
    stream = (make_plans(2, seed=71) + [updates.plan_update(inserts=gb)]
              + make_plans(2, seed=73, n=N_V + 10))
    for p in stream:
        g.apply(p)
        twin.apply(p)
    g2 = durable.DurableGraph.recover(wd, cd, parallel=True, **CPU)
    assert g2.rep.n == twin.n == N_V + 10
    assert_sharded_parity(g2.rep, twin)


def test_recover_stats_surface(base_csr, tmp_path):
    wd, cd = str(tmp_path / "w"), str(tmp_path / "c")
    g = durable.DurableGraph(dist.shard_csr(base_csr, 2, **CPU), wd, cd)
    for p in make_plans(4, seed=79):
        g.apply(p)
    stats = {}
    durable.DurableGraph.recover(wd, cd, parallel=True, stats=stats, **CPU)
    assert stats["records"] == 4
    assert stats["restore_s"] >= 0 and stats["replay_s"] >= 0


# ---------------------------------------------------------------------------
# differential checkpoints through the wrapper
# ---------------------------------------------------------------------------
def test_diff_chain_compacts_to_full(base_csr, tmp_path):
    """full_every bounds the chain: every k-th snapshot re-anchors."""
    wd, cd = str(tmp_path / "w"), str(tmp_path / "c")
    g = durable.DurableGraph(dist.shard_csr(base_csr, 2, **CPU), wd, cd, diff=True,
                             full_every=2)
    for p in make_plans(6, seed=83):
        g.apply(p)
        g.checkpoint()
    kinds = [ckpt._read_manifest(ckpt._step_dir(cd, s)).get("kind", "full")
             for s in ckpt.all_steps(cd)]
    assert "diff" in kinds and kinds.count("full") >= 2
    for s in ckpt.all_steps(cd):  # every step on disk is a complete restore point
        trees, _ = ckpt.restore_arrays_diff(cd, step=s)
        assert set(trees) == {0, 1}


def test_diff_dirty_hints_shrink_payload(base_csr, tmp_path):
    """Tracked sharded diffs persist far less than the full state."""
    wd, cd = str(tmp_path / "w"), str(tmp_path / "c")
    g = durable.DurableGraph(dist.shard_csr(base_csr, 4, **CPU), wd, cd, diff=True,
                             full_every=8)
    full_bytes = sum(sum(np.asarray(v).nbytes for v in t.values())
                     for t in g.rep.state_trees().values())
    ib = edgebatch.from_arrays(np.array([1, 2]), np.array([3, 4]), np.ones(2, np.float32))
    g.apply(updates.plan_update(inserts=ib))  # one tiny plan → one diff step
    path = g.checkpoint()
    man = ckpt._read_manifest(path)
    assert man["kind"] == "diff"
    diff_bytes = sum(b.get("diff_bytes", 0) for b in man["shards"].values())
    assert 0 < diff_bytes < full_bytes / 2
    clean = [s for s in man["shards"] if man["shards"][s]["diff_bytes"] == 0
             and not os.path.exists(os.path.join(path, f"shard_{s}.npz"))]
    assert len(clean) >= 2  # untouched shards persisted nothing
    g2 = durable.DurableGraph.recover(wd, cd, diff=True, **CPU)
    assert_sharded_parity(g2.rep, g.rep, state=True)


def test_post_recovery_checkpoint_is_full(base_csr, tmp_path):
    """Replay applies are untracked → the next snapshot re-anchors."""
    wd, cd = str(tmp_path / "w"), str(tmp_path / "c")
    g = durable.DurableGraph(dist.shard_csr(base_csr, 2, **CPU), wd, cd, diff=True,
                             full_every=8)
    for p in make_plans(3, seed=89):
        g.apply(p)
    g2 = durable.DurableGraph.recover(wd, cd, diff=True, full_every=8, **CPU)
    assert ckpt._read_manifest(g2.checkpoint())["kind"] == "full"


# ---------------------------------------------------------------------------
# the port against repro
# ---------------------------------------------------------------------------
def _stream(pkg, root, n_shards=4):
    """One durable stream of ``pkg`` over a sharded graph: a step-0 full
    checkpoint, two plans, a tracked differential step, two plans in one
    group commit, then a crash at ``durable.post_append`` on the sixth.
    Returns (wal dir, ckpt dir, the five plans the uncrashed twin applies)."""
    dur, fi = (durable, faultinject) if pkg == "port" else (j_dur, j_fi)
    if pkg == "port":
        g0 = dist.shard_csr(csr.from_coo(*_coo(), n=N_V, **CPU), n_shards, **CPU)
    else:
        g0 = j_dist.shard_csr(j_csr.from_coo(*_coo(), n=N_V), n_shards)
    wal, ck = str(root / "wal"), str(root / "ckpt")
    plans = make_plans(6, seed=97, pkg=pkg)
    g = dur.DurableGraph(g0, wal, ck, diff=True, segment_bytes=1024)
    for p in plans[:2]:
        g.apply(p)
    g.checkpoint()
    g.apply_group(plans[2:4])
    g.apply(plans[4])
    fi.arm("durable.post_append")
    try:
        g.apply(plans[5])
    except fi.SimulatedCrash:
        pass
    else:
        raise AssertionError("crash point never fired")
    finally:
        fi.disarm()
    g.close()
    return wal, ck, plans


def test_durable_files_identical_across_packages(tmp_path):
    """The same sharded stream leaves the same WAL segments and the same
    step directories (manifests byte for byte, the tracked diff too)."""
    dirs = {pkg: _stream(pkg, tmp_path / pkg)[:2] for pkg in ("repro", "port")}
    for i, what in enumerate(("wal", "ckpt")):
        files = {}
        for pkg, paths in dirs.items():
            root = pathlib.Path(paths[i])
            files[pkg] = {str(p.relative_to(root)): p.read_bytes()
                          for p in sorted(root.rglob("*")) if p.is_file()
                          and (what == "wal" or p.name == "manifest.json")}
        assert len(files["port"]) >= 2, what
        assert files["port"] == files["repro"], what
    for s in ckpt.all_steps(dirs["port"][1]):
        a, _ = ckpt.restore_arrays_diff(dirs["port"][1], step=s)
        b, _ = ckpt.restore_arrays_diff(dirs["repro"][1], step=s)
        for sid in a:
            for k in a[sid]:
                np.testing.assert_array_equal(a[sid][k], b[sid][k], err_msg=f"{s}/{sid}/{k}")


@pytest.mark.parametrize("writer,reader", [("repro", "port"), ("port", "repro")])
def test_crash_recovers_across_packages(writer, reader, tmp_path):
    """``writer``'s durable sharded stream, crashed after a tracked diff
    step and a group commit, recovered by ``reader``: bit for bit against
    ``writer``'s uncrashed twin."""
    wal, ck, plans = _stream(writer, tmp_path)
    if writer == "port":
        tw = dist.shard_csr(csr.from_coo(*_coo(), n=N_V, **CPU), 4, **CPU)
    else:
        tw = j_dist.shard_csr(j_csr.from_coo(*_coo(), n=N_V), 4)
    for p in plans:
        tw.apply(p)
    if reader == "port":
        r = durable.DurableGraph.recover(wal, ck, parallel=True, diff=True, **CPU)
    else:
        r = j_dur.DurableGraph.recover(wal, ck, parallel=True, diff=True)
    assert r.rep_name == "sharded" and r.seq == 6
    ta, tb = r.rep.state_trees(), tw.state_trees()
    for s in tb:
        for k in tb[s]:
            x, y = np.asarray(ta[s][k]), np.asarray(tb[s][k])
            assert x.dtype == y.dtype and x.shape == y.shape, (s, k)
            np.testing.assert_array_equal(x, y, err_msg=f"shard {s}: {k}")
    np.testing.assert_array_equal(np.asarray(r.reverse_walk(3)), np.asarray(tw.reverse_walk(3)))
    r.close()


def test_parallel_replay_uses_a_thread_per_touched_shard(base_csr, tmp_path, monkeypatch):
    """The parallel replay drains each touched shard on a pool thread."""
    import threading

    wd, cd = str(tmp_path / "w"), str(tmp_path / "c")
    g = durable.DurableGraph(dist.shard_csr(base_csr, 4, **CPU), wd, cd)
    for p in make_plans(3, seed=101):
        g.apply(p)
    seen = set()
    flush = T.WalkImage.flush

    def spy(self, **kw):
        seen.add(threading.current_thread().name)
        return flush(self, **kw)

    monkeypatch.setattr(T.WalkImage, "flush", spy)
    r = durable.DurableGraph.recover(wd, cd, parallel=True, **CPU)
    assert threading.main_thread().name not in seen and len(seen) >= 2
    assert_sharded_parity(r.rep, g.rep, state=True)


def test_parallel_replay_stress_matches_serial(tmp_path):
    """Eight shard threads (more than the cores a test worker has) replay
    under a very short switch interval: the result is the serial replay's,
    bit for bit on every slot."""
    import sys

    c = csr.from_coo(*_coo(), n=N_V, **CPU)
    wd, cd = str(tmp_path / "w"), str(tmp_path / "c")
    g = durable.DurableGraph(dist.shard_csr(c, 8, **CPU), wd, cd)
    for p in make_plans(4, seed=103):
        g.apply(p)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        gp = durable.DurableGraph.recover(wd, cd, parallel=True, **CPU)
    finally:
        sys.setswitchinterval(old)
    gs = durable.DurableGraph.recover(wd, cd, parallel=False, **CPU)
    assert gp.rep.generation == gs.rep.generation == 0
    assert_sharded_parity(gp.rep, gs.rep, state=True)
