"""Serving a graph on a mesh in the port (``runtime.serve.WalkServer`` over a
``ShardedGraph`` / sharded ``DurableGraph`` whose ``mesh`` is set: rank 0
serves, the other ranks follow through ``launch.mesh.Channel``), on the CPU.

``repro``'s side runs once per module in a subprocess with 4 forced host
devices (its single-controller ``WalkServer`` over ``shard_csr(c, 4,
mesh=host_mesh(4))``) and the port's once per module as 4 gloo ranks through
``run_ranks(device="cpu")``; a second, short run of the port's ranks has a
collective timeout of a few seconds and idles past it.  Both runs carry
deadlines, so a mismatched collective fails instead of hanging.

The scripted sequence is one closed loop (every ticket waited for before
the next is submitted), driven through three servers: ``repro``'s, the
port's on the mesh (rank 0 drives it) and the port's local mode.  Part A
serves a ``ShardedGraph``: walks at B = 1 and B = 3, an acked update, a
walk.  Part B serves a sharded ``DurableGraph``: an acked update, a walk
whose ``shard.walk`` fault fires on shard 0 (the first shard in ``repro``
and in local mode, rank 0's in the port) and its degraded retry, an update
while degraded, ``rebuild_shard(0)`` through ``run_on_writer``, a walk.
The graph is unweighted and small, so the visits are exact integers in f32
and every comparison is bit for bit: visits, generations, coverage, down
shards, each update's ΔM and the deterministic counters.

Besides: concurrent walks and updates from several threads on rank 0 (zero
lost, no torn read, every rank's shard equal to local mode's after the
acked plans in ``seq`` order); faults on rank 0 and on followers; a paced
audit catching a corrupted shard; a follower out of step; the follower
API; and, in a third short run, a follower that dies while serving.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
import threading
import time
import traceback

import numpy as np
import pytest
import torch

from repro_torch.core import csr, distributed as dist, edgebatch, updates
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve as launch_serve
from repro_torch.runtime import durable, faultinject, serve as serve_mod

STEPS = 4
S = 4
#: seconds the ranks and the subprocess may take (each ~5-30 s here)
DEADLINE = 300
#: the main run's collective timeout: a mismatched collective fails fast
COLLECTIVE_S = 60
#: the idle run's collective timeout, and how long rank 0 idles (past it)
IDLE_TIMEOUT_S, IDLE_S = 4, 10
#: seconds a closed-loop ticket may take
WAIT_S = 60
#: the concurrent scenario's submitting threads (more than the 8 cores of
#: the hosts this runs on)
SUBMITTERS = 12
CPU = {"device": "cpu"}
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TESTS = os.path.dirname(os.path.abspath(__file__))

#: the scripted sequence's walks (seed lists, one ticket each)
W1 = [[1, 5]]
W3 = [[2], [3, 3, 7], [30]]
W_AFTER = [[4, 9]]
W_FAULT = [[6, 11]]
W_REBUILT = [[6, 11], [0, 36]]
#: the counters every server of the script must agree on
COUNTERS = ("served", "updates_applied", "seals", "shard_quarantines",
            "dispatch_retries", "admin_ops")


@pytest.fixture(autouse=True)
def _port_faultinject_leak_guard():
    """``tests/conftest.py`` guards ``repro``'s registry only: a test that
    leaves a port fault armed fails here instead of leaking it."""
    faultinject.disarm()
    yield
    leaked = faultinject.armed()
    faultinject.disarm()
    assert not leaked, f"test leaked armed port fault points: {leaked}"


def _canonical(plan) -> dict:
    return {"q_src": plan.q_src, "q_dst": plan.q_dst, "q_wgt": plan.q_wgt, "q_del": plan.q_del}


def _inputs() -> dict:
    """The script graph (n = 37, m = 260, unweighted) and its three plans;
    the concurrent scenario's graph (n = 600, m = 2,700)."""
    rng = np.random.default_rng(11)
    n, m = 37, 260
    out = {"n": np.int64(n), "src": rng.integers(0, n, m), "dst": rng.integers(0, n, m)}
    for name in ("a", "b1", "b2"):
        plan = updates.plan_update(
            edgebatch.from_arrays(rng.integers(0, n, 12), rng.integers(0, n, 12),
                                  np.ones(12, np.float32)),
            edgebatch.from_arrays(rng.integers(0, n, 6), rng.integers(0, n, 6)))
        out.update({f"plan_{name}/{k}": v for k, v in _canonical(plan).items()})
    rng = np.random.default_rng(12)
    out["big_n"] = np.int64(600)
    out["big_src"], out["big_dst"] = rng.integers(0, 600, 2700), rng.integers(0, 600, 2700)
    return out


def _script_csr(inp, device="cpu"):
    n = int(inp["n"])
    return csr.from_coo(inp["src"], inp["dst"], np.ones(inp["src"].shape[0], np.float32), n=n,
                        device=device)


def _big_csr(inp, device="cpu"):
    n = int(inp["big_n"])
    return csr.from_coo(inp["big_src"], inp["big_dst"],
                        np.ones(inp["big_src"].shape[0], np.float32), n=n, device=device)


def _plan(inp, name, mod=updates):
    return mod.plan_from_canonical(*(inp[f"plan_{name}/{k}"]
                                     for k in ("q_src", "q_dst", "q_wgt", "q_del")))


# ---------------------------------------------------------------------------
# the scripted sequence: one closed loop for every server (either package's)
# ---------------------------------------------------------------------------
def _walks(srv, seed_lists) -> list:
    tickets = [srv.submit_walk(s, steps=STEPS, timeout=WAIT_S) for s in seed_lists]
    for t in tickets:
        assert t.wait(WAIT_S), "walk ticket still pending"
    return [(_host(t.result()), t.generation, t.coverage, tuple(t.down_shards))
            for t in tickets]


def _host(x) -> np.ndarray:
    """A host copy of either package's visits (a tensor or a jax array)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _update(srv, plan) -> tuple:
    t = srv.submit_update(plan)
    dm = t.result(WAIT_S)
    return int(dm), t.generation


def _wait_until(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def drive_a(srv, plan) -> dict:
    """Part A: walks at B = 1 and B = 3, an acked update, a walk."""
    return {"w1": _walks(srv, W1), "w3": _walks(srv, W3), "u": _update(srv, plan),
            "w_after": _walks(srv, W_AFTER)}


def drive_b(srv, plans, arm_walk_fault, rebuild) -> dict:
    """Part B: an acked update; a walk whose ``shard.walk`` fault (armed
    by ``arm_walk_fault``) quarantines shard 0 and whose retry is served
    degraded; an update while degraded; ``rebuild`` through
    ``run_on_writer`` with a reseal; a walk at full coverage."""
    out = {"u1": _update(srv, plans[0])}
    arm_walk_fault()
    out["w_fault"] = _walks(srv, W_FAULT)
    out["u2"] = _update(srv, plans[1])
    out["records"] = srv.run_on_writer(rebuild, reseal=True).result(WAIT_S)
    _wait_until(lambda: srv.stats()["coverage"] == 1.0, "never resealed at full coverage")
    out["w_rebuilt"] = _walks(srv, W_REBUILT)
    return out


def counters(stats) -> dict:
    return {k: int(stats[k]) for k in COUNTERS}


def rebuild_on_writer(srv, sid: int) -> int:
    """An admin function every rank can run: rebuild shard ``sid``."""
    return srv.rep.rebuild_shard(sid)


def raise_on_rank(srv, rank: int) -> int:
    """An admin function that raises on one rank only."""
    if srv.rep.mesh.rank == rank:
        raise RuntimeError(f"admin fails on rank {rank}")
    return srv.rep.mesh.rank


SERVER_A = {"batch_max": 4}
#: part B's retry pause leaves ``repro``'s and local mode's writer time to
#: reseal degraded first (on the mesh the retry waits for that round)
SERVER_B = {"batch_max": 4, "dispatch_retries": 4, "retry_backoff": 0.5}
#: the mesh's part B retries at once, and rank 0's writer starts each round
#: late (``late_rounds``): its degraded retry rests on no race
SERVER_B_MESH = dict(SERVER_B, retry_backoff=0.0)
LATE_ROUND_S = 0.2


# ---------------------------------------------------------------------------
# the port's side: one rank program, every scenario
# ---------------------------------------------------------------------------
def late_rounds(srv):
    """Start each of ``srv``'s writer rounds ``LATE_ROUND_S`` late, so a
    batch retried at once after a shard fault runs before the round that
    quarantines the shard unless the retry waits for that round."""
    inner = srv._writer_round

    def late():
        time.sleep(LATE_ROUND_S)
        return inner()

    srv._writer_round = late
    return srv


def _serve(srv, mesh, drive):
    """Start ``srv`` on every rank; rank 0 runs ``drive(srv)`` and stops,
    the others follow until it does.  -> (rank 0's drive output or None,
    the final stats)."""
    srv.start()
    out = None
    try:
        if mesh.rank == 0:
            out = drive(srv)
    finally:
        stats = srv.stop(timeout=WAIT_S)
    return out, stats


def _script(mesh, inp, work):
    g = dist.shard_csr(_script_csr(inp), S, mesh=mesh)
    res = {}
    # the follower API, before anything is served
    srv = serve_mod.WalkServer(g, **SERVER_A)
    if mesh.rank == 0:
        try:
            srv.run_on_writer(lambda s: 0)
        except TypeError as e:
            res["lambda"] = str(e)
    else:
        res["refused"] = []
        for call in (lambda: srv.submit_walk([1]), lambda: srv.submit_update(_plan(inp, "a")),
                     lambda: srv.run_on_writer(functools.partial(raise_on_rank, rank=0))):
            try:
                call()
            except RuntimeError as e:
                res["refused"].append(str(e))
    res["a"], stats = _serve(srv, mesh, lambda s: drive_a(s, _plan(inp, "a")))
    res["a_counters"], res["a_ops"] = counters(stats), srv.op_counts()
    res["a_generation"] = srv.generation.gen_id
    res["stopped_a"] = True
    dg = durable.DurableGraph(dist.shard_csr(_script_csr(inp), S, mesh=mesh),
                              os.path.join(work, "script_wal"), os.path.join(work, "script_ck"))
    srv = serve_mod.WalkServer(dg, **SERVER_B_MESH)
    if mesh.rank == 0:
        late_rounds(srv)
    res["b"], stats = _serve(srv, mesh, lambda s: drive_b(
        s, [_plan(inp, "b1"), _plan(inp, "b2")],
        lambda: faultinject.arm("shard.walk", times=1),
        functools.partial(rebuild_on_writer, sid=0)))
    faultinject.disarm()
    res["b_counters"], res["b_ops"] = counters(stats), srv.op_counts()
    res["b_generation"], res["b_down"] = srv.generation.gen_id, sorted(dg.rep.down)
    res["b_tree"] = dg.rep.state_trees()[mesh.rank]
    dg.close()
    return res


def _traffic(srv, inp):
    """Walks and updates from more submitting threads than cores at once,
    the interpreter switching threads often."""
    threads = SUBMITTERS
    out = [None] * threads

    def submit(i):
        out[i] = launch_serve.run_traffic(srv, int(inp["big_n"]), requests=6, steps=3,
                                          seeds_per_request=3, update_every=3, update_size=24,
                                          seed=100 + i)

    ts = [threading.Thread(target=submit, args=(i,)) for i in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts), "a submitting thread is still running"
    walks = [w for ws, _ in out for w in ws]
    upds = [u for _, us in out for u in us]
    for t in walks + [u for u, _ in upds]:
        assert t.wait(WAIT_S), "ticket still pending"
    return walks, upds


def _concurrent(mesh, inp):
    g = dist.shard_csr(_big_csr(inp), S, mesh=mesh)
    oracle = launch_serve.GenerationOracle(dist.gather_csr(g))
    srv = serve_mod.WalkServer(g, batch_max=8)
    res = {}

    def drive(s):
        walks, upds = _traffic(s, inp)
        return walks, upds

    out, stats = _serve(srv, mesh, drive)
    if mesh.rank == 0:
        walks, upds = out
        srv.assert_no_lost()
        res["torn"] = launch_serve.count_torn_reads(oracle, walks, upds)
        res["acked"] = sorted((u.seq, _canonical(p)) for u, p in upds
                              if u.status == serve_mod.SERVED)
        res["stats"] = stats
    res["tree"] = g.state_trees()[mesh.rank]
    res["generation"] = g.generation
    return res


def _faults(mesh, inp):
    """``serve.dispatch`` on rank 0, ``shard.patch`` on rank 3, an admin
    function raising on rank 2; then a walk, served."""
    g = dist.shard_csr(_script_csr(inp), S, mesh=mesh)
    srv = serve_mod.WalkServer(g, batch_max=4, dispatch_retries=2, retry_backoff=0.01)
    if mesh.rank == 3:
        faultinject.arm("shard.patch", times=1)

    def drive(s):
        res = {}
        faultinject.arm("serve.dispatch", times=1)
        res["dispatch"] = _walks(s, W1)
        res["dispatch_stats"] = counters(s.stats())
        res["patch_dm"] = _update(s, _plan(inp, "a"))
        _wait_until(lambda: s.stats()["coverage"] < 1.0, "never resealed degraded")
        res["patch_walk"] = _walks(s, W1)
        t = s.run_on_writer(functools.partial(raise_on_rank, rank=2))
        assert t.wait(WAIT_S)
        res["admin"] = (t.status, repr(t.error))
        res["after"] = _walks(s, W_AFTER)
        return res

    try:
        out, stats = _serve(srv, mesh, drive)
    finally:
        fired = {p: faultinject.fired(p) for p in ("serve.dispatch", "shard.patch")}
        faultinject.disarm()
    if mesh.rank == 0:
        srv.assert_no_lost()
    return {"out": out, "stats": stats, "fired": fired, "down": sorted(g.down)}


def _audits(mesh, inp):
    """``audit_every=1`` with a ``shard.corrupt`` fault on rank 1: the update
    routed to shard 1 flips one of its weights, the paced audit catches it."""
    g = dist.shard_csr(_script_csr(inp), S, mesh=mesh)
    g.enable_integrity()
    lo, hi = g.owned_range(1)
    plan = updates.plan_update(edgebatch.from_arrays(np.arange(lo, hi), np.arange(hi - lo),
                                                     np.ones(hi - lo, np.float32)))
    srv = serve_mod.WalkServer(g, batch_max=4, audit_every=1)
    if mesh.rank == 1:
        faultinject.arm("shard.corrupt", times=1)

    def drive(s):
        res = {"u": _update(s, plan)}
        _wait_until(lambda: s.stats()["audit_detections"] > 0, "the audit never detected")
        _wait_until(lambda: s.stats()["coverage"] < 1.0, "never resealed degraded")
        res["walk"] = _walks(s, W1)
        return res

    try:
        out, stats = _serve(srv, mesh, drive)
    finally:
        fired = faultinject.fired("shard.corrupt")
        faultinject.disarm()
    return {"out": out, "stats": stats, "fired": fired, "down": sorted(g.down),
            "routed": [s for s, _ in dist.route_updates(plan, S, g.rows_max)]}


def _desync(mesh, inp):
    """Rank 2 holds generation 1 under another id: the walk on it fails
    on every rank (retried, then failed visibly on rank 0), and the ranks
    serve again once the next seal puts them back in step."""
    g = dist.shard_csr(_script_csr(inp), S, mesh=mesh)
    srv = serve_mod.WalkServer(g, batch_max=4, dispatch_retries=1, retry_backoff=0.01)
    if mesh.rank == 2:
        inner = srv._op_seal

        def skewed(gen_id):
            img = inner(gen_id)
            if gen_id == 1:
                srv._generation = dataclasses.replace(srv._generation, gen_id=99)
            return img

        srv._op_seal = skewed

    def drive(s):
        res = {"u1": _update(s, _plan(inp, "a"))}
        t = s.submit_walk(W1[0], steps=STEPS)
        assert t.wait(WAIT_S)
        res["skewed"] = (t.status, t.generation, repr(t.error))
        res["u2"] = _update(s, _plan(inp, "b1"))
        res["after"] = _walks(s, W1)
        return res

    out, stats = _serve(srv, mesh, drive)
    return {"out": out, "stats": stats, "ops": srv.op_counts()}


def _channel(mesh):
    """``Channel.agree``: a result stays on its rank; ranks 1 and 3 raise
    and every rank raises rank 1's error."""
    chan = mesh_mod.Channel(mesh)
    res = {"own": chan.agree(lambda: mesh.rank * 10)}

    def fail():
        if mesh.rank in (1, 3):
            raise ValueError(f"rank {mesh.rank} fails")
        return mesh.rank

    try:
        chan.agree(fail)
    except ValueError as e:
        res["raised"] = (str(e), e is chan.last_error)
    if chan.leader:
        chan.send(("walk", {"gen": 3}))
        res["header"] = None
    else:
        res["header"] = chan.recv()
    res["counts"], res["beat_s"] = dict(chan.counts), chan.beat_s
    return res


def _port_rank(mesh, inputs_path: str, work: str) -> dict:
    """Every scenario on this rank; a scenario that raised reports its
    traceback instead of its results (its peers raised the same)."""
    inp = dict(np.load(inputs_path))
    out = {"rank": mesh.rank}
    for key, fn in (("script", lambda: _script(mesh, inp, work)),
                    ("concurrent", lambda: _concurrent(mesh, inp)),
                    ("faults", lambda: _faults(mesh, inp)),
                    ("audits", lambda: _audits(mesh, inp)),
                    ("desync", lambda: _desync(mesh, inp)),
                    ("channel", lambda: _channel(mesh))):
        t0 = time.monotonic()
        try:
            out[key] = fn()
        except Exception:  # noqa: BLE001 - reported per scenario
            out[key] = {"error": traceback.format_exc()}
        out[key + "_s"] = time.monotonic() - t0
    return out


def _idle_rank(mesh, inputs_path: str) -> dict:
    """Rank 0 walks, idles past the collective timeout and walks again; the
    followers wait in their loop throughout."""
    inp = dict(np.load(inputs_path))
    g = dist.shard_csr(_script_csr(inp), S, mesh=mesh)
    srv = serve_mod.WalkServer(g, batch_max=4)

    def drive(s):
        first = _walks(s, W1)
        time.sleep(IDLE_S)
        return first + _walks(s, W1)

    out, stats = _serve(srv, mesh, drive)
    return {"rank": mesh.rank, "walks": out, "ops": srv.op_counts(), "served": stats["served"],
            "timeout_s": mesh_mod.collective_timeout_s(mesh)}


def _dying_rank(mesh, inputs_path: str, work: str):
    """Rank 3 dies while the others serve.  Rank 0 writes its report to a
    file, since its rank then fails (its last barrier has a dead peer); the
    other followers write how their loop ended and wait for that report."""
    import pickle

    inp = dict(np.load(inputs_path))
    g = dist.shard_csr(_script_csr(inp), S, mesh=mesh)
    srv = serve_mod.WalkServer(g, batch_max=4, dispatch_retries=1, retry_backoff=0.01)
    srv.start()
    flag, report = os.path.join(work, "die"), os.path.join(work, "dying_report.pkl")
    if mesh.rank == S - 1:
        while not os.path.exists(flag):
            time.sleep(0.01)
        os._exit(0)
    if mesh.rank:
        try:
            srv.stop()
            ended = "stopped"
        except RuntimeError as e:
            ended = f"{e} ({e.__cause__!r})"
        with open(os.path.join(work, f"follower_{mesh.rank}.txt"), "w") as f:
            f.write(ended)
        _wait_until(lambda: os.path.exists(report), "rank 0 wrote no report")
        return None
    out = {"first": _walks(srv, W1)[0][1:]}
    open(flag, "w").close()
    time.sleep(1.0)
    t0 = time.monotonic()
    t = srv.submit_walk(W1[0], steps=STEPS)
    assert t.wait(WAIT_S)
    out["failed"] = (t.status, repr(t.error), time.monotonic() - t0)
    try:
        srv.stop(timeout=WAIT_S)
    except RuntimeError as e:
        out["stop"] = repr(e)
    out["stats"] = srv.assert_no_lost()
    with open(report + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(report + ".tmp", report)
    return out


# ---------------------------------------------------------------------------
# repro's side: its WalkServer over the shard_map mesh on 4 host devices
# ---------------------------------------------------------------------------
REPRO_SCRIPT = textwrap.dedent(
    """
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path[:0] = [sys.argv[3], sys.argv[4]]
    import jax
    import numpy as np
    import test_torch_mesh_serve as T
    from repro.core import csr as csr_mod, distributed as dist, updates
    from repro.launch import mesh as mesh_mod
    from repro.runtime import durable, faultinject, serve

    assert len(jax.devices()) == 4
    mesh = mesh_mod.host_mesh(4)
    inp, work = dict(np.load(sys.argv[1])), os.path.dirname(sys.argv[2])

    def graph():
        c = csr_mod.from_coo(inp["src"], inp["dst"], np.ones(inp["src"].shape[0], np.float32),
                             n=int(inp["n"]))
        return dist.shard_csr(c, 4, mesh=mesh)

    res = {}
    srv = serve.WalkServer(graph(), **T.SERVER_A).start()
    try:
        res["a"] = T.drive_a(srv, T._plan(inp, "a", updates))
    finally:
        res["a_counters"] = T.counters(srv.stop())
    res["a_generation"] = srv.generation.gen_id
    dg = durable.DurableGraph(graph(), os.path.join(work, "repro_wal"),
                              os.path.join(work, "repro_ck"))
    srv = serve.WalkServer(dg, **T.SERVER_B).start()
    try:
        res["b"] = T.drive_b(srv, [T._plan(inp, "b1", updates), T._plan(inp, "b2", updates)],
                             lambda: faultinject.arm("shard.walk", times=1),
                             lambda s: dg.rebuild_shard(0))
    finally:
        faultinject.disarm()
        res["b_counters"] = T.counters(srv.stop())
    res["b_generation"], res["b_down"] = srv.generation.gen_id, sorted(dg.rep.down)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(res, f)
    """
)


def _local_script(inp, work, device="cpu") -> dict:
    """The scripted sequence through the port's local-mode server."""
    res = {}
    srv = serve_mod.WalkServer(dist.shard_csr(_script_csr(inp, device), S, device=device),
                               **SERVER_A).start()
    try:
        res["a"] = drive_a(srv, _plan(inp, "a"))
    finally:
        res["a_counters"] = counters(srv.stop())
    res["a_generation"] = srv.generation.gen_id
    dg = durable.DurableGraph(dist.shard_csr(_script_csr(inp, device), S, device=device),
                              os.path.join(work, "local_wal"), os.path.join(work, "local_ck"))
    srv = serve_mod.WalkServer(dg, **SERVER_B).start()
    try:
        res["b"] = drive_b(srv, [_plan(inp, "b1"), _plan(inp, "b2")],
                           lambda: faultinject.arm("shard.walk", times=1),
                           functools.partial(rebuild_on_writer, sid=0))
    finally:
        faultinject.disarm()
        res["b_counters"] = counters(srv.stop())
    res["b_generation"], res["b_down"] = srv.generation.gen_id, sorted(dg.rep.down)
    res["b_trees"] = dg.rep.state_trees()
    dg.close()
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, repro's script, local mode's script, every rank's results,
    every idle rank's results)."""
    import pickle

    work = str(tmp_path_factory.mktemp("mesh_serve"))
    inputs = os.path.join(work, "inputs.npz")
    inp = _inputs()
    np.savez(inputs, **inp)
    script = os.path.join(work, "repro_side.py")
    with open(script, "w") as f:
        f.write(REPRO_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, script, inputs, os.path.join(work, "repro.pkl"),
         os.path.join(REPO, "src"), TESTS],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
    try:
        ranks = mesh_mod.run_ranks(_port_rank, S, args=(inputs, work), device="cpu",
                                   init_dir=work, timeout=DEADLINE,
                                   collective_timeout=COLLECTIVE_S)
        idle = mesh_mod.run_ranks(_idle_rank, S, args=(inputs,), device="cpu", init_dir=work,
                                  timeout=DEADLINE, collective_timeout=IDLE_TIMEOUT_S)
        local = _local_script(inp, work)
        out, err = proc.communicate(timeout=DEADLINE)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"repro's side failed:\n{out}\n{err}"
    with open(os.path.join(work, "repro.pkl"), "rb") as f:
        rep = pickle.load(f)
    return inp, rep, local, ranks, idle


def _scenario(ranks, key):
    for r in ranks:
        assert "error" not in r[key], f"rank {r['rank']}: {r[key]['error']}"
    return [r[key] for r in ranks]


def _same_walks(got, want, what):
    assert len(got) == len(want), what
    for i, ((v, gen, cov, down), (v2, gen2, cov2, down2)) in enumerate(zip(got, want)):
        assert v.dtype == np.float32 and v2.dtype == np.float32, what
        np.testing.assert_array_equal(v, v2, err_msg=f"{what}[{i}] visits")
        assert (gen, cov, down) == (gen2, cov2, down2), f"{what}[{i}]"


def _same_script(got, want, what):
    for part, keys in (("a", ("w1", "w3", "w_after")), ("b", ("w_fault", "w_rebuilt"))):
        for k in keys:
            _same_walks(got[part][k], want[part][k], f"{what}: {part}/{k}")
    assert got["a"]["u"] == want["a"]["u"], what
    assert (got["b"]["u1"], got["b"]["u2"], got["b"]["records"]) == \
        (want["b"]["u1"], want["b"]["u2"], want["b"]["records"]), what
    for k in ("a_counters", "b_counters", "a_generation", "b_generation", "b_down"):
        assert got[k] == want[k], f"{what}: {k}"


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.mark.timeout(DEADLINE * 3)
@pytest.mark.parametrize("against", ["repro", "local"])
def test_mesh_script_bit_for_bit(runs, against):
    """Rank 0's responses, ΔMs, generations and counters equal ``repro``'s
    mesh server's and the port's local mode's, bit for bit."""
    _, rep, local, ranks, _ = runs
    want = rep if against == "repro" else local
    _same_script(_scenario(ranks, "script")[0], want, f"mesh vs {against}")


@pytest.mark.timeout(DEADLINE * 3)
def test_script_exercises_what_it_claims(runs):
    """The script's part B degrades and recovers: the faulted walk served
    at coverage < 1 on a degraded generation, two WAL records rebuilt, and
    the walks after the rebuild at full coverage; part A's B = 3 walks are
    distinct rows."""
    _, rep, _, ranks, _ = runs
    got = _scenario(ranks, "script")[0]
    (_, gen, cov, down), = got["b"]["w_fault"]
    assert cov < 1.0 and down == (0,) and gen == got["b"]["u1"][1] + 1
    assert got["b"]["records"] == 2 and got["b_down"] == []
    assert all(c == 1.0 and d == () for _, _, c, d in got["b"]["w_rebuilt"])
    assert got["b_counters"] == {"served": 3, "updates_applied": 2, "seals": 5,
                                 "shard_quarantines": 1, "dispatch_retries": 1, "admin_ops": 1}
    assert got["a_counters"] == {"served": 5, "updates_applied": 1, "seals": 2,
                                 "shard_quarantines": 0, "dispatch_retries": 0, "admin_ops": 0}
    rows = [v for v, _, _, _ in got["a"]["w3"]]
    assert len({r.tobytes() for r in rows}) == 3 and all(r.any() for r in rows)
    assert got["a"]["u"][0] != 0  # ΔM read off the mesh's all_sum
    assert rep["a"]["u"] == got["a"]["u"]


@pytest.mark.timeout(DEADLINE * 3)
def test_every_rank_ran_every_op(runs):
    """The followers received exactly the ops rank 0 sent, and the rebuilt
    graph's shards equal local mode's."""
    _, _, local, ranks, _ = runs
    res = _scenario(ranks, "script")
    for part in ("a", "b"):
        ops = [r[f"{part}_ops"] for r in res]
        want = {k: v for k, v in ops[0].items() if k != "beat"}
        for r, o in enumerate(ops):
            assert {k: v for k, v in o.items() if k != "beat"} == want, f"rank {r}: {part}"
        assert want["stop"] == 1 and want["walk"] >= 1 and want["seal"] >= 2
    assert ops[0]["admin"] == 1 and ops[0]["quarantine"] == 1 and ops[0]["apply"] == 2
    for r, x in enumerate(res):
        assert x["b_generation"] == res[0]["b_generation"]
        for k, v in local["b_trees"][r].items():
            np.testing.assert_array_equal(x["b_tree"][k], v, err_msg=f"rank {r}: {k}")


@pytest.mark.timeout(DEADLINE * 3)
def test_follower_api(runs):
    """``submit_*`` and ``run_on_writer`` on a follower raise, naming rank 0;
    a lambda on a mesh raises ``TypeError``; ``stop()`` returns on every
    rank."""
    _, _, _, ranks, _ = runs
    res = _scenario(ranks, "script")
    assert "pickle by reference" in res[0]["lambda"]
    for r, x in enumerate(res):
        assert x["stopped_a"]
        if r:
            assert len(x["refused"]) == 3
            for msg in x["refused"]:
                assert f"rank {r} follows rank 0" in msg


@pytest.mark.timeout(DEADLINE * 3)
def test_concurrent_traffic(runs):
    """More submitting threads than cores on rank 0: zero lost, no torn
    read, and every rank's shard equal to local mode's after the acked
    plans in ``seq`` order."""
    inp, _, _, ranks, _ = runs
    res = _scenario(ranks, "concurrent")
    torn, checked = res[0]["torn"]
    stats = res[0]["stats"]
    assert torn == 0 and checked == stats["served"] == 6 * SUBMITTERS and stats["failed"] == 0
    seqs = [s for s, _ in res[0]["acked"]]
    assert seqs == list(range(1, len(seqs) + 1))
    assert stats["updates_applied"] == len(seqs) == 2 * SUBMITTERS
    local = dist.shard_csr(_big_csr(inp), S, **CPU)
    for _, p in res[0]["acked"]:
        local.apply(updates.plan_from_canonical(p["q_src"], p["q_dst"], p["q_wgt"], p["q_del"]))
    trees = local.state_trees()
    for r, x in enumerate(res):
        assert x["generation"] == local.generation
        for k, v in trees[r].items():
            np.testing.assert_array_equal(x["tree"][k], v, err_msg=f"rank {r}: {k}")


@pytest.mark.timeout(DEADLINE * 3)
def test_faults_on_rank0_and_followers(runs):
    """``serve.dispatch`` on rank 0 is retried; ``shard.patch`` on rank 3
    quarantines shard 3 on every rank and the walks after it are degraded;
    an admin function raising on rank 2 fails its ticket visibly; the walk
    after all three is served."""
    _, _, _, ranks, _ = runs
    res = _scenario(ranks, "faults")
    out = res[0]["out"]
    assert res[0]["fired"]["serve.dispatch"] == 1
    assert out["dispatch_stats"]["dispatch_retries"] == 1 and out["dispatch"][0][2] == 1.0
    assert res[3]["fired"]["shard.patch"] == 1
    assert all(x["down"] == [3] for x in res)
    (_, _, cov, down), = out["patch_walk"]
    assert cov < 1.0 and down == (3,)
    assert out["admin"][0] == serve_mod.FAILED and "admin fails on rank 2" in out["admin"][1]
    assert out["after"][0][3] == (3,)
    assert res[0]["stats"]["failed"] == 0 and res[0]["stats"]["admin_ops"] == 0
    assert res[0]["stats"]["shard_quarantines"] == 1


@pytest.mark.timeout(DEADLINE * 3)
def test_audit_catches_a_corrupted_shard(runs):
    _, _, _, ranks, _ = runs
    res = _scenario(ranks, "audits")
    assert res[1]["fired"] == 1 and res[1]["routed"] == [1]
    stats = res[0]["stats"]
    assert stats["audit_detections"] == 1 and stats["shard_quarantines"] == 1
    assert all(x["down"] == [1] for x in res)
    (_, _, cov, down), = res[0]["out"]["walk"]
    assert cov < 1.0 and down == (1,)


@pytest.mark.timeout(DEADLINE * 3)
def test_a_rank_out_of_step_fails_the_walk_visibly(runs):
    """A follower whose sealed generation has another id than rank 0's
    raises, on every rank: the ticket is retried, then fails visibly, and
    nothing hangs; after the next seal the ranks serve again."""
    _, _, _, ranks, _ = runs
    res = _scenario(ranks, "desync")
    out = res[0]["out"]
    status, gen, err = out["skewed"]
    assert status == serve_mod.FAILED and gen is None
    assert "rank 2 holds sealed generation 99 where rank 0 walks generation 1" in err
    assert out["after"][0][1] == 2 and out["after"][0][0].any()
    stats = res[0]["stats"]
    assert (stats["failed"], stats["dispatch_retries"], stats["served"]) == (1, 1, 1)
    for x in res:
        assert x["ops"]["walk"] == 3 and x["ops"]["stop"] == 1


@pytest.mark.timeout(DEADLINE * 3)
def test_channel_agrees_on_the_lowest_failing_rank(runs):
    _, _, _, ranks, _ = runs
    res = _scenario(ranks, "channel")
    for r, x in enumerate(res):
        assert x["own"] == 10 * r
        assert x["raised"] == ("rank 1 fails", True)
        assert x["header"] == (None if r == 0 else ("walk", {"gen": 3}))
        assert x["counts"] == {"walk": 1} and x["beat_s"] == COLLECTIVE_S / 4


@pytest.mark.timeout(DEADLINE)
def test_a_dead_follower_fails_rank0s_tickets_visibly(tmp_path):
    """Rank 3 dies while serving: rank 0's next walk fails within the
    collective timeout (once retried), visibly; ``assert_no_lost`` holds;
    the other followers' loops end with an error instead of hanging."""
    import pickle

    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, **_inputs())
    with pytest.raises(RuntimeError):
        mesh_mod.run_ranks(_dying_rank, S, args=(inputs, str(tmp_path)), device="cpu",
                           init_dir=str(tmp_path), timeout=DEADLINE,
                           collective_timeout=IDLE_TIMEOUT_S)
    with open(tmp_path / "dying_report.pkl", "rb") as f:
        out = pickle.load(f)
    assert out["first"] == (0, 1.0, ())
    status, err, took = out["failed"]
    assert status == serve_mod.FAILED and took < 2 * IDLE_TIMEOUT_S + 2, out["failed"]
    stats = out["stats"]
    assert (stats["served"], stats["failed"], stats["dispatch_retries"]) == (1, 1, 1)
    for r in (1, 2):
        ended = (tmp_path / f"follower_{r}.txt").read_text()
        assert f"rank {r} stopped following rank 0" in ended, ended


@pytest.mark.timeout(DEADLINE * 3)
def test_followers_survive_an_idle_server(runs):
    """Rank 0 idles for longer than the collective timeout: the heartbeat
    keeps the followers in their loop and the walk after it is served."""
    _, _, _, _, idle = runs
    assert all(x["timeout_s"] == IDLE_TIMEOUT_S for x in idle)
    assert IDLE_S > 2 * IDLE_TIMEOUT_S
    walks = idle[0]["walks"]
    assert idle[0]["served"] == 2
    np.testing.assert_array_equal(walks[0][0], walks[1][0])
    for x in idle:
        assert x["ops"]["beat"] >= IDLE_S / IDLE_TIMEOUT_S and x["ops"]["stop"] == 1


def test_lambda_is_fine_in_local_mode(tmp_path):
    """``run_on_writer`` takes any callable when the graph is not on a
    mesh, and the port's ``UpdateTicket`` numbers each apply."""
    g = dist.shard_csr(_script_csr(_inputs()), S, **CPU)
    srv = serve_mod.WalkServer(g).start()
    try:
        assert srv.run_on_writer(lambda s: s.rep is g).result(WAIT_S) is True
        u = srv.submit_update(_plan(_inputs(), "a"))
        u.result(WAIT_S)
        assert u.seq == 1 and srv.op_counts() == {}
    finally:
        srv.stop(timeout=WAIT_S)


def test_a_quarantine_requested_before_stop_is_sealed():
    """The writer drains a pending quarantine before it exits: the server
    stopped right after the request still ends on a degraded generation."""
    g = dist.shard_csr(_script_csr(_inputs()), S, **CPU)
    srv = serve_mod.WalkServer(g).start()
    try:
        srv.request_quarantine(1)
    finally:
        stats = srv.stop(timeout=WAIT_S)
    assert g.down == {1}
    assert stats["shard_quarantines"] == 1 and stats["down_shards"] == (1,)
    assert stats["coverage"] < 1.0 and stats["seals"] == 2
