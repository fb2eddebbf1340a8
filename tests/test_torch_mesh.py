"""The sharded graph on a mesh in the port (``repro_torch.launch.mesh``,
``make_sharded_walk``, ``ShardedGraph`` / ``DurableGraph`` in mesh mode), on
the CPU.

``repro``'s side runs once per module in a subprocess with 4 forced host
devices (as ``tests/test_distributed.py``'s shard_map test does) and the
port's once per module as 4 gloo ranks through ``run_ranks(device="cpu")``;
both read the same numpy inputs, and each test below reads their results.
Both runs carry deadlines, and every collective a finite timeout, so a
mismatched collective fails instead of hanging.

The walks are unweighted on graphs small enough that the visits are exact
integers in f32, so every comparison is bit for bit: the mesh walk against
``repro``'s shard_map walk, the port's local mode and the single image
walk, at B = 1 and B = 3.  Besides: the exchange's byte count against the
frontier model and ``repro``'s jaxpr count; a routed apply (one
``fused_apply`` on each rank that was routed a subplan, none on the
others) and ``gather_csr`` against ``_host_apply`` and ``repro``; the
growth re-shard; an overflow on one rank re-sharding every rank; a
``shard.walk`` fault on one rank raised on every rank, the degraded walk
and ``rebuild_shard``; checkpoints across the two modes; ``recover(mesh=)``
after a crash.
"""
import os
import subprocess
import sys
import textwrap
import traceback

import numpy as np
import pytest
import torch

from repro_torch.core import csr, distributed as dist, edgebatch, updates
from repro_torch.core.walk_image import WalkImage
from repro_torch.kernels.slot_walk import sharded as sw_sharded
from repro_torch.launch import mesh as mesh_mod
from repro_torch.runtime import durable, faultinject

STEPS = 4
S = 4
#: seconds the ranks and the subprocess may take (each ~5-30 s here)
DEADLINE = 300
CPU = {"device": "cpu"}
GRAPHS = ("script", "hub")
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _inputs() -> dict:
    """Both graphs' numpy inputs: ``repro``'s script graph (n = 37, m = 260,
    seed 11, and its 24-op plan drawn after it) and a graph whose row 5 is a
    hub of 300 edges (several 128-slot tiles); a B = 3 batch and the growth
    plan (n + 6 -> 1, 2 -> n + 6) for each."""
    out = {}
    rng = np.random.default_rng(11)
    n, m = 37, 260
    g = {"src": rng.integers(0, n, m), "dst": rng.integers(0, n, m),
         "w": rng.random(m).astype(np.float32)}
    g.update(ins_src=rng.integers(0, n, 24), ins_dst=rng.integers(0, n, 24),
             ins_w=rng.random(24).astype(np.float32))
    out["script"] = (n, g)
    rng = np.random.default_rng(12)
    n, m, hub = 600, 2400, 300
    g = {"src": np.concatenate([rng.integers(0, n, m), np.full(hub, 5)]),
         "dst": np.concatenate([rng.integers(0, n, m), rng.choice(n, hub, replace=False)]),
         "w": rng.random(m + hub).astype(np.float32)}
    g.update(ins_src=rng.integers(0, n, 24), ins_dst=rng.integers(0, n, 24),
             ins_w=rng.random(24).astype(np.float32))
    out["hub"] = (n, g)
    flat = {}
    for name, (n, g) in out.items():
        g["n"] = np.int64(n)
        g["v0"] = np.random.default_rng(13).integers(0, 3, (3, n)).astype(np.float32)
        g["grow_src"], g["grow_dst"] = np.array([n + 6, 2]), np.array([1, n + 6])
        g["grow_w"] = np.ones(2, np.float32)
        flat.update({f"{name}/{k}": v for k, v in g.items()})
    return flat


def _graph(inp, name):
    a = {k.split("/", 1)[1]: v for k, v in inp.items() if k.startswith(name + "/")}
    return int(a["n"]), a


def _plan(src, dst, w):
    """A plan inserting (src, dst, w)."""
    return updates.plan_update(edgebatch.from_arrays(src, dst, w), None)


def _csr(n, a):
    return csr.from_coo(a["src"], a["dst"], a["w"], n=n, **CPU)


def _overflow_plans():
    """``tests/test_torch_distributed.py``'s grown-row case: rows 0-2 (all
    on shard 0 of 4) each gain 11 edges, so only shard 0 overflows."""
    hub = np.arange(1, 12, dtype=np.int64)
    return [_plan(np.zeros_like(hub) + (rep % 3), (hub + rep) % 12, np.ones(11, np.float32))
            for rep in range(6)]


def _overflow_csr():
    rng = np.random.default_rng(4)
    return csr.from_coo(rng.integers(0, 12, 40), rng.integers(0, 12, 40),
                        rng.random(40).astype(np.float32), n=12, **CPU)


def _recover_plans(n):
    rng = np.random.default_rng(7)
    return [updates.plan_update(
        edgebatch.from_arrays(rng.integers(0, n, 12), rng.integers(0, n, 12),
                              rng.random(12).astype(np.float32)),
        edgebatch.from_arrays(rng.integers(0, n, 6), rng.integers(0, n, 6)))
        for _ in range(3)]


def _own_tree(g):
    return {k: np.asarray(v) for k, v in g.state_trees()[g.mesh.rank].items()}


# ---------------------------------------------------------------------------
# the port's side: one rank program, every scenario
# ---------------------------------------------------------------------------
def _walks(mesh, inp, name):
    from repro_torch.kernels.slot_update import ops as su_ops

    n, a = _graph(inp, name)
    g = dist.shard_csr(_csr(n, a), S, mesh=mesh)
    held = [s for s, img in enumerate(g.shards) if img is not None]
    res = {"held": held, "rows_max": g.rows_max}
    res["walk1"] = g.reverse_walk(STEPS).numpy()
    res["walk3"] = g.reverse_walk(STEPS, visits0=torch.from_numpy(a["v0"])).numpy()
    ex0 = dict(sw_sharded.EXCHANGE)
    res["bytes1"] = g.collective_bytes_per_step(STEPS)
    res["bytes3"] = g.collective_bytes_per_step(STEPS, nwalks=3)
    res["exchange_steps"] = sw_sharded.EXCHANGE["steps"] - ex0["steps"]
    plan = _plan(a["ins_src"], a["ins_dst"], a["ins_w"])
    inner, calls = su_ops.fused_apply, []
    su_ops.fused_apply = lambda *x, **k: calls.append(1) or inner(*x, **k)
    try:
        g.apply(plan)
    finally:
        su_ops.fused_apply = inner
    res["fused_applies"], res["apply_generation"] = len(calls), g.generation
    gc = dist.gather_csr(g)
    res["gather"] = (gc.offsets.numpy(), gc.dst[: gc.m].numpy(), gc.wgt[: gc.m].numpy())
    res["plan_walk1"] = g.reverse_walk(STEPS).numpy()
    g.apply(_plan(a["grow_src"], a["grow_dst"], a["grow_w"]))
    res["grow"] = (g.n, g.rows_max, g.generation, g.mesh is mesh)
    res["grow_walk1"] = g.reverse_walk(STEPS).numpy()
    return res


def _overflow(mesh):
    from repro_torch.core import walk_image

    g = dist.shard_csr(_overflow_csr(), S, mesh=mesh)
    inner, flushed = walk_image.WalkImage.flush, []

    def spy(img):
        ok = inner(img)
        flushed.append(bool(ok))
        return ok

    walk_image.WalkImage.flush = spy
    gens = []
    try:
        for plan in _overflow_plans():
            g.apply(plan)
            gens.append(g.generation)
            g.audit()
    finally:
        walk_image.WalkImage.flush = inner
    gc = dist.gather_csr(g)
    return {"gens": gens, "flushed": flushed, "walk": g.reverse_walk(STEPS).numpy(),
            "gather": (gc.offsets.numpy(), gc.dst[: gc.m].numpy(), gc.wgt[: gc.m].numpy())}


def _fault(mesh, inp, work):
    n, a = _graph(inp, "script")
    g = dist.shard_csr(_csr(n, a), S, mesh=mesh)
    dg = durable.DurableGraph(g, os.path.join(work, "fault_wal"), os.path.join(work, "fault_ck"))
    res = {}
    if mesh.rank == 2:
        faultinject.arm("shard.walk", times=1)
    try:
        g.reverse_walk(STEPS)
    except dist.ShardFaultError as e:
        res["raised"] = (type(e).__name__, e.sid, e.stage)
    finally:
        faultinject.disarm()
    g.quarantine(2)
    res["coverage"], res["down_rows"] = g.coverage, g.down_rows()
    res["degraded1"] = g.reverse_walk(STEPS).numpy()
    res["degraded3"] = g.reverse_walk(STEPS, visits0=torch.from_numpy(a["v0"])).numpy()
    dg.apply(_plan(a["ins_src"], a["ins_dst"], a["ins_w"]))
    res["spooled"] = len(g.spooled(2))
    res["records"] = dg.rebuild_shard(2)
    res["down_after"], res["coverage_after"] = sorted(g.down), g.coverage
    res["rebuilt_walk1"] = g.reverse_walk(STEPS).numpy()
    gc = dg.to_csr()
    res["gather"] = (gc.offsets.numpy(), gc.dst[: gc.m].numpy(), gc.wgt[: gc.m].numpy())
    dg.close()
    return res


def _checkpoints(mesh, inp, work):
    n, a = _graph(inp, "hub")
    g = dist.shard_csr(_csr(n, a), S, mesh=mesh)
    res = {"saved_tree": _own_tree(g), "saved_walk": g.reverse_walk(STEPS).numpy()}
    res["path"] = g.save(os.path.join(work, "mesh_ck"), 3)
    r = dist.ShardedGraph.restore(os.path.join(work, "local_ck"), mesh=mesh)
    res["restored_held"] = [s for s, img in enumerate(r.shards) if img is not None]
    res["restored_tree"], res["restored_walk"] = _own_tree(r), r.reverse_walk(STEPS).numpy()
    return res


def _recover(mesh, inp, work):
    n, a = _graph(inp, "script")
    wal, ck = os.path.join(work, "rec_wal"), os.path.join(work, "rec_ck")
    plans = _recover_plans(n)
    g = dist.shard_csr(_csr(n, a), S, mesh=mesh)
    twin = dist.shard_csr(_csr(n, a), S, mesh=mesh)
    dg = durable.DurableGraph(g, wal, ck, diff=True)
    dg.apply(plans[0])
    res = {"diff_path": dg.checkpoint()}
    dg.apply(plans[1])
    faultinject.arm("durable.post_append", times=1)
    try:
        dg.apply(plans[2])
    except faultinject.SimulatedCrash as e:
        res["crashed"] = e.point
    finally:
        faultinject.disarm()
    dg.close()
    for p in plans:
        twin.apply(p)
    st = {}
    r = durable.DurableGraph.recover(wal, ck, mesh=mesh, diff=True, stats=st)
    res.update(records=st["records"], seq=r.seq, rep_name=r.rep_name,
               tree=_own_tree(r.rep), twin_tree=_own_tree(twin),
               walk=r.reverse_walk(STEPS).numpy(), twin_walk=twin.reverse_walk(STEPS).numpy())
    r.close()
    return res


def _port_rank(mesh, inputs_path: str, work: str) -> dict:
    """Every scenario on this rank; a scenario that raised reports its
    traceback instead of its results (its peers raised the same)."""
    inp = dict(np.load(inputs_path))
    out = {"rank": mesh.rank, "backend": mesh.backend, "axes": mesh_mod.data_axes(mesh)}
    scenarios = [(f"walks/{name}", lambda name=name: _walks(mesh, inp, name)) for name in GRAPHS]
    scenarios += [("overflow", lambda: _overflow(mesh)),
                  ("fault", lambda: _fault(mesh, inp, work)),
                  ("checkpoints", lambda: _checkpoints(mesh, inp, work)),
                  ("recover", lambda: _recover(mesh, inp, work))]
    for key, fn in scenarios:
        try:
            out[key] = fn()
        except Exception:  # noqa: BLE001 - reported per scenario
            out[key] = {"error": traceback.format_exc()}
    return out


# ---------------------------------------------------------------------------
# repro's side: the shard_map program on 4 forced host devices
# ---------------------------------------------------------------------------
REPRO_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[3])
    import jax
    import numpy as np
    from repro.core import csr as csr_mod, distributed as dist, edgebatch, updates
    from repro.launch import mesh as mesh_mod

    assert len(jax.devices()) == 4
    mesh = mesh_mod.host_mesh(4)
    inp, out, STEPS = dict(np.load(sys.argv[1])), {}, 4
    for name in ("script", "hub"):
        a = {k.split("/", 1)[1]: v for k, v in inp.items() if k.startswith(name + "/")}
        n = int(a["n"])
        g = dist.shard_csr(csr_mod.from_coo(a["src"], a["dst"], a["w"], n=n), 4, mesh=mesh)
        out[name + "/walk1"] = np.asarray(g.reverse_walk(STEPS))
        out[name + "/walk3"] = np.asarray(g.reverse_walk(STEPS, visits0=a["v0"]))
        out[name + "/bytes1"] = g.collective_bytes_per_step(STEPS)
        out[name + "/bytes3"] = g.collective_bytes_per_step(STEPS, nwalks=3)
        g.apply(updates.plan_update(edgebatch.from_arrays(a["ins_src"], a["ins_dst"],
                                                          a["ins_w"]), None))
        gc = dist.gather_csr(g)
        m = int(np.asarray(gc.offsets)[-1])
        out[name + "/offsets"] = np.asarray(gc.offsets)
        out[name + "/dst"] = np.asarray(gc.dst)[:m]
        out[name + "/wgt"] = np.asarray(gc.wgt)[:m]
        out[name + "/plan_walk1"] = np.asarray(g.reverse_walk(STEPS))
        g.apply(updates.plan_update(edgebatch.from_arrays(a["grow_src"], a["grow_dst"],
                                                          a["grow_w"]), None))
        out[name + "/grow_n"] = g.n
        out[name + "/grow_walk1"] = np.asarray(g.reverse_walk(STEPS))
    np.savez(sys.argv[2], **out)
    """
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, repro's results, every rank's results, the work directory)."""
    work = str(tmp_path_factory.mktemp("mesh"))
    inputs = os.path.join(work, "inputs.npz")
    inp = _inputs()
    np.savez(inputs, **inp)
    # the local-mode step the ranks restore onto the mesh
    n, a = _graph(inp, "hub")
    dist.shard_csr(_csr(n, a), S, **CPU).save(os.path.join(work, "local_ck"), 2)
    script = os.path.join(work, "repro_side.py")
    with open(script, "w") as f:
        f.write(REPRO_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, script, inputs, os.path.join(work, "repro.npz"),
         os.path.join(REPO, "src")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
    try:
        ranks = mesh_mod.run_ranks(_port_rank, S, args=(inputs, work), device="cpu",
                                   init_dir=work, timeout=DEADLINE)
        out, err = proc.communicate(timeout=DEADLINE)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"repro's side failed:\n{out}\n{err}"
    return inp, dict(np.load(os.path.join(work, "repro.npz"))), ranks, work


def _scenario(ranks, key):
    for r in ranks:
        assert "error" not in r[key], f"rank {r['rank']}: {r[key]['error']}"
    return [r[key] for r in ranks]


def _local(inp, name):
    n, a = _graph(inp, name)
    return dist.shard_csr(_csr(n, a), S, **CPU)


def _single_walk(c, steps=STEPS, visits0=None):
    img = WalkImage.from_csr_arrays(np.asarray(c.offsets), np.asarray(c.dst)[: c.m],
                                    np.asarray(c.wgt)[: c.m], c.n, **CPU)
    v0 = None if visits0 is None else torch.from_numpy(visits0)
    return img.walk(steps, visits0=v0).numpy()


def _host_oracle(n, a, plans, n_new):
    c = _csr(n, a)
    o = c.offsets.numpy()
    s, d, w = np.repeat(np.arange(n), np.diff(o)), c.dst.numpy(), c.wgt.numpy()
    for p in plans:
        s, d, w = dist._host_apply(s, d, w, p)
    return csr.from_coo(s, d, w, n=n_new, dedup=False, **CPU)


def _same_gather(got, want):
    for x, y, f in zip(got, want, ("offsets", "dst", "wgt")):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.mark.timeout(DEADLINE * 2)
def test_ranks_and_transport(runs):
    _, _, ranks, _ = runs
    assert [r["rank"] for r in ranks] == list(range(S))
    assert {r["backend"] for r in ranks} == {"gloo"}
    assert {r["axes"] for r in ranks} == {("data",)}
    assert mesh_mod.transport(S, "cpu") == "gloo"
    assert mesh_mod.transport(S, "cuda:0") == "gloo"  # ranks sharing one card


@pytest.mark.timeout(DEADLINE * 2)
@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("b", [1, 3])
def test_mesh_walk_bit_for_bit(runs, name, b):
    """Every rank's walk = ``repro``'s shard_map walk = the port's local mode
    = the single image walk, bit for bit."""
    inp, rep, ranks, _ = runs
    res = _scenario(ranks, f"walks/{name}")
    n, a = _graph(inp, name)
    v0 = torch.from_numpy(a["v0"]) if b == 3 else None
    local = _local(inp, name).reverse_walk(STEPS, visits0=v0).numpy()
    single = _single_walk(_csr(n, a), visits0=a["v0"] if b == 3 else None)
    np.testing.assert_array_equal(local, single)
    np.testing.assert_array_equal(rep[f"{name}/walk{b}"], local)
    for r, x in enumerate(res):
        assert x["held"] == [r]  # one shard a rank, nothing of the others
        assert x[f"walk{b}"].dtype == np.float32 and x[f"walk{b}"].shape == local.shape
        np.testing.assert_array_equal(x[f"walk{b}"], local, err_msg=f"rank {r}")


@pytest.mark.timeout(DEADLINE * 2)
@pytest.mark.parametrize("name", GRAPHS)
def test_collective_bytes_match_model_and_repro(runs, name):
    _, rep, ranks, _ = runs
    for x in _scenario(ranks, f"walks/{name}"):
        assert x["bytes1"] == sw_sharded.model_bytes_per_step(S, x["rows_max"], 0)
        assert x["bytes3"] == sw_sharded.model_bytes_per_step(S, x["rows_max"], 3)
        assert x["bytes1"] == int(rep[f"{name}/bytes1"]) == (S - 1) * x["rows_max"] * 4
        assert x["bytes3"] == int(rep[f"{name}/bytes3"])
        assert x["exchange_steps"] == 2 * STEPS


@pytest.mark.timeout(DEADLINE * 2)
@pytest.mark.parametrize("name", GRAPHS)
def test_routed_apply_patches_each_rank_once(runs, name):
    """One ``fused_apply`` on each rank routed a subplan, none elsewhere;
    ``gather_csr`` (on every rank) = ``_host_apply`` = ``repro``'s."""
    inp, rep, ranks, _ = runs
    res = _scenario(ranks, f"walks/{name}")
    n, a = _graph(inp, name)
    plan = _plan(a["ins_src"], a["ins_dst"], a["ins_w"])
    routed = {s for s, _ in dist.route_updates(plan, S, res[0]["rows_max"])}
    assert 1 < len(routed) <= S
    want = _host_oracle(n, a, [plan], n)
    for r, x in enumerate(res):
        assert x["fused_applies"] == (1 if r in routed else 0), r
        assert x["apply_generation"] == 0  # patched in place, no re-shard
        _same_gather(x["gather"], (want.offsets, want.dst[: want.m], want.wgt[: want.m]))
        _same_gather(x["gather"], (rep[f"{name}/offsets"], rep[f"{name}/dst"],
                                   rep[f"{name}/wgt"]))
        np.testing.assert_array_equal(x["plan_walk1"], _single_walk(want))
        np.testing.assert_array_equal(x["plan_walk1"], rep[f"{name}/plan_walk1"])


@pytest.mark.timeout(DEADLINE * 2)
@pytest.mark.parametrize("name", GRAPHS)
def test_growth_reshards_on_the_mesh(runs, name):
    inp, rep, ranks, _ = runs
    n, a = _graph(inp, name)
    plan = _plan(a["ins_src"], a["ins_dst"], a["ins_w"])
    grow = _plan(a["grow_src"], a["grow_dst"], a["grow_w"])
    want = _host_oracle(n, a, [plan, grow], n + 7)
    local = _local(inp, name)
    local.apply(plan)
    local.apply(grow)
    for x in _scenario(ranks, f"walks/{name}"):
        assert x["grow"] == (n + 7, -(-(n + 7) // S), 1, True)
        assert int(rep[f"{name}/grow_n"]) == n + 7
        np.testing.assert_array_equal(x["grow_walk1"], _single_walk(want))
        np.testing.assert_array_equal(x["grow_walk1"], local.reverse_walk(STEPS).numpy())
        np.testing.assert_array_equal(x["grow_walk1"], rep[f"{name}/grow_walk1"])


@pytest.mark.timeout(DEADLINE * 2)
def test_overflow_on_one_rank_reshards_every_rank(runs):
    _, _, ranks, _ = runs
    res = _scenario(ranks, "overflow")
    local = dist.shard_csr(_overflow_csr(), S, **CPU)
    gens = []
    for plan in _overflow_plans():
        local.apply(plan)
        gens.append(local.generation)
    assert gens[-1] > 0
    # only rank 0's shard is routed anything, and only it overflows
    assert False in res[0]["flushed"]
    assert all(not x["flushed"] for x in res[1:])
    gc = dist.gather_csr(local)
    for x in res:
        assert x["gens"] == gens
        _same_gather(x["gather"], (gc.offsets, gc.dst[: gc.m], gc.wgt[: gc.m]))
        np.testing.assert_array_equal(x["walk"], local.reverse_walk(STEPS).numpy())


@pytest.mark.timeout(DEADLINE * 2)
def test_walk_fault_on_one_rank_raises_on_every_rank(runs):
    """A ``shard.walk`` fault armed on rank 2 alone: every rank raises
    ``ShardFaultError(2)``; the degraded walk reads exact zeros on shard 2's
    rows and equals local mode's; ``rebuild_shard(2)`` brings it back."""
    inp, _, ranks, _ = runs
    res = _scenario(ranks, "fault")
    n, a = _graph(inp, "script")
    local = _local(inp, "script")
    local.quarantine(2)
    plan = _plan(a["ins_src"], a["ins_dst"], a["ins_w"])
    want = _host_oracle(n, a, [plan], n)
    lo, hi = local.owned_range(2)
    for r, x in enumerate(res):
        assert x["raised"] == ("ShardFaultError", 2, "walk"), r
        assert x["coverage"] == local.coverage < 1.0
        np.testing.assert_array_equal(x["down_rows"], np.arange(lo, hi))
        for b, v0 in ((1, None), (3, torch.from_numpy(a["v0"]))):
            got = x[f"degraded{b}"]
            assert not got[..., lo:hi].any()
            np.testing.assert_array_equal(got, local.reverse_walk(STEPS, visits0=v0).numpy())
        assert x["spooled"] == (1 if r == 2 else 0)
        assert x["records"] == 1 and x["down_after"] == [] and x["coverage_after"] == 1.0
        np.testing.assert_array_equal(x["rebuilt_walk1"], _single_walk(want))
        _same_gather(x["gather"], (want.offsets, want.dst[: want.m], want.wgt[: want.m]))


@pytest.mark.timeout(DEADLINE * 2)
def test_checkpoint_saved_on_the_mesh_restores_in_local_mode(runs):
    inp, _, ranks, work = runs
    res = _scenario(ranks, "checkpoints")
    assert len({x["path"] for x in res}) == 1
    step_dir = res[0]["path"]
    assert sorted(os.listdir(step_dir)) == ["manifest.json"] + [f"shard_{s}.npz"
                                                                 for s in range(S)]
    g = dist.ShardedGraph.restore(os.path.join(work, "mesh_ck"), **CPU)
    trees = g.state_trees()
    for r, x in enumerate(res):
        for k, v in x["saved_tree"].items():
            np.testing.assert_array_equal(trees[r][k], v, err_msg=f"shard {r}: {k}")
        np.testing.assert_array_equal(g.reverse_walk(STEPS).numpy(), x["saved_walk"])
    # the same bytes local mode writes for the same graph
    local = os.path.join(work, "local_again")
    _local(inp, "hub").save(local, 3)
    with open(os.path.join(step_dir, "manifest.json"), "rb") as f, \
            open(os.path.join(local, "step_0000000003", "manifest.json"), "rb") as h:
        assert f.read() == h.read()


@pytest.mark.timeout(DEADLINE * 2)
def test_checkpoint_saved_in_local_mode_restores_on_the_mesh(runs):
    inp, _, ranks, work = runs
    res = _scenario(ranks, "checkpoints")
    local = _local(inp, "hub")
    trees = local.state_trees()
    for r, x in enumerate(res):
        assert x["restored_held"] == [r]
        for k, v in trees[r].items():
            np.testing.assert_array_equal(x["restored_tree"][k], v, err_msg=f"shard {r}: {k}")
        np.testing.assert_array_equal(x["restored_walk"], local.reverse_walk(STEPS).numpy())


@pytest.mark.timeout(DEADLINE * 2)
def test_recover_on_the_mesh_after_a_crash(runs):
    """A crash at ``durable.post_append`` (armed on every rank: the job
    dies), then ``recover(mesh=)``: every rank's shard bit for bit against
    an uncrashed twin on the mesh, and against local mode's recovery of the
    same directories."""
    inp, _, ranks, work = runs
    res = _scenario(ranks, "recover")
    local = durable.DurableGraph.recover(os.path.join(work, "rec_wal"),
                                         os.path.join(work, "rec_ck"), diff=True, **CPU)
    trees = local.rep.state_trees()
    import json

    with open(os.path.join(res[0]["diff_path"], "manifest.json")) as f:
        assert json.load(f)["kind"] == "diff"
    for r, x in enumerate(res):
        assert x["crashed"] == "durable.post_append"
        assert (x["records"], x["seq"], x["rep_name"]) == (2, 3, "sharded")
        for k, v in x["twin_tree"].items():
            np.testing.assert_array_equal(x["tree"][k], v, err_msg=f"rank {r}: {k}")
            np.testing.assert_array_equal(trees[r][k], v, err_msg=f"local, shard {r}: {k}")
        np.testing.assert_array_equal(x["walk"], x["twin_walk"])
        np.testing.assert_array_equal(x["walk"], local.reverse_walk(STEPS).numpy())
    local.close()


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------
def test_host_mesh_needs_its_ranks():
    with pytest.raises(ValueError, match="host_mesh: need 4 ranks, have 0"):
        mesh_mod.host_mesh(4, device="cpu")


def _raise_on_rank_one(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    return mesh.rank


@pytest.mark.timeout(DEADLINE)
def test_run_ranks_raises_a_ranks_error(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails"):
        mesh_mod.run_ranks(_raise_on_rank_one, 2, device="cpu", init_dir=str(tmp_path),
                           timeout=120)


# ---------------------------------------------------------------------------
# on the card: 4 ranks sharing one GPU over gloo
# ---------------------------------------------------------------------------
def _card_rank(mesh, inputs_path: str) -> dict:
    from repro_torch.kernels import KERNELS

    n, a = _graph(dict(np.load(inputs_path)), "hub")
    c = csr.from_coo(a["src"], a["dst"], a["w"], n=n, device=mesh.device)
    for k in KERNELS.values():
        k.launches = 0
    g = dist.shard_csr(c, S, mesh=mesh)
    out = {"walk1": g.reverse_walk(STEPS).cpu().numpy(),
           "walk3": g.reverse_walk(STEPS, visits0=torch.from_numpy(a["v0"])).cpu().numpy()}
    g.apply(_plan(a["ins_src"], a["ins_dst"], a["ins_w"]))
    gc = dist.gather_csr(g)
    out["gather"] = (gc.offsets.cpu().numpy(), gc.dst[: gc.m].cpu().numpy(),
                     gc.wgt[: gc.m].cpu().numpy())
    out["launches"] = {k: v.launches for k, v in KERNELS.items()}
    return out


@pytest.mark.gpu
@pytest.mark.timeout(DEADLINE)
def test_mesh_walk_on_the_card(tmp_path):
    """4 gloo ranks on ``cuda:0`` (the ``tile_cumsum`` and ``merge_rows_fused``
    kernels in every rank): the walks and the routed apply bit for bit
    against local mode on the same card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    inputs = str(tmp_path / "inputs.npz")
    inp = _inputs()
    np.savez(inputs, **inp)
    ranks = mesh_mod.run_ranks(_card_rank, S, args=(inputs,), device="cuda:0",
                               init_dir=str(tmp_path), timeout=DEADLINE)
    n, a = _graph(inp, "hub")
    local = dist.shard_csr(csr.from_coo(a["src"], a["dst"], a["w"], n=n, device="cuda"), S)
    want1 = local.reverse_walk(STEPS).cpu().numpy()
    want3 = local.reverse_walk(STEPS, visits0=torch.from_numpy(a["v0"]).cuda()).cpu().numpy()
    local.apply(_plan(a["ins_src"], a["ins_dst"], a["ins_w"]))
    gc = dist.gather_csr(local)
    for r, x in enumerate(ranks):
        np.testing.assert_array_equal(x["walk1"], want1, err_msg=f"rank {r}")
        np.testing.assert_array_equal(x["walk3"], want3, err_msg=f"rank {r}")
        _same_gather(x["gather"], (gc.offsets.cpu(), gc.dst[: gc.m].cpu(), gc.wgt[: gc.m].cpu()))
        assert x["launches"]["tile_cumsum"] == 2 * STEPS, r
    assert sum(x["launches"]["merge_rows_fused"] for x in ranks) > 0


def _card_serve_rank(mesh, inputs_path: str, work: str) -> dict:
    """The scripted sequence of ``tests/test_torch_mesh_serve.py`` on this
    rank's card: rank 0 drives, the others follow."""
    import functools

    import test_torch_mesh_serve as T
    from repro_torch.kernels import KERNELS
    from repro_torch.runtime import serve

    inp = dict(np.load(inputs_path))
    for k in KERNELS.values():
        k.launches = 0
    out = {}
    srv = serve.WalkServer(dist.shard_csr(T._script_csr(inp, mesh.device), S, mesh=mesh),
                           **T.SERVER_A)
    out["a"], stats = T._serve(srv, mesh, lambda s: T.drive_a(s, T._plan(inp, "a")))
    out["a_counters"], out["a_generation"] = T.counters(stats), srv.generation.gen_id
    dg = durable.DurableGraph(dist.shard_csr(T._script_csr(inp, mesh.device), S, mesh=mesh),
                              os.path.join(work, "serve_wal"), os.path.join(work, "serve_ck"))
    srv = serve.WalkServer(dg, **T.SERVER_B_MESH)
    if mesh.rank == 0:
        T.late_rounds(srv)
    out["b"], stats = T._serve(srv, mesh, lambda s: T.drive_b(
        s, [T._plan(inp, "b1"), T._plan(inp, "b2")],
        lambda: faultinject.arm("shard.walk", times=1),
        functools.partial(T.rebuild_on_writer, sid=0)))
    faultinject.disarm()
    out["b_counters"], out["b_generation"] = T.counters(stats), srv.generation.gen_id
    out["b_down"] = sorted(dg.rep.down)
    dg.close()
    out["launches"] = {k: v.launches for k, v in KERNELS.items()}
    return out


@pytest.mark.gpu
@pytest.mark.timeout(DEADLINE)
def test_mesh_serve_on_the_card(tmp_path):
    """4 gloo ranks on ``cuda:0`` serve ``tests/test_torch_mesh_serve.py``'s
    scripted sequence (rank 0's WalkServer, the others following) bit for
    bit against a local-mode server on the same card; every rank launches
    ``tile_cumsum``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import test_torch_mesh_serve as T

    inputs = str(tmp_path / "inputs.npz")
    inp = T._inputs()
    np.savez(inputs, **inp)
    ranks = mesh_mod.run_ranks(_card_serve_rank, S, args=(inputs, str(tmp_path)),
                               device="cuda:0", init_dir=str(tmp_path), timeout=DEADLINE)
    local = T._local_script(inp, str(tmp_path), device="cuda")
    T._same_script(ranks[0], local, "mesh on the card vs local mode on the card")
    for r, x in enumerate(ranks):
        assert x["launches"]["tile_cumsum"] > 0, r
    assert sum(x["launches"]["merge_rows_fused"] for x in ranks) > 0
