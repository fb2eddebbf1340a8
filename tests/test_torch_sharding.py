"""Model sharding in the port against ``repro``'s rules, and a real sharded
step on 4 CPU ranks.

* **Placements:** every leaf of every cell of ``all_cells()`` × its
  ``variants_for``, on (2, 4), (16, 16) and (2, 16, 16): the port's
  placements, mapped back to a spec, equal ``repro``'s ``NamedSharding``
  spec for the same path (``repro`` in one subprocess with forced host
  devices, as ``tests/test_launch.py`` runs it; the port's cells built as
  fakes, which allocate nothing).
* **The guard** and **constrain without a mesh**.
* **A real sharded step:** one step of the SMOKE ``gcn-cora``,
  ``two-tower`` ``train_batch``, ``h2o-danube`` ``train_4k`` and
  ``qwen3-moe`` cells on a (2, 2) ``("data", "model")`` DeviceMesh of 4
  gloo ranks on the CPU (``run_ranks``, one spawn for the module) equals the
  port's unsharded step within ``ROADMAP.md`` §3's training tolerances
  (loss rtol 1e-4; parameters rtol 1e-5, atol 1e-6).
* **The row-parallel product** (``model._row_parallel``) on the same ranks
  reduces its partial sums in float32: its bfloat16 output is the
  unsharded float32 product rounded once.
* **Context-parallel decode** in the same spawn: the SMOKE h2o-danube
  ``decode_32k`` and ``long_500k`` and qwen3-moe ``decode_32k`` cells, their
  cache's sequence over ``"model"``, three steps each at positions where
  the live prefix ends in rank 0's slice, spans both, and wraps the ring
  (``torch_sharding_ranks.DECODE_POSITIONS``): the logits equal the
  unsharded decode's, and the cache too (see the test for the bfloat16
  slots).
* **The sampled minibatch_lg cells** in the same spawn (gcn-cora, mace,
  schnet, graphcast), fed ``repro``'s uniforms as
  ``tests/test_torch_sampling.py`` feeds them: the gathered subgraph is
  ``repro``'s bit for bit, and the loss and parameters after one step
  equal the unsharded step's.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import base
from repro_torch.core import tree
from repro_torch.launch import dryrun, shardings, steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import sharding_utils as su
from repro_torch.sampling import neighbor

sys.path.insert(0, os.path.dirname(__file__))
import torch_sharding_ranks as ranks  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
MESHES = {"2x4": ((2, 4), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SHARDED_CELLS = [("gcn-cora", "full_graph_sm"), ("two-tower-retrieval", "train_batch"),
                 ("h2o-danube-1.8b", "train_4k"), ("qwen3-moe-235b-a22b", "train_4k")]
DECODE_CELLS = [("h2o-danube-1.8b", "decode_32k"), ("h2o-danube-1.8b", "long_500k"),
                ("qwen3-moe-235b-a22b", "decode_32k")]
SAMPLED_ARCHS = ["gcn-cora", "mace", "schnet", "graphcast"]
#: the reduced minibatch_lg cells' seeds and fanouts
SAMPLED_SEEDS, SAMPLED_FANOUT = 4, (3, 2)

_REPRO_SPECS = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    sys.path.insert(0, "src")
    import jax
    from repro.configs import base
    from repro.launch import dryrun, steps
    from repro.launch import mesh as mesh_mod
    meshes = json.loads(sys.argv[1])
    made = {k: mesh_mod.make_mesh_like(tuple(s), tuple(a)) for k, (s, a) in meshes.items()}

    def part(p):
        return list(p) if isinstance(p, tuple) else p

    out = {k: {} for k in made}
    for arch, shape, skip in base.all_cells():
        for v in dryrun.variants_for(arch, shape):
            cell = (steps.build_opt_cell(arch, variant=v) if v.startswith("opt")
                    else steps.build_cell(arch, shape, variant=v))
            for k, m in made.items():
                sh = steps.attach_shardings(cell, m, arch, shape)
                flat, _ = jax.tree_util.tree_flatten_with_path(sh)
                out[k][f"{arch}|{shape}|{v}"] = {
                    "/".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in path):
                    [part(p) for p in s.spec] for path, s in flat}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def repro_specs():
    r = subprocess.run([sys.executable, "-c", _REPRO_SPECS, json.dumps(MESHES)],
                       capture_output=True, text=True, cwd=ROOT, timeout=600,
                       env={k: v for k, v in os.environ.items() if k != "XLA_FLAGS"})
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _norm(spec) -> tuple:
    """A spec as comparable parts: 1-tuples as names, trailing Nones cut."""
    parts = [p[0] if isinstance(p, (list, tuple)) and len(p) == 1 else
             tuple(p) if isinstance(p, (list, tuple)) else p for p in spec]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _leaf_placements(tree_, placed, prefix: str = "") -> list:
    """``[(path, leaf, placements), ...]`` of a tree and its ``tree_spec``
    output, in JAX's order (the placement tuples are leaves here)."""
    if tree_ is None:
        return []
    kids = tree._children(tree_)
    if kids is None:
        return [(prefix, tree_, placed)]
    return [item for k, sub in kids for item in _leaf_placements(
        sub, placed[k], f"{prefix}/{k}" if prefix else str(k))]


def _port_specs(mesh) -> dict:
    out = {}
    with FakeTensorMode():
        for arch, shape, _ in base.all_cells():
            for v in dryrun.variants_for(arch, shape):
                cell = (steps.build_opt_cell(arch, variant=v, device="cpu")
                        if v.startswith("opt")
                        else steps.build_cell(arch, shape, variant=v, device="cpu"))
                placed = steps.attach_shardings(cell, mesh, arch, shape)
                specs = {}
                for i, (arg, pl) in enumerate(zip(cell.args, placed)):
                    for path, leaf, p in _leaf_placements(arg, pl):
                        nd = len(getattr(leaf, "shape", ()))
                        specs[f"{i}/{path}" if path else str(i)] = \
                            su.placements_to_spec(p, mesh, nd)
                out[f"{arch}|{shape}|{v}"] = specs
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_placements_match_repro(repro_specs, mesh_name):
    shape, axes = MESHES[mesh_name]
    got = _port_specs(su.MeshShape(shape, axes))
    want = repro_specs[mesh_name]
    assert sorted(got) == sorted(want)
    n = 0
    for cell, specs in want.items():
        # repro's host ints (the sampler key, the cache position) are arrays
        assert set(got[cell]) >= set(specs), cell
        for path, spec in specs.items():
            assert _norm(got[cell][path]) == _norm(spec), (cell, path)
            n += 1
    assert n > 2000


def test_divisibility_guard_drops_axes():
    """``tree_spec`` replicates leaves whose dims do not divide the mesh."""
    mesh = su.MeshShape((2, 4), ("data", "model"))
    t = {"ok": torch.zeros(8, 4), "odd": torch.zeros(7, 4), "scalar": torch.zeros(())}
    out = shardings.tree_spec(t, lambda p, m: ("data", None), mesh)
    assert su.placements_to_spec(out["ok"], mesh, 2) == ("data", None)
    assert su.placements_to_spec(out["odd"], mesh, 2) == (None, None)
    assert su.placements_to_spec(out["scalar"], mesh, 0) == ()
    both = shardings.tree_spec({"x": torch.zeros(16, 3)},
                               lambda p, m: (("data", "model"),), mesh)
    assert su.placements_to_spec(both["x"], mesh, 2) == (("data", "model"), None)
    with pytest.raises(ValueError, match="mesh's order"):
        su.spec_to_placements((("model", "data"),), (16,), mesh)


def test_constrain_is_a_noop_without_a_mesh():
    x = torch.arange(12.0).reshape(4, 3)
    assert su.current_mesh() is None
    assert su.constrain(x, "data", "model") is x
    assert su.maybe_constrain(x, ("data",)) is x
    with su.use_mesh(su.MeshShape((2, 2), ("data", "model"))):
        assert su.constrain(x, "data") is x  # a plain tensor, not a DTensor
    assert su.current_mesh() is None


def test_make_mesh_like_needs_the_world_size():
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_mesh_like((2, 2), ("data", "model"))
    assert mesh_mod.production_shape() == ((16, 16), ("data", "model"))
    assert mesh_mod.production_shape(multi_pod=True) == ((2, 16, 16), ("pod", "data", "model"))
    assert mesh_mod.data_axes(su.MeshShape((2, 16, 16), ("pod", "data", "model"))) == \
        ("pod", "data")


def _repro_draws() -> list:
    """The uniforms ``repro``'s reduced minibatch_lg cells draw (their key,
    ``PRNGKey(7)``, split a hop, as ``tests/test_torch_sampling.py`` draws
    them): the same for every arch."""
    import jax

    key = jax.random.PRNGKey(7)
    sizes = neighbor.flat_sizes(SAMPLED_SEEDS, SAMPLED_FANOUT)
    draws = []
    for s, f in zip(sizes, SAMPLED_FANOUT):
        key, sub = jax.random.split(key)
        draws.append(np.array(jax.random.uniform(sub, (s, f))))
    return draws


def _repro_subgraphs() -> dict:
    """``repro``'s subgraph of each reduced minibatch_lg cell (its step's own
    ``build_subgraph``), as numpy."""
    from repro.configs import base as j_base
    from repro.launch import steps as j_steps

    j_base.all_archs()  # every repro config registered before one is imported
    from test_torch_sampling import _repro_subgraph

    out = {}
    for arch in SAMPLED_ARCHS:
        jcell = j_steps.build_cell(arch, "minibatch_lg", reduced=True)
        _, jb = jcell.args
        sub = _repro_subgraph(jcell)(jb["offsets"], jb["dst"], jb["seeds"], jb["key"],
                                     jb["node_feat"], jb.get("positions"), jb["labels"])
        out[arch] = {k: v if isinstance(v, int) else np.asarray(v) for k, v in sub.items()}
    return out


_DRY_REDUCED = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun, mesh as mesh_mod
    dryrun.init_fake_world(4)
    mesh = mesh_mod.make_mesh_like((2, 2), ("data", "model"), device_type="cpu")
    recs = [dryrun.run_cell(a, s, mesh=mesh, reduced=True) for a, s in json.loads(sys.argv[1])]
    print(json.dumps(recs))
""")

#: every cell of the spawn, in the dry run's order
ALL_RANK_CELLS = (SHARDED_CELLS + DECODE_CELLS
                  + [(a, "minibatch_lg") for a in SAMPLED_ARCHS])


@pytest.fixture(scope="module")
def dry_reduced():
    """The fake (2, 2) dry run of every cell of the spawn, in a process
    started first, which runs beside the ranks."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.Popen([sys.executable, "-c", _DRY_REDUCED, json.dumps(ALL_RANK_CELLS)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
                         env=env)
    yield p
    if p.poll() is None:
        p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def spawn(dry_reduced):
    """(every rank's records, ``torch_sharding_ranks.rank_runs``; ``repro``'s
    uniforms; ``repro``'s subgraphs): the ranks run in a thread of their
    own while ``repro`` builds its sampled cells."""
    from concurrent.futures import ThreadPoolExecutor

    draws = _repro_draws()
    sampled = [(a, draws) for a in SAMPLED_ARCHS]
    with ThreadPoolExecutor(1) as ex:
        runs = ex.submit(mesh_mod.run_ranks, ranks.rank_runs, 4,
                         args=(SHARDED_CELLS, DECODE_CELLS, sampled), device="cpu",
                         timeout=300)
        subs = _repro_subgraphs()
        return runs.result(), draws, subs


@pytest.fixture(scope="module")
def rank_runs(spawn):
    """Every rank's records (``torch_sharding_ranks.rank_runs``)."""
    return spawn[0]


@pytest.fixture(scope="module")
def sharded_runs(rank_runs):
    """Every rank's records of one sharded step of each SMOKE cell."""
    return [r["cells"] for r in rank_runs]


@pytest.mark.parametrize("i", range(len(SHARDED_CELLS)),
                         ids=[f"{a}-{s}" for a, s in SHARDED_CELLS])
def test_sharded_step_equals_unsharded(sharded_runs, i):
    arch, shape = SHARDED_CELLS[i]
    cell = steps.build_cell(arch, shape, reduced=True, device="cpu")
    state, metrics = cell.step_fn(*cell.args)
    want = {k: v.detach().numpy() for k, v in tree.paths(state["params"])}
    for rank in sharded_runs:
        got = rank[i]
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=1e-4)
        assert sorted(got["params"]) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got["params"][k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{arch} {k}")
    # every rank holds a quarter of the (evenly shardable) batch at most
    assert all(r[i]["argument_bytes"] == sharded_runs[0][i]["argument_bytes"]
               for r in sharded_runs)
    assert sum(sharded_runs[0][i]["collectives"]["count"].values()) > 0


def test_dry_run_matches_the_real_ranks(rank_runs, dry_reduced):
    """The fake (2, 2) dry run of the same SMOKE cells (every kernel site
    on its custom op's fake body) gives the real ranks' argument bytes and
    collectives, kind by kind (its flops add the kernels' formulas).  The
    decode cells' ranks count their last step; the sampled cells' ranks
    count the cell's own arguments (not the uniforms they were fed)."""
    stdout, stderr = dry_reduced.communicate(timeout=300)
    assert dry_reduced.returncode == 0, stderr[-3000:]
    dry = json.loads(stdout.strip().splitlines()[-1])
    real0 = rank_runs[0]
    for (arch, shape), rec, real in zip(ALL_RANK_CELLS, dry,
                                        real0["cells"] + real0["decode"] + real0["sampled"]):
        assert rec["status"] == "ok", (arch, rec.get("error"))
        assert rec["memory"]["argument_bytes"] == real["argument_bytes"], arch
        assert rec["collectives"] == real["collectives"], arch
        # the CPU ranks run the kernels' plain versions, which count no flops
        assert rec["cost"]["flops"] >= real["flops"] > 0, arch


def test_row_parallel_reduces_in_float32(rank_runs):
    """Each rank's partial product stays float32 through the all-reduce, so
    the sharded bfloat16 output equals the unsharded float32 product
    rounded once, bit for bit; the grads (the weight's reduced over the
    batch's ``"data"`` shards) match autograd of the same unsharded
    product within two bfloat16 roundings (2^-7 of each grad's max)."""
    a, w = ranks.row_parallel_inputs()
    a.requires_grad_()
    w.requires_grad_()
    want = (a.float() @ w.float()).to(torch.bfloat16)
    (want.float() ** 2).sum().backward()
    for r in rank_runs:
        got = r["row_parallel"]
        assert got["placements"] == "(Shard(dim=0), Replicate())"
        assert torch.equal(got["out"], want)
        for k, ref in (("a_grad", a.grad), ("w_grad", w.grad)):
            np.testing.assert_allclose(got[k].float().numpy(), ref.float().numpy(), rtol=0,
                                       atol=2.0**-7 * float(ref.abs().max()), err_msg=k)


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in bfloat16 units in the last place of two arrays of
    bfloat16 values (held as float32)."""
    def key(x):
        bits = (np.ascontiguousarray(x, np.float32).view(np.int32) >> 16).astype(np.int64)
        return np.where(bits < 0, -(bits + 32768), bits)
    return np.abs(key(a) - key(b))


@pytest.mark.parametrize("i", range(len(DECODE_CELLS)),
                         ids=[f"{a}-{s}" for a, s in DECODE_CELLS])
def test_sharded_decode_equals_unsharded(rank_runs, i):
    """Three decode steps with the cache's sequence over ``"model"`` (8
    slots a rank) against the unsharded steps (float32 compute).

    The logits within rtol 1e-5 and an atol of 1e-6 of their largest
    magnitude (the merge and the row-parallel sums add in other orders).
    The cache stores bfloat16: every slot no step wrote is bit for bit the
    unsharded one (no rank writes outside its slice, or another's slot),
    and a written slot is within one bfloat16 ulp of it (its float32 K/V
    differ from the unsharded in their last bits from the second layer
    on, so one rounds apart now and then).
    """
    arch, shape = DECODE_CELLS[i]
    cell = ranks.decode_cell(arch, shape)
    params, cache, tokens = cell.args
    positions = ranks.DECODE_POSITIONS[arch]
    before = tuple(cache[key].float().numpy() for key in ("k", "v"))
    want = ranks.decode_steps(cell.step_fn, params, cache, tokens, positions)
    cache_len = cache["k"].shape[3]
    written = set()
    for j, pos in enumerate(positions):
        written.add(pos % cache_len if cell.meta["cfg"].sliding_window else
                    min(pos, cache_len - 1))
        others = [s_ for s_ in range(cache_len) if s_ not in written]
        for rank in rank_runs:
            rec = rank["decode"][i]
            got_logits, *got_kv = rec["steps"][j]
            w_logits, *w_kv = want[j]
            np.testing.assert_allclose(got_logits, w_logits, rtol=1e-5,
                                       atol=1e-6 * float(np.abs(w_logits).max()),
                                       err_msg=f"{arch} {shape} step {j} logits")
            for name, g_, w_, b_ in zip(("k", "v"), got_kv, w_kv, before):
                assert np.array_equal(g_[..., others, :], w_[..., others, :]), (name, j)
                assert np.array_equal(w_[..., others, :], b_[..., others, :]), (name, j)
                assert _bf16_ulps(g_, w_).max() <= 1, (arch, shape, name, j)
    recs = [r["decode"][i] for r in rank_runs]
    # the sequence over "model" (dim 3), the batch over "data" where it divides
    want_pl = ("(Replicate(), Shard(dim=3))" if shape == "long_500k"
               else "(Shard(dim=1), Shard(dim=3))")
    assert all(r["cache_placements"] == want_pl for r in recs)
    # the merge's all-reduces: max of m, sum of (o, l), each layer
    assert recs[0]["collectives"]["count"]["all-reduce"] >= 2 * cell.meta["cfg"].n_layers


@pytest.mark.parametrize("arch", SAMPLED_ARCHS)
def test_sharded_sampled_equals_unsharded(spawn, arch):
    """One sampled minibatch_lg step on the (2, 2) mesh, fed ``repro``'s
    uniforms: every rank's gathered subgraph is ``repro``'s bit for bit
    (and the port's unsharded one), and the loss and the parameters after
    the step equal the unsharded step's (loss rtol 1e-4; parameters rtol
    1e-5, atol 1e-6)."""
    rank_runs, draws, subs = spawn
    want_sub = subs[arch]
    cell = ranks.sampled_cell(arch, draws)
    port_sub = cell.meta["graph"](cell.args[1])
    state, metrics = cell.step_fn(*cell.args)
    want = {k: v.detach().numpy() for k, v in tree.paths(state["params"])}
    i = SAMPLED_ARCHS.index(arch)
    for rank in rank_runs:
        got = rank["sampled"][i]
        assert sorted(got["subgraph"]) == sorted(want_sub) == sorted(port_sub)
        for k, v in want_sub.items():
            if isinstance(v, int):
                assert got["subgraph"][k] == v == port_sub[k], k
                continue
            a = got["subgraph"][k]
            assert a.dtype == v.dtype and np.array_equal(a, v), (arch, k)
            assert np.array_equal(a, port_sub[k].numpy()), (arch, k)
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=1e-4)
        assert sorted(got["params"]) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got["params"][k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{arch} {k}")
