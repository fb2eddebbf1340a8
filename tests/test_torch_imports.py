"""Import hygiene and device rules of the PyTorch port (``repro_torch``).

* the port never imports ``jax`` or ``repro`` (checked in a fresh process);
* its entry points default to ``device="cuda"`` and raise without a GPU;
* on CPU tensors no CUDA kernel is launched: the wrappers use their plain
  versions, and every ``launches`` count stays 0.
"""
import ast
import dataclasses
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import h2o_danube_1_8b, two_tower_retrieval
from repro_torch.core import (REPRESENTATIONS, DiGraph, bitset, csr, distributed, edgebatch,
                              traversal, updates, util, walk_image)
from repro_torch.io import synthetic
from repro_torch.kernels import KERNELS
from repro_torch.kernels.bsr_spmm import kernel as bsr_kernel
from repro_torch.kernels.bsr_spmm import ops as bsr_ops
from repro_torch.kernels.csr_build import kernel as cb_kernel
from repro_torch.kernels.edge_segment_sum import kernel as seg_kernel
from repro_torch.kernels.edge_segment_sum import ops as seg_ops
from repro_torch.kernels.embedding_bag import kernel as bag_kernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.slot_update import kernel as su_kernel
from repro_torch.kernels.slot_walk import kernel as sw_kernel
from repro_torch.models.recsys import two_tower
from repro_torch.models.transformer import model as tm
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import steps as launch_steps
from repro_torch.launch import train as launch_train
from repro_torch.models.gnn import gcn, graphcast, mace, schnet
from repro_torch.runtime import durable

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    return env


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports_alone(module):
    """Import ``module`` alone in a fresh process; fail on jax or repro."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("module", ["repro_torch.io.mtx", "repro_torch.io._cparse"])
def test_file_loader_imports_neither_jax_nor_repro(module):
    _imports_alone(module)


@pytest.mark.parametrize("module", ["repro_torch.runtime.durable",
                                    "repro_torch.checkpoint.manager",
                                    "repro_torch.runtime.faultinject"])
def test_durability_imports_neither_jax_nor_repro(module):
    _imports_alone(module)


@pytest.mark.parametrize("module", ["repro_torch.runtime.serve",
                                    "repro_torch.runtime.failover",
                                    "repro_torch.launch.serve"])
def test_serving_imports_neither_jax_nor_repro(module):
    _imports_alone(module)


@pytest.mark.parametrize("module", ["repro_torch.core.distributed",
                                    "repro_torch.kernels.slot_walk.sharded",
                                    "repro_torch.launch.mesh", "repro_torch.runtime.fault"])
def test_sharded_graph_imports_neither_jax_nor_repro(module):
    _imports_alone(module)


@pytest.mark.parametrize("module", ["repro_torch.models.sharding_utils",
                                    "repro_torch.launch.shardings", "repro_torch.launch.dryrun",
                                    "repro_torch.launch.roofline"])
def test_model_sharding_imports_neither_jax_nor_repro(module):
    _imports_alone(module)


@pytest.mark.parametrize("module", [
    "repro_torch.train.optimizer", "repro_torch.train.loop", "repro_torch.core.tree",
    "repro_torch.models.gnn.common", "repro_torch.models.gnn.gcn",
    "repro_torch.models.gnn.schnet", "repro_torch.models.gnn.graphcast",
    "repro_torch.models.gnn.mace", "repro_torch.sampling.neighbor",
    "repro_torch.configs.base", "repro_torch.configs.gcn_cora",
    "repro_torch.configs.graphcast", "repro_torch.configs.mace",
    "repro_torch.configs.schnet", "repro_torch.launch.steps", "repro_torch.launch.train",
])
def test_gnn_training_imports_neither_jax_nor_repro(module):
    _imports_alone(module)


@pytest.mark.parametrize("module", [
    "repro_torch.models.param_tree", "repro_torch.models.transformer.config",
    "repro_torch.models.transformer.moe", "repro_torch.models.transformer.model",
    "repro_torch.models.transformer.attention", "repro_torch.models.recsys.two_tower",
    "repro_torch.kernels.embedding_bag.ops", "repro_torch.runtime.compression",
    "repro_torch.configs.qwen2_72b", "repro_torch.configs.mistral_large_123b",
    "repro_torch.configs.qwen3_moe_235b_a22b", "repro_torch.configs.arctic_480b",
])
def test_lm_and_recsys_training_import_neither_jax_nor_repro(module):
    _imports_alone(module)


def test_chip_smoke_imports_only_the_port():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module.split(".")[0])
    assert mods <= {"contextlib", "dataclasses", "gc", "json", "os", "shutil", "subprocess", "sys",
                    "time", "numpy", "torch", "repro_torch"}, mods


def test_row_merge_does_not_import_the_walk():
    """The row merge sits beside the walk layer, not above it: no import
    statement of ``kernels/slot_update/ops.py`` names ``slot_walk`` (read
    from the source: importing ``repro_torch.kernels`` loads both)."""
    with open(os.path.join(SRC, "repro_torch", "kernels", "slot_update", "ops.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names += [f"{node.module or ''}.{a.name}" for a in node.names]
    assert not [n for n in names if "slot_walk" in n], names


def test_chip_smoke_fails_without_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    smoke = runpy.run_path(os.path.join(ROOT, "chip_smoke.py"))
    with pytest.raises(SystemExit) as exc:
        smoke["main"]()
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


REPS = ["coo", "lazy", "chunked", "vector2d"]
GNNS = {"gcn": gcn, "schnet": schnet, "graphcast": graphcast, "mace": mace}
GNN_ARCHS = {"gcn": "gcn-cora", "schnet": "schnet", "graphcast": "graphcast", "mace": "mace"}


@pytest.mark.parametrize(
    "entry",
    ["from_coo", "make_graph", "from_csr", "empty", "from_state_tree", "init_model",
     "init_cache", "from_jax_params", "from_dense", "recover", "bitset.make", "build_rep",
     "seed_visits_row", "serve.main", "shard_csr", "sharded.from_state_trees",
     "sharded.restore", "image_from_state_tree", "build_cell", "train.main",
     "lm.build_cell", "recsys.build_cell", "build_opt_cell", "lm.train.main",
     "recsys.train.main", "two_tower.init_model", "two_tower.from_jax_params"]
    + [f"{r}.{e}" for r in REPS for e in ("from_csr", "from_state_tree")]
    + [f"{m}.{e}" for m in GNNS for e in ("init_model", "from_jax_params")],
)
def test_default_device_raises_without_gpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    c = csr.from_coo([0, 1], [1, 0], n=2, device="cpu")
    lm = h2o_danube_1_8b.SMOKE
    lm_params = {"embed": np.zeros((256, 64)), "ln_f": np.ones(64), "unembed": np.zeros((64, 256)),
                 "layers": {n: np.zeros((2, *s)) for n, s in tm._layer_param_shapes(lm).items()}}
    calls = {
        "from_coo": lambda: csr.from_coo([0, 1], [1, 0], n=2),
        "make_graph": lambda: synthetic.make_graph("uniform", scale=3),
        "from_csr": lambda: DiGraph.from_csr(c),
        "empty": lambda: DiGraph.empty(3),
        "from_state_tree": lambda: DiGraph.from_state_tree(
            DiGraph.from_csr(c, device="cpu").state_tree()
        ),
        "init_model": lambda: tm.init_model(lm, generator=torch.Generator()),
        "init_cache": lambda: tm.init_cache(lm, 2, 16),
        "from_jax_params": lambda: tm.from_jax_params(lm_params, lm),
        "from_dense": lambda: csr.from_dense(np.eye(3)),
        # raises before it reads a directory
        "recover": lambda: durable.DurableGraph.recover("no-wal", "no-ckpt"),
        "bitset.make": lambda: bitset.make(40),
        "build_rep": lambda: launch_serve.build_rep(scale=3),
        "seed_visits_row": lambda: launch_serve.seed_visits_row(4, [1]),
        "serve.main": lambda: launch_serve.main(["--scale", "3", "--requests", "1"]),
        "shard_csr": lambda: distributed.shard_csr(c, 2),
        "sharded.from_state_trees": lambda: distributed.ShardedGraph.from_state_trees(
            distributed.shard_csr(c, 2, device="cpu").state_trees()),
        # raises before it reads a directory
        "sharded.restore": lambda: distributed.ShardedGraph.restore("no-ckpt"),
        "image_from_state_tree": lambda: distributed.image_from_state_tree(
            distributed.shard_csr(c, 2, device="cpu").state_trees()[0]),
        "build_cell": lambda: launch_steps.build_cell("gcn-cora", "full_graph_sm", reduced=True),
        "train.main": lambda: launch_train.main(["--arch", "gcn-cora", "--steps", "1"]),
        "lm.build_cell": lambda: launch_steps.build_cell("qwen3-moe-235b-a22b", "train_4k",
                                                         reduced=True),
        "recsys.build_cell": lambda: launch_steps.build_cell("two-tower-retrieval",
                                                             "train_batch", reduced=True),
        "build_opt_cell": lambda: launch_steps.build_opt_cell("h2o-danube-1.8b"),
        "lm.train.main": lambda: launch_train.main(["--arch", "arctic-480b", "--steps", "1"]),
        "recsys.train.main": lambda: launch_train.main(["--arch", "two-tower-retrieval",
                                                        "--steps", "1"]),
        "two_tower.init_model": lambda: two_tower.init_model(two_tower_retrieval.SMOKE,
                                                             generator=torch.Generator()),
        "two_tower.from_jax_params": lambda: two_tower.from_jax_params(
            two_tower.init_params(two_tower_retrieval.SMOKE, generator=torch.Generator(),
                                  device="cpu"), two_tower_retrieval.SMOKE),
    }
    for name, mod in GNNS.items():
        cfg = launch_steps.cfgbase.get(GNN_ARCHS[name]).smoke
        params = mod.init_params(cfg, generator=torch.Generator(), device=torch.device("cpu"))
        calls[f"{name}.init_model"] = lambda mod=mod, cfg=cfg: mod.init_model(
            cfg, generator=torch.Generator())
        calls[f"{name}.from_jax_params"] = lambda mod=mod, cfg=cfg, p=params: mod.from_jax_params(
            p, cfg)
    for r in REPS:
        cls = REPRESENTATIONS[r]
        calls[f"{r}.from_csr"] = lambda cls=cls: cls.from_csr(c)
        calls[f"{r}.from_state_tree"] = lambda cls=cls: cls.from_state_tree(
            cls.from_csr(c, device="cpu").state_tree())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_cpu_stream_rounds_launch_no_kernel():
    """The four representations' stream rounds (apply, then walk_flush) on
    CPU tensors: patched images, walks of the right shape, no launches."""
    for k in KERNELS.values():
        k.launches = 0
    c = synthetic.make_graph("social", scale=7, edge_factor=4, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    for name in REPS:
        g = REPRESENTATIONS[name].from_csr(c, device="cpu")
        g.reverse_walk(2)
        before = walk_image.stats_snapshot()
        g, _ = g.apply(updates.plan_update(
            inserts=edgebatch.random_insertions(rng, c.n, 30),
            deletes=edgebatch.random_deletions(rng, c, 30)))
        assert g.reverse_walk(3).shape == (c.n,)
        assert walk_image.stats_snapshot()["patches"] == before["patches"] + 1, name
        assert g.to_walk_image().audit()["bump"] == g.to_walk_image().bump
    assert all(k.launches == 0 for k in KERNELS.values())


def test_backend_resolution():
    cpu = torch.device("cpu")
    assert util.resolve_backend("auto", cpu) == "torch"
    assert util.resolve_backend("torch", cpu) == "torch"
    with pytest.raises(ValueError):
        util.resolve_backend("cuda", cpu)
    with pytest.raises(ValueError):
        util.resolve_backend("pallas", cpu)


def _wrapper_calls():
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.random((3, 128), dtype=np.float32))
    incl = torch.cumsum(torch.from_numpy(rng.random((2, 5 * 128), dtype=np.float32)), dim=1)
    gv = torch.from_numpy(rng.random((3, 9), dtype=np.float32))
    gidx = torch.from_numpy(rng.integers(0, 10, (2, 128)).astype(np.int32))  # 9: the sink
    src = torch.from_numpy(rng.integers(-1, 9, 50).astype(np.int32))
    src_s = torch.sort(src).values
    d = torch.tensor([[1, 4, 9, 2**31 - 1]], dtype=torch.int32)
    merge = (d, torch.ones(1, 4), torch.tensor([3], dtype=torch.int32),
             torch.tensor([[2, 4, 2**31 - 1, 2**31 - 1]], dtype=torch.int32),
             torch.full((1, 4), 5.0), torch.tensor([[0, 1, 0, 0]], dtype=torch.int32))
    rows = torch.from_numpy(np.repeat(rng.integers(0, 9, (3, 16)), 8, axis=1).astype(np.int32))
    bsr = (torch.tensor([0, 2, 2, 3], dtype=torch.int32),
           torch.tensor([0, 1, 1], dtype=torch.int32),
           torch.from_numpy(rng.random((3, 128, 128), dtype=np.float32)),
           torch.from_numpy(rng.random((256, 8), dtype=np.float32)))
    seg_rows = torch.from_numpy(np.sort(rng.integers(-1, 10, 300)).astype(np.int32))
    seg_vals = torch.from_numpy(rng.random((300, 16), dtype=np.float32))
    arena = (torch.tensor([1, 4, 9, 2**31 - 1] + [2**31 - 1] * 4, dtype=torch.int32),
             torch.ones(8), torch.tensor([0] * 4 + [8] * 4, dtype=torch.int32))
    # row 0 grows from the block at 0 into the block at 4
    row_ops = torch.tensor([[0], [4], [4], [4], [3], [0]], dtype=torch.int32)
    blocks = (torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))

    def fused(fn):
        d, w, s, lo, hi = (t.clone() for t in arena + blocks)
        counts = fn(d, w, s, row_ops, torch.stack([merge[3], merge[5]]), merge[4],
                    width=4, moves=True, lo=lo, hi=hi)
        return d, w, s, lo, hi, counts

    table = torch.from_numpy(rng.random((20, 8), dtype=np.float32))
    bags = torch.from_numpy(rng.integers(-1, 25, (6, 4)).astype(np.int32))
    wts = torch.from_numpy(rng.random((6, 4), dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((1, 4, 32, 16), dtype=np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 2, 32, 16), dtype=np.float32))
    return {
        "edge_segment_runs": (
            lambda: seg_kernel.edge_segment_runs(seg_rows, seg_vals, 8),
            lambda: seg_kernel.edge_segment_sum_torch(seg_rows, seg_vals, 8)),
        "embedding_bag": (lambda: bag_kernel.embedding_bag(table, bags, wts, "mean"),
                          lambda: bag_kernel.embedding_bag_torch(table, bags, wts, "mean")),
        "tile_cumsum": (lambda: sw_kernel.tile_cumsum(vals),
                        lambda: sw_kernel.tile_cumsum_torch(vals)),
        "tile_bases": (lambda: sw_kernel.tile_bases(incl),
                       lambda: sw_kernel.tile_bases_torch(incl)),
        "slot_gather": (lambda: sw_kernel.slot_gather(gv, gidx),
                        lambda: sw_kernel.slot_gather_torch(gv, gidx)),
        "count_degrees": (lambda: cb_kernel.count_degrees(src, 8),
                          lambda: cb_kernel.count_degrees_torch(src, 8)),
        "degree_offsets": (lambda: cb_kernel.degree_offsets(src_s, 8),
                           lambda: cb_kernel.degree_offsets_torch(src_s, 8)),
        "merge_rows_fused": (lambda: fused(su_kernel.merge_rows_fused),
                             lambda: fused(su_kernel.merge_rows_fused_torch)),
        "slot_walk_partials": (lambda: sw_kernel.slot_walk_partials(rows, vals, 8),
                               lambda: sw_kernel.slot_walk_partials_torch(rows, vals, 8)),
        "bsr_spmm": (lambda: bsr_kernel.bsr_spmm(*bsr, d_tile=8),
                     lambda: bsr_kernel.bsr_spmm_torch(*bsr)),
        "flash_attention": (lambda: fa_kernel.flash_attention(q, kv, kv, window=8),
                            lambda: fa_kernel.flash_attention_torch(q, kv, kv, window=8)),
    }


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_cpu_tensor_takes_the_plain_version(name):
    kernel_call, plain_call = _wrapper_calls()[name]
    KERNELS[name].launches = 0
    got, exp = kernel_call(), plain_call()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    exp if isinstance(exp, tuple) else (exp,)):
        assert torch.equal(a, b)
    assert KERNELS[name].launches == 0


def test_cpu_slice_launches_no_kernel():
    for k in KERNELS.values():
        k.launches = 0
    src, dst, wgt, n = synthetic.make_coo("social", scale=7, edge_factor=4, seed=1)
    c = csr.from_coo(src, dst, wgt, n=n, dedup=False, engine="torch", device="cpu")
    g = DiGraph.from_csr(csr.from_coo(src, dst, wgt, n=n, device="cpu"), device="cpu")
    rng = np.random.default_rng(1)
    g.apply(updates.plan_update(
        inserts=edgebatch.random_insertions(rng, n, 40),
        deletes=edgebatch.random_deletions(rng, c, 40),
    ))
    v = g.reverse_walk(3)
    assert v.shape == (g.n_max_vertex() + 1,)
    nv = g.n_max_vertex() + 1
    assert traversal.reverse_walk_slotted(g.dst, g.slot_rows, 3, nv).shape == (nv,)
    assert bsr_ops.reverse_walk_bsr(bsr_ops.csr_to_bsr(g.to_csr()), 3, nv).shape == (nv,)
    rows = util.expand_rows(c.offsets, c.m)
    h = torch.ones((n, 4))
    assert seg_ops.edge_segment_sum(rows, h[c.dst.long()], num_segments=n).shape == (n, 4)
    cfg = two_tower_retrieval.SMOKE
    m = two_tower.init_model(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    bags = torch.from_numpy(rng.integers(-1, cfg.n_users, (3, 2, cfg.bag_size)).astype(np.int32))
    assert m.serve_step({"user_bags": bags, "item_bags": bags}).shape == (3,)
    lm = dataclasses.replace(h2o_danube_1_8b.SMOKE, attn_impl="flash", attn_block=8)
    model = tm.init_model(lm, generator=torch.Generator().manual_seed(2), device="cpu")
    logits, _ = model(torch.from_numpy(rng.integers(0, lm.vocab, (2, 32))))
    assert logits.shape == (2, 32, lm.vocab) and bool(torch.isfinite(logits).all())
    assert all(k.launches == 0 for k in KERNELS.values())


def test_cpu_sharded_graph_launches_no_kernel():
    """A sharded graph on CPU tensors: routed patches and walks take the
    plain versions, and no wrapper counts a launch."""
    for k in KERNELS.values():
        k.launches = 0
    c = synthetic.make_graph("social", scale=7, edge_factor=4, seed=5, device="cpu")
    g = distributed.shard_csr(c, 4, device="cpu")
    rng = np.random.default_rng(5)
    g.apply(updates.plan_update(inserts=edgebatch.random_insertions(rng, c.n, 30),
                                deletes=edgebatch.random_deletions(rng, c, 30)))
    assert g.reverse_walk(3).shape == (c.n,) and g.device.type == "cpu"
    assert g.seal_generation(1).walk(2, visits0=torch.ones((2, c.n))).shape == (2, c.n)
    assert all(k.launches == 0 for k in KERNELS.values())


def test_cpu_lm_and_recsys_train_steps_launch_no_kernel():
    """A train step of the MoE and two-tower cells on CPU tensors: the bag
    and attention take their plain versions, and no wrapper counts."""
    for k in KERNELS.values():
        k.launches = 0
    for arch, shape in (("qwen3-moe-235b-a22b", "train_4k"),
                        ("two-tower-retrieval", "train_batch")):
        cell = launch_steps.build_cell(arch, shape, reduced=True, device="cpu")
        _, metrics = cell.step_fn(*cell.args)
        assert np.isfinite(float(metrics["loss"]))
    assert all(k.launches == 0 for k in KERNELS.values())
