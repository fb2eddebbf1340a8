"""Cell programs: (arch × shape) -> step function + inputs (the GNN family).

The counterpart of ``repro.launch.steps`` for the ``gnn`` family: its four
archs × the four shapes of ``GNN_SHAPES``, each a training cell (AdamW,
``OPT_CFG``).

  * ``reduced=True`` — the SMOKE config on ``repro``'s small numpy-drawn
    arrays (the same ``np.random.default_rng(0)`` draws), for one-step
    tests on the CPU;
  * ``reduced=False`` — the FULL config on concrete tensors at the shape's
    real size on ``device``, drawn from a ``torch.Generator`` seeded with
    ``seed`` (``repro`` builds abstract shapes here, for its compile-only
    dry run, which the port does not have).

``repro``'s full-size rules are kept: node and edge counts padded to 512,
GCN's ``d_in`` set to the shape's feature width, GraphCast's ``remat`` and
``bf16`` and MACE's ``edge_chunks=64`` above 2M edges.  Its roofline
variants (``cost1``, ``chunkN``), shardings and ``donate`` belong to the
dry run and are not ported; the LM and recsys cells wait for their
training ports (ROADMAP.md §1 item 4).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from ..configs import base as cfgbase
from ..core import csr as csr_mod
from ..core import util
from ..models.gnn import common
from ..models.gnn import gcn as gcn_mod
from ..models.gnn import graphcast as graphcast_mod
from ..models.gnn import mace as mace_mod
from ..models.gnn import schnet as schnet_mod
from ..sampling import neighbor
from ..train import loop as train_loop
from ..train import optimizer as opt_mod

GNN_MODULES = {
    "gcn": gcn_mod,
    "schnet": schnet_mod,
    "mace": mace_mod,
    "graphcast": graphcast_mod,
}

OPT_CFG = opt_mod.OptimizerConfig(lr=1e-4, warmup_steps=10, total_steps=1000)


@dataclasses.dataclass
class CellProgram:
    """``step_fn(*args) -> (state, metrics)``.  ``meta`` holds the cell's
    ``cfg``, sizes, its model ``module`` and ``graph(batch)``: the graph
    dict the model reads for a batch (the sampled subgraph, for the sampled
    cells)."""

    step_fn: Callable
    args: tuple                   # (state, batch)
    meta: dict = dataclasses.field(default_factory=dict)

    def with_backend(self, backend: str) -> Callable:
        """The cell's step with the segment sums on ``backend`` ("torch" is
        the plain reference on the card), over the same graph."""
        return self.meta["make_step"](backend)

    def forward(self, params, batch, backend: str = "auto"):
        """The model's output for ``batch`` (logits, next state, energies)."""
        cfg = dataclasses.replace(self.meta["cfg"], backend=backend)
        return self.meta["module"].forward(params, self.meta["graph"](batch), cfg)


def _pad512(x: int) -> int:
    return -(-x // 512) * 512


def _gnn_graph_arrays(model: str, cfg, n, e, d_feat, *, reduced, n_graphs=1,
                      device, generator):
    """Synthetic padded graph batch: ``repro``'s numpy draws when reduced,
    else the same distributions drawn from ``generator`` on ``device``."""
    if reduced:
        rng = np.random.default_rng(0)
        g = {"edge_src": rng.integers(0, n, e).astype(np.int32),
             "edge_dst": rng.integers(0, n, e).astype(np.int32)}
        if model in ("mace", "schnet"):
            g["node_feat"] = rng.integers(0, 10, n).astype(np.int32)
            g["positions"] = (rng.standard_normal((n, 3)) * 3).astype(np.float32)
            g["graph_ids"] = np.minimum(np.arange(n) * n_graphs // max(n, 1),
                                        n_graphs - 1).astype(np.int32)
            g["labels"] = rng.standard_normal(n_graphs).astype(np.float32)
        elif model == "graphcast":
            nv = cfg.n_vars
            g["node_feat"] = rng.standard_normal((n, nv)).astype(np.float32)
            g["positions"] = rng.standard_normal((n, 3)).astype(np.float32)
            g["labels"] = rng.standard_normal((n, nv)).astype(np.float32)
        else:  # gcn
            g["node_feat"] = rng.standard_normal((n, d_feat)).astype(np.float32)
            g["labels"] = rng.integers(0, cfg.n_classes, n).astype(np.int32)
        return {k: torch.from_numpy(v).to(device) for k, v in g.items()}

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=generator, dtype=torch.int32,
                             device=device)

    def normal(shape, scale=1.0):
        return common.normal(generator, shape, scale, device)

    g = {"edge_src": ints(n, (e,)), "edge_dst": ints(n, (e,))}
    if model in ("mace", "schnet"):
        g["node_feat"] = ints(10, (n,))
        g["positions"] = normal((n, 3), 3.0)
        g["graph_ids"] = torch.clamp(
            torch.arange(n, dtype=torch.int64, device=device) * n_graphs // max(n, 1),
            max=n_graphs - 1).to(torch.int32)
        g["labels"] = normal((n_graphs,))
    elif model == "graphcast":
        nv = cfg.n_vars
        g["node_feat"] = normal((n, nv))
        g["positions"] = normal((n, 3))
        g["labels"] = normal((n, nv))
    else:  # gcn
        g["node_feat"] = normal((n, d_feat))
        g["labels"] = ints(cfg.n_classes, (n,))
    return g


def _init_state(mod, cfg, *, device, generator):
    model = mod.init_model(cfg, generator=generator, device=device)
    return train_loop.init_state(model.tree(), OPT_CFG)


def _gnn_train_cell(entry, cfg, shape, *, reduced, device, generator):
    mod = GNN_MODULES[entry.model]
    kind = shape["kind"]
    if reduced:
        n, e, d_feat, n_graphs = 48, 160, getattr(cfg, "d_in", 16), 4
    elif kind == "batched":
        n_graphs = shape["batch"]
        n = shape["n_nodes"] * n_graphs
        e = shape["n_edges"] * n_graphs
        d_feat = getattr(cfg, "d_in", 16)
    else:
        # node/edge counts padded to 512, as repro pads them for its mesh
        n, e = _pad512(shape["n_nodes"]), _pad512(shape["n_edges"])
        d_feat = shape.get("d_feat", getattr(cfg, "d_in", 16))
        n_graphs = 1
    if entry.model == "gcn" and not reduced and kind != "batched":
        cfg = dataclasses.replace(cfg, d_in=d_feat)
    if entry.model == "graphcast" and not reduced and e > 2_000_000:
        cfg = dataclasses.replace(cfg, remat=True, bf16=True)
    elif entry.model == "mace" and not reduced and e > 2_000_000:
        cfg = dataclasses.replace(cfg, edge_chunks=64)

    def graph(batch):
        # n_graphs is a static segment count, injected here
        return {**batch, "n_graphs": n_graphs} if entry.model in ("mace", "schnet") else batch

    def make_step(backend):
        loss = functools.partial(mod.loss_fn, cfg=dataclasses.replace(cfg, backend=backend))
        return train_loop.make_train_step(lambda p, b: loss(p, graph(b)), OPT_CFG)

    state = _init_state(mod, cfg, device=device, generator=generator)
    g = _gnn_graph_arrays(entry.model, cfg, n, e, d_feat, reduced=reduced,
                          n_graphs=n_graphs, device=device, generator=generator)
    return CellProgram(
        step_fn=make_step(cfg.backend),
        args=(state, g),
        meta={"cfg": cfg, "n": n, "e": e, "module": mod, "graph": graph,
              "make_step": make_step},
    )


def _gnn_sampled_cell(entry, cfg, shape, *, reduced, device, generator):
    """minibatch_lg: in-step fanout sampling from the big CSR."""
    mod = GNN_MODULES[entry.model]
    if reduced:
        n, e, seeds_n, fanout = 64, 256, 4, (3, 2)
        d_feat = getattr(cfg, "d_in", 16)
    else:
        n, e = _pad512(shape["n_nodes"]), _pad512(shape["n_edges"])
        seeds_n, fanout = shape["batch_nodes"], tuple(shape["fanout"])
        d_feat = getattr(cfg, "d_in", 100)
    if entry.model == "gcn":
        cfg = dataclasses.replace(cfg, d_in=d_feat)
    elif entry.model == "graphcast":
        d_feat = cfg.n_vars  # encoder consumes the physical variables
    sizes = neighbor.flat_sizes(seeds_n, fanout)
    n_sub = sum(sizes)
    off = np.cumsum([0] + sizes).tolist()

    def graph(batch):
        """The step's subgraph: the sampler seeded with ``batch["key"]``
        (the same subgraph for the same batch, as ``repro``'s fixed key),
        or fed the per-hop uniforms ``batch["draws"]`` where given."""
        dev = batch["seeds"].device
        gen = torch.Generator(device=dev).manual_seed(int(batch["key"]))
        blocks, layers, _ = neighbor.sample_subgraph(
            gen, batch["offsets"], batch["dst"], batch["seeds"], fanout,
            draws=batch.get("draws"))
        nodes = torch.cat(layers)                         # [n_sub] global ids
        esrc = torch.cat([off[h + 1] + blk.edge_src for h, blk in enumerate(blocks)])
        edst = torch.cat([off[h] + blk.edge_dst for h, blk in enumerate(blocks)])
        em = torch.cat([blk.mask for blk in blocks])
        # masked edges carry the sink n_sub, between valid ones
        g = {"edge_src": torch.where(em, esrc, n_sub), "edge_dst": torch.where(em, edst, n_sub)}
        idx = torch.clamp(nodes, 0, n - 1)
        g["node_feat"] = batch["node_feat"].index_select(0, idx)
        if entry.model in ("mace", "schnet"):
            g["positions"] = batch["positions"].index_select(0, idx)
            g["graph_ids"] = torch.zeros((n_sub,), dtype=torch.int32, device=dev)
            g["n_graphs"] = 1
            g["labels"] = torch.zeros((1,), dtype=torch.float32, device=dev)
        elif entry.model == "graphcast":
            g["positions"] = batch["positions"].index_select(0, idx)
            g["labels"] = batch["labels"].index_select(0, idx)
        else:
            lab = batch["labels"].index_select(0, idx)
            # supervise seeds only
            seed_mask = torch.arange(n_sub, device=dev) < seeds_n
            g["labels"] = torch.where(seed_mask, lab, -1)
        return g

    def make_step(backend):
        loss = functools.partial(mod.loss_fn, cfg=dataclasses.replace(cfg, backend=backend))
        inner = train_loop.make_train_step(lambda p, b: loss(p, b), OPT_CFG)
        return lambda state, batch: inner(state, graph(batch))

    state = _init_state(mod, cfg, device=device, generator=generator)
    if reduced:
        rng = np.random.default_rng(0)
        src_np = rng.integers(0, n, e)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(src_np, minlength=n), out=offsets[1:])
        batch = {
            "offsets": offsets.astype(np.int32),
            "dst": rng.integers(0, n, e).astype(np.int32),
            "seeds": rng.integers(0, n, seeds_n).astype(np.int32),
        }
        if entry.model in ("mace", "schnet"):
            batch["node_feat"] = rng.integers(0, 10, n).astype(np.int32)
        else:
            batch["node_feat"] = rng.standard_normal((n, d_feat)).astype(np.float32)
        if entry.model == "gcn":
            batch["labels"] = rng.integers(0, cfg.n_classes, n).astype(np.int32)
        elif entry.model == "graphcast":
            batch["labels"] = rng.standard_normal((n, cfg.n_vars)).astype(np.float32)
        else:
            batch["labels"] = rng.standard_normal(n).astype(np.float32)
        if entry.model in ("mace", "schnet", "graphcast"):
            batch["positions"] = rng.standard_normal((n, 3)).astype(np.float32)
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    else:
        def ints(hi, shape_):
            return torch.randint(0, hi, shape_, generator=generator, dtype=torch.int32,
                                 device=device)

        # the big CSR, built on the card from uniform random edges
        c = csr_mod.from_coo(ints(n, (e,)), ints(n, (e,)), n=n, dedup=False,
                             device=device)
        batch = {"offsets": c.offsets, "dst": c.dst, "seeds": ints(n, (seeds_n,))}
        del c
        if entry.model in ("mace", "schnet"):
            batch["node_feat"] = ints(10, (n,))
        else:
            batch["node_feat"] = common.normal(generator, (n, d_feat), 1.0, device)
        if entry.model == "gcn":
            batch["labels"] = ints(cfg.n_classes, (n,))
        elif entry.model == "graphcast":
            batch["labels"] = common.normal(generator, (n, cfg.n_vars), 1.0, device)
        else:
            batch["labels"] = common.normal(generator, (n,), 1.0, device)
        if entry.model in ("mace", "schnet", "graphcast"):
            batch["positions"] = common.normal(generator, (n, 3), 1.0, device)
    batch["key"] = 7  # the sampler's seed (repro: PRNGKey(7))
    return CellProgram(
        step_fn=make_step(cfg.backend),
        args=(state, batch),
        meta={"cfg": cfg, "n_sub": n_sub, "n": n, "e": e, "module": mod,
              "graph": graph, "make_step": make_step},
    )


def build_cell(arch: str, shape_name: str, *, reduced: bool = False, device="cuda",
               seed: int = 0) -> CellProgram:
    """The (arch, shape) training cell on ``device``; weights and (when not
    reduced) data drawn from a ``torch.Generator`` seeded with ``seed``."""
    entry = cfgbase.get(arch)
    shape = cfgbase.FAMILY_SHAPES[entry.family][shape_name]
    if entry.family != "gnn":
        raise NotImplementedError(
            f"{arch}: the {entry.family} cells wait for their training ports "
            "(ROADMAP.md §1 item 4)")
    cfg = entry.smoke if reduced else entry.full
    dev = util.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if shape["kind"] == "sampled":
        return _gnn_sampled_cell(entry, cfg, shape, reduced=reduced, device=dev, generator=gen)
    return _gnn_train_cell(entry, cfg, shape, reduced=reduced, device=dev, generator=gen)
