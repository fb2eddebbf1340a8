"""Cell programs: (arch × shape) -> step function + inputs.

The counterpart of ``repro.launch.steps``: every (arch, shape) cell of the
three families — LM train / prefill / decode, GNN training, two-tower
train / serve / retrieval.

  * ``reduced=True`` — the SMOKE config on ``repro``'s small arrays, for
    one-step tests on the CPU: the same ``np.random.default_rng(0)`` draws
    for the GNN and recsys cells; the LM cells draw their tokens from
    ``np.random.default_rng(1)`` (``repro`` uses ``jax.random`` there, which
    the port cannot replay: tests hand ``repro``'s tokens over);
  * ``reduced=False`` — the FULL config (or its ``variant``) at the
    shape's real size on ``device``, drawn from a ``torch.Generator``
    seeded with ``seed``: concrete tensors, or, under a ``FakeTensorMode``
    (the dry run, ``launch.dryrun``), fakes of the same shapes and types
    that allocate nothing (``repro``'s ``_sds_like`` / ``eval_shape``); the
    one array built from data, the sampled cells' CSR, is then an empty
    fake of its shape.

``variant`` takes ``repro``'s ``"full"``; for the LM family its
``"cost1"`` / ``"cost2"`` / ``"cost4"`` (1 / 2 / 4 layers at full width,
no grad accumulation), and for the GNN family its ``"chunk2"`` /
``"chunk4"`` (MACE's edge loop in 2 / 4 chunks; ``loop_correction``
records them as ``repro`` does, for ``launch.roofline``).  ``repro``'s
full-size rules are kept: bfloat16 Adam moments for every full LM train,
``accum = 16`` for ``"full"``, a microbatch of ``max(global_batch // 16,
1)`` and tokens ``[accum, ub, seq]``; GNN node and edge counts padded to
512, GCN's ``d_in`` set to the shape's feature width, GraphCast's
``remat`` and ``bf16`` and MACE's ``edge_chunks=64`` above 2M edges.

``data_axes`` applies ``repro``'s activation sharding axes to the config
(``steps.py:490-497``: LM ``batch_axes`` and ``tp_axis="model"``, GNN
``shard_axes`` over the data axes and ``"model"``, recsys ``shard_axes``).
``repro`` applies them to full-size cells only; the port applies them to a
``reduced`` cell too, because the CPU tests are the only place where a
reduced cell runs on a mesh.  :func:`attach_shardings` gives the
placements of a cell's args on a mesh (``launch.shardings``), and
:func:`shard_cell` distributes them and runs the step under the mesh.
``donate`` belongs to XLA.  A step updates its state's tensors in place.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from ..configs import base as cfgbase
from ..core import csr as csr_mod
from ..core import tree as tree_mod
from ..core import util
from ..models.gnn import common
from ..models.gnn import gcn as gcn_mod
from ..models.gnn import graphcast as graphcast_mod
from ..models.gnn import mace as mace_mod
from ..models.gnn import schnet as schnet_mod
from ..models import sharding_utils as su
from ..models.recsys import two_tower as tt_mod
from ..models.transformer import model as tmodel
from ..sampling import neighbor
from ..train import loop as train_loop
from ..train import optimizer as opt_mod
from . import shardings as shard_mod

GNN_MODULES = {
    "gcn": gcn_mod,
    "schnet": schnet_mod,
    "mace": mace_mod,
    "graphcast": graphcast_mod,
}

OPT_CFG = opt_mod.OptimizerConfig(lr=1e-4, warmup_steps=10, total_steps=1000)
OPT_CFG_BF16 = dataclasses.replace(OPT_CFG, state_dtype=torch.bfloat16)

# grad-accumulation microbatching for LM training (DESIGN.md §5)
LM_TRAIN_ACCUM = 16


@dataclasses.dataclass
class CellProgram:
    """``step_fn(*args)``: ``(state, metrics)`` for a train cell, the
    outputs for a serving cell.  ``meta`` holds the cell's ``cfg``, sizes
    and ``make_step(backend)``; a train cell's also its ``loss(params,
    batch)`` and ``opt_cfg``; a GNN cell's its model ``module`` and
    ``graph(batch)``: the graph dict the model reads for a batch (the
    sampled subgraph, for the sampled cells)."""

    step_fn: Callable
    args: tuple                   # (state, batch)
    meta: dict = dataclasses.field(default_factory=dict)
    #: repro's record of the cell's loops, for launch.roofline
    loop_correction: dict = dataclasses.field(default_factory=dict)

    def with_backend(self, backend: str) -> Callable:
        """The cell's step with its kernels (segment sums, bags, attention)
        on ``backend`` ("torch" is the plain reference on the card)."""
        return self.meta["make_step"](backend)

    def forward(self, params, batch, backend: str = "auto"):
        """A GNN cell's model output for ``batch`` (logits, next state,
        energies)."""
        cfg = dataclasses.replace(self.meta["cfg"], backend=backend)
        return self.meta["module"].forward(params, self.meta["graph"](batch), cfg)


def _tokens(shape, vocab, *, reduced, device, generator):
    """Token ids in [0, vocab): numpy's (seed 1) when reduced, else drawn
    on ``device``."""
    if reduced:
        rng = np.random.default_rng(1)
        return torch.from_numpy(rng.integers(0, vocab, shape).astype(np.int32)).to(device)
    return torch.randint(0, vocab, shape, generator=generator, dtype=torch.int32,
                         device=device)


def _trainable(params):
    """``params`` with every leaf recording grads (the train state's)."""
    return tree_mod.tree_map(lambda p: p.requires_grad_(), params)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------
def _lm_cfg_variant(cfg, variant: str):
    if variant == "full":
        return cfg
    n = {"cost1": 1, "cost2": 2, "cost4": 4}[variant]
    return dataclasses.replace(cfg, n_layers=n)


def _lm_state(cfg, opt_cfg, *, device, generator):
    params = tmodel.init_params(cfg, generator=generator, device=device)
    return train_loop.init_state(_trainable(params), opt_cfg)


def _lm_train_cell(cfg, shape, *, reduced, variant, device, generator):
    # bf16 adam m/v for every full LM train (repro's §Perf iteration 3)
    opt_cfg = OPT_CFG_BF16 if not reduced else OPT_CFG
    if reduced:
        cfg = dataclasses.replace(cfg, n_layers=2)
        seq, gb, accum = 32, 4, 2
    else:
        cfg = _lm_cfg_variant(cfg, variant)
        seq, gb = shape["seq_len"], shape["global_batch"]
        accum = 1 if variant != "full" else LM_TRAIN_ACCUM
    ub = max(gb // LM_TRAIN_ACCUM, 1) if not reduced else gb // accum

    def make_step(backend=cfg.backend):
        c = dataclasses.replace(cfg, backend=backend)
        return train_loop.make_train_step(lambda p, b: tmodel.loss_fn(p, b, c), opt_cfg,
                                          grad_accum=accum)

    state = _lm_state(cfg, opt_cfg, device=device, generator=generator)
    tok_shape = (accum, ub, seq) if accum > 1 else (ub, seq)
    tokens = _tokens(tok_shape, cfg.vocab, reduced=reduced, device=device, generator=generator)
    return CellProgram(
        step_fn=make_step(),
        args=(state, {"tokens": tokens, "labels": tokens}),
        meta={"cfg": cfg, "tokens_per_step": gb * seq, "accum": accum, "opt_cfg": opt_cfg,
              "loss": functools.partial(tmodel.loss_fn, cfg=cfg), "make_step": make_step},
        loop_correction={"kind": "lm_train", "n_layers": cfg.n_layers,
                         "accum": LM_TRAIN_ACCUM},
    )


def _lm_prefill_cell(cfg, shape, *, reduced, variant, device, generator):
    if reduced:
        cfg = dataclasses.replace(cfg, n_layers=2)
        seq, b = 32, 2
    else:
        cfg = _lm_cfg_variant(cfg, variant)
        seq, b = shape["seq_len"], shape["global_batch"]

    def make_step(backend=cfg.backend, **changes):
        c = dataclasses.replace(cfg, backend=backend, **changes)

        @torch.no_grad()
        def step(params, tokens):
            return tmodel.forward(params, tokens, c)[0]
        return step

    params = tmodel.init_params(cfg, generator=generator, device=device)
    tokens = _tokens((b, seq), cfg.vocab, reduced=reduced, device=device, generator=generator)
    return CellProgram(step_fn=make_step(), args=(params, tokens),
                       meta={"cfg": cfg, "make_step": make_step},
                       loop_correction={"kind": "lm_prefill"})


def _lm_decode_cell(cfg, shape, *, reduced, variant, device, generator):
    if reduced:
        cfg = dataclasses.replace(cfg, n_layers=2)
        seq, b = 64, 2
    else:
        cfg = _lm_cfg_variant(cfg, variant)
        seq, b = shape["seq_len"], shape["global_batch"]

    def make_step(backend=cfg.backend, **changes):
        c = dataclasses.replace(cfg, backend=backend, **changes)

        @torch.no_grad()
        def step(params, cache, tokens):
            return tmodel.decode_step(params, cache, tokens, c)
        return step

    params = tmodel.init_params(cfg, generator=generator, device=device)
    cache = tmodel.init_cache(cfg, b, seq, device=device)
    tokens = _tokens((b, 1), cfg.vocab, reduced=reduced, device=device, generator=generator)
    return CellProgram(step_fn=make_step(), args=(params, cache, tokens),
                       meta={"cfg": cfg, "batch": b, "cache_len": seq, "make_step": make_step},
                       loop_correction={"kind": "lm_decode"})


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------
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


def _gnn_train_cell(entry, cfg, shape, *, reduced, variant, device, generator):
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
    if entry.model == "mace" and variant.startswith("chunk"):
        # two-point chunk variants for roofline extrapolation of the
        # chunked density loop (launch/roofline.py)
        cfg = dataclasses.replace(cfg, edge_chunks=int(variant[5:]))
    elif entry.model == "mace" and not reduced and e > 2_000_000 and variant == "full":
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
    lc = {"kind": "gnn"}
    if getattr(cfg, "edge_chunks", 0) > 1:
        lc = {"kind": "gnn_chunked", "chunks": cfg.edge_chunks, "layers": cfg.n_layers}
    return CellProgram(
        step_fn=make_step(cfg.backend),
        args=(state, g),
        meta={"cfg": cfg, "n": n, "e": e, "module": mod, "graph": graph,
              "make_step": make_step},
        loop_correction=lc,
    )


def _gnn_sampled_cell(entry, cfg, shape, *, reduced, variant, device, generator):
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
        or fed the per-hop uniforms ``batch["draws"]`` where given.

        Under a mesh (sharded seeds) the sampler returns the global layers
        on every rank (``neighbor.sample_subgraph``); the subgraph's edges,
        ids and masks, built from them as unsharded, are then placed by
        ``gnn_batch_sharding`` (a local slice of each), and its node arrays
        gathered from the batch's sharded rows by ``common.gather``'s site
        (the rows all-gathered, each rank indexing its own ids)."""
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
        seed_mask = torch.arange(n_sub, device=dev) < seeds_n
        if entry.model in ("mace", "schnet"):
            g["graph_ids"] = torch.zeros((n_sub,), dtype=torch.int32, device=dev)
            g["n_graphs"] = 1
            g["labels"] = torch.zeros((1,), dtype=torch.float32, device=dev)
        if su.is_dtensor(batch["seeds"]):
            g, idx, seed_mask = _placed_subgraph(batch["seeds"].device_mesh,
                                                 (g, idx, seed_mask))

        def rows(key):
            return common.gather(batch[key], idx) if su.is_dtensor(idx) \
                else batch[key].index_select(0, idx)

        g["node_feat"] = rows("node_feat")
        if entry.model in ("mace", "schnet"):
            g["positions"] = rows("positions")
        elif entry.model == "graphcast":
            g["positions"] = rows("positions")
            g["labels"] = rows("labels")
        else:
            # supervise seeds only
            g["labels"] = torch.where(seed_mask, rows("labels"), -1)
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

        if _abstract():  # the dry run: the CSR as empty fakes of its shape
            offsets = torch.empty((n + 1,), dtype=torch.int32, device=device)
            dst = torch.empty((e,), dtype=torch.int32, device=device)
        else:  # the big CSR, built on the card from uniform random edges
            c = csr_mod.from_coo(ints(n, (e,)), ints(n, (e,)), n=n, dedup=False,
                                 device=device)
            offsets, dst = c.offsets, c.dst
            del c
        batch = {"offsets": offsets, "dst": dst, "seeds": ints(n, (seeds_n,))}
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
        loop_correction={"kind": "gnn"},
    )


def _placed_subgraph(mesh, trees):
    """``trees`` of plain tensors, equal on every rank, as ``DTensor``s placed
    by ``gnn_batch_sharding`` (node/edge dim over every axis, where it
    divides): each rank keeps its slice, no collective."""
    from torch.distributed.tensor import DTensor, Replicate

    rep = [Replicate()] * mesh.ndim

    def place(x, pl):
        if not isinstance(x, torch.Tensor):
            return x
        return DTensor.from_local(x, mesh, rep, run_check=False).redistribute(mesh, pl)

    return tuple(tree_mod.tree_map(place, t, shard_mod.gnn_batch_sharding(t, mesh))
                 for t in trees)


# ---------------------------------------------------------------------------
# recsys family
# ---------------------------------------------------------------------------
def _recsys_cell(cfg, shape, *, reduced, variant, device, generator):
    kind = shape["kind"]
    if reduced:
        b, ncand = 8, 64
    else:
        b = shape["batch"]
        ncand = shape.get("n_candidates", 0)
    nf_u, nf_i, k = cfg.n_user_fields, cfg.n_item_fields, cfg.bag_size

    def mk_bags(n, nf):
        # ids in [-1, n_items), -1 padding: practically full bags
        if reduced:
            rng = np.random.default_rng(0)
            return torch.from_numpy(
                rng.integers(-1, cfg.n_items, (n, nf, k)).astype(np.int32)).to(device)
        return torch.randint(-1, cfg.n_items, (n, nf, k), generator=generator,
                             dtype=torch.int32, device=device)

    params = tt_mod.init_params(cfg, generator=generator, device=device)
    if kind == "train":
        def make_step(backend=cfg.backend):
            c = dataclasses.replace(cfg, backend=backend)
            return train_loop.make_train_step(lambda p, bb: tt_mod.loss_fn(p, bb, c), OPT_CFG)

        state = train_loop.init_state(_trainable(params), OPT_CFG)
        batch = {"user_bags": mk_bags(b, nf_u), "item_bags": mk_bags(b, nf_i),
                 "item_logq": torch.zeros((b,), dtype=torch.float32, device=device)}
        return CellProgram(step_fn=make_step(), args=(state, batch),
                           meta={"cfg": cfg, "opt_cfg": OPT_CFG, "make_step": make_step,
                                 "loss": functools.partial(tt_mod.loss_fn, cfg=cfg)},
                           loop_correction={"kind": "recsys"})
    if kind == "serve":
        def make_step(backend=cfg.backend):
            c = dataclasses.replace(cfg, backend=backend)
            return torch.no_grad()(lambda p, batch: tt_mod.serve_step(p, batch, c))

        batch = {"user_bags": mk_bags(b, nf_u), "item_bags": mk_bags(b, nf_i)}
        return CellProgram(step_fn=make_step(), args=(params, batch),
                           meta={"cfg": cfg, "make_step": make_step},
                           loop_correction={"kind": "recsys"})
    # retrieval: 1 query vs n_candidates

    def make_step(backend=cfg.backend):
        c = dataclasses.replace(cfg, backend=backend)
        return torch.no_grad()(lambda p, batch: tt_mod.score_candidates(
            p, batch["user_bags"], batch["cand_bags"], c))

    batch = {"user_bags": mk_bags(1, nf_u), "cand_bags": mk_bags(ncand, nf_i)}
    return CellProgram(step_fn=make_step(), args=(params, batch),
                       meta={"cfg": cfg, "make_step": make_step},
                       loop_correction={"kind": "recsys"})


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def _abstract() -> bool:
    """Whether the cell is built under a ``FakeTensorMode`` (the dry run)."""
    from torch._guards import detect_fake_mode

    return detect_fake_mode() is not None


def build_cell(arch: str, shape_name: str, *, reduced: bool = False, variant: str = "full",
               device="cuda", seed: int = 0, data_axes: tuple = ()) -> CellProgram:
    """The (arch, shape) cell on ``device``; weights and (when not reduced)
    data drawn from a ``torch.Generator`` seeded with ``seed``; the
    config carrying ``data_axes``' activation sharding (module docstring)."""
    entry = cfgbase.get(arch)
    shape = cfgbase.FAMILY_SHAPES[entry.family][shape_name]
    cfg = entry.smoke if reduced else entry.full
    if data_axes:
        # activation sharding constraints (models/sharding_utils.py)
        if entry.family == "lm":
            cfg = dataclasses.replace(cfg, batch_axes=tuple(data_axes), tp_axis="model")
        elif entry.family == "gnn":
            cfg = dataclasses.replace(cfg, shard_axes=tuple(data_axes) + ("model",))
        else:
            cfg = dataclasses.replace(cfg, shard_axes=tuple(data_axes))
    dev = util.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(reduced=reduced, variant=variant, device=dev, generator=gen)
    if entry.family == "lm":
        kind = shape["kind"]
        build = {"train": _lm_train_cell, "prefill": _lm_prefill_cell}.get(kind, _lm_decode_cell)
        cell = build(cfg, shape, **kw)
        cell.meta["full_layers"] = entry.full.n_layers
        cell.loop_correction["full_layers"] = entry.full.n_layers
        return cell
    if entry.family == "gnn":
        if shape["kind"] == "sampled":
            return _gnn_sampled_cell(entry, cfg, shape, **kw)
        return _gnn_train_cell(entry, cfg, shape, **kw)
    return _recsys_cell(cfg, shape, **kw)


def build_opt_cell(arch: str, *, variant: str = "cost1", device="cuda",
                   seed: int = 0) -> CellProgram:
    """Optimizer-apply-only program (LM): one ``OPT_CFG_BF16`` update of the
    ``variant``'s state by float32 grads (drawn N(0, 1) from the seed),
    separating the optimizer's time from the forward and backward."""
    entry = cfgbase.get(arch)
    cfg = _lm_cfg_variant(entry.full, variant.replace("opt", "cost"))
    dev = util.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = _lm_state(cfg, OPT_CFG_BF16, device=dev, generator=gen)
    grads = tree_mod.tree_map(
        lambda p: torch.randn(p.shape, generator=gen, dtype=torch.float32, device=dev),
        state["params"])

    def step(state, grads):
        new_params, new_opt, _ = opt_mod.update(grads, state["opt_state"], state["params"],
                                                OPT_CFG_BF16)
        return {"params": new_params, "opt_state": new_opt}

    return CellProgram(step_fn=step, args=(state, grads),
                       meta={"cfg": cfg, "opt_cfg": OPT_CFG_BF16,
                             "full_layers": entry.full.n_layers},
                       loop_correction={"kind": "lm_opt", "full_layers": entry.full.n_layers})


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------
def attach_shardings(cell: CellProgram, mesh, arch: str, shape_name: str) -> tuple:
    """The placements of the cell's args on ``mesh`` (a ``DeviceMesh`` or
    ``MeshShape``): one tree a arg, each leaf's placements
    (``launch.shardings``; ``repro``'s ``attach_shardings``)."""
    entry = cfgbase.get(arch)
    shape = cfgbase.FAMILY_SHAPES[entry.family][shape_name]
    args = cell.args
    if entry.family == "lm":
        moe = entry.full.moe is not None
        kind = shape["kind"]
        if kind == "train":
            return (shard_mod.lm_state_sharding(args[0], mesh, is_moe=moe),
                    shard_mod.lm_batch_sharding(args[1], mesh))
        p_s = shard_mod.lm_params_sharding(args[0], mesh, is_moe=moe)
        if kind == "prefill":
            return (p_s, shard_mod.lm_infer_batch_sharding(args[1], mesh))
        return (p_s, shard_mod.lm_cache_sharding(args[1], mesh, batch=shape["global_batch"]),
                shard_mod.lm_infer_batch_sharding(args[2], mesh))
    if entry.family == "gnn":
        return (shard_mod.gnn_state_sharding(args[0], mesh),
                shard_mod.gnn_batch_sharding(args[1], mesh))
    return (shard_mod.recsys_state_sharding(args[0], mesh),
            shard_mod.recsys_batch_sharding(args[1], mesh))


def shard_cell(cell: CellProgram, placements: tuple, mesh) -> CellProgram:
    """The cell with its args distributed over ``mesh`` (``distribute_tensor``
    of each tensor leaf to its placements, without a broadcast: every rank
    drew the same tensors from the seed and keeps a copy of its own shard,
    so the drawn tensors go with the unsharded cell; host values stay as
    they are) and its step run under the mesh
    (``sharding_utils.use_mesh``, with plain tensors the step makes, such
    as positions and masks, taken as replicated)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    def dist_leaf(x, pl):
        if not isinstance(x, torch.Tensor):
            return x
        d = distribute_tensor(x.detach(), mesh, pl, src_data_rank=None)
        local = su.no_grad_local(d)
        if local.untyped_storage().nbytes() > local.nbytes:
            # a slice of the drawn tensor: keep a copy, so the drawn tensor
            # is freed with the unsharded cell
            d = DTensor.from_local(local.clone(), mesh, pl, run_check=False, shape=d.shape,
                                   stride=d.stride())
        return d.requires_grad_(x.requires_grad)

    args = tuple(tree_mod.tree_map(dist_leaf, a, p) for a, p in zip(cell.args, placements))

    def on_mesh(step):
        def run(*a):
            with su.use_mesh(mesh), implicit_replication():
                return step(*a)
        return run

    meta = dict(cell.meta)
    if "make_step" in meta:
        make = meta["make_step"]  # not ``cell``, whose drawn args it would keep alive
        meta["make_step"] = lambda *a, **k: on_mesh(make(*a, **k))
    return dataclasses.replace(cell, step_fn=on_mesh(cell.step_fn), args=args, meta=meta)
