"""GraphCast (arXiv:2212.12794): encoder-processor-decoder mesh GNN.

The counterpart of ``repro.models.gnn.graphcast``.  Assigned-shape
adaptation (DESIGN.md §4): the benchmark shapes provide a single graph, so
grid2mesh/mesh2grid bipartite graphs collapse onto it — encoder/decoder
become per-node MLPs (227 vars ↔ 512 latent) and the processor is the full
16-layer interaction network over the mesh edges (edge MLP on [e, h_src,
h_dst] → sum-aggregate → node MLP, residual), which is where GraphCast's
compute lives.  Each processor layer's aggregate is one
``edge_segment_runs`` launch on the card.

``remat`` recomputes each processor layer in the backward
(``torch.utils.checkpoint``, non-reentrant); ``bf16`` casts the
parameters to bfloat16 on every forward, as ``repro`` does, and the
aggregate sums the bfloat16 messages in float32.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ...core import tree as tree_mod
from ...core import util
from .. import sharding_utils as su
from ..param_tree import tensors_from_numpy
from . import common


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    n_vars: int = 227
    mesh_refinement: int = 6
    aggregator: str = "sum"
    shard_axes: tuple = ()   # mesh axes for node/edge dim-0 sharding
    remat: bool = False      # checkpoint each processor layer (large graphs)
    bf16: bool = False       # bf16 edge/node latents (halves residual memory)
    backend: str = "auto"    # the segment sums: "auto" | "cuda" | "torch"


def init_params(cfg: GraphCastConfig, *, generator: torch.Generator, device):
    d = cfg.d_hidden

    def mlp(sizes):
        return common.init_mlp(generator, sizes, device=device)

    params = {
        "encoder": mlp([cfg.n_vars, d, d]),
        "edge_embed": mlp([4, d, d]),  # (rel dist feats)
        "decoder": mlp([d, d, cfg.n_vars]),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({"edge_mlp": mlp([3 * d, d, d]), "node_mlp": mlp([2 * d, d, d])})
    return params


def forward(params, g: dict, cfg: GraphCastConfig):
    """g: {node_feat [N, n_vars], edge_src, edge_dst} -> next-state [N, n_vars]."""
    x = g["node_feat"].to(torch.float32)
    src, dst = g["edge_src"], g["edge_dst"]
    n = x.shape[0]
    cd = torch.bfloat16 if cfg.bf16 else torch.float32
    params = tree_mod.tree_map(lambda p: p.to(cd), params)
    h = common.mlp(params["encoder"], x.to(cd))
    # structural edge features: degree-ish placeholders when no positions
    if g.get("positions") is not None:
        pos = g["positions"].to(torch.float32)
        rel = common.gather(pos, src) - common.gather(pos, dst)
        r = torch.sqrt(torch.sum(rel * rel, dim=-1, keepdim=True) + 1e-12)
        ef = torch.cat([rel, r], dim=-1).to(cd)
    else:
        ef = torch.zeros((src.shape[0], 4), dtype=cd, device=x.device)
    e = su.maybe_constrain(common.mlp(params["edge_embed"], ef), cfg.shard_axes)
    # N << E: node latents replicated (explicitly), edge tensors sharded over
    # all axes; the aggregate becomes one all-reduce of [N, d] a layer
    # (repro's §Perf iteration 4)
    if cfg.shard_axes:
        h = su.constrain(h)  # replicated

    def layer(lp, e, h):
        hs = common.gather(h, src)
        hd = common.gather(h, dst)
        e = e + common.mlp(lp["edge_mlp"], torch.cat([e, hs, hd], dim=-1))
        e = su.maybe_constrain(e, cfg.shard_axes)
        agg = common.aggregate(e, dst, n, mode=cfg.aggregator, backend=cfg.backend)
        if cfg.shard_axes:
            agg = su.constrain(agg)  # all-reduce partial node sums
        h = h + common.mlp(lp["node_mlp"], torch.cat([h, agg], dim=-1))
        return e, h

    for lp in params["layers"]:
        if cfg.remat:  # recompute the processor layer's activations in the backward
            e, h = checkpoint(layer, lp, e, h, use_reentrant=False,
                              context_fn=su.remat_context)
        else:
            e, h = layer(lp, e, h)
    return x + common.mlp(params["decoder"], h).to(torch.float32)  # residual


def loss_fn(params, g: dict, cfg: GraphCastConfig):
    pred = forward(params, g, cfg)
    target = g["labels"].to(torch.float32)
    mse = torch.mean((pred - target) ** 2)
    return mse, {"mse": mse}


def init_model(cfg: GraphCastConfig, *, generator: torch.Generator,
               device="cuda") -> common.GNNModel:
    """Random weights as ``repro``'s ``init_params`` draws them, from
    ``generator`` (on ``device``), on ``device``."""
    dev = util.resolve_device(device)
    return common.GNNModel(init_params(cfg, generator=generator, device=dev), cfg, forward)


def from_jax_params(params_np, cfg: GraphCastConfig, *, device="cuda") -> common.GNNModel:
    """A model holding ``repro``'s ``init_params`` pytree, given as numpy arrays."""
    return common.GNNModel(tensors_from_numpy(params_np, device=device), cfg, forward)
