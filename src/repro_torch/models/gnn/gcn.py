"""GCN (Kipf & Welling, arXiv:1609.02907) — gcn-cora config.

The counterpart of ``repro.models.gnn.gcn``.
Ĥ = σ( D̃^{-1/2} Ã D̃^{-1/2} H W ) via gather + segment sum; the SpMM is
exactly the paper's traversal primitive, so the dynamic-update benchmarks
run GCN forward passes on updated graphs (paper §4.2.5 analogue).  The
degrees are the destination counts of the sorted edges (``degree_offsets``)
and each layer's aggregate is one ``edge_segment_runs`` launch on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from ...core import util
from .. import sharding_utils as su
from ..param_tree import tensors_from_numpy
from . import common


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_hidden: int = 16
    d_in: int = 1433
    n_classes: int = 7
    aggregator: str = "mean"
    norm: str = "sym"
    dropout: float = 0.5
    shard_axes: tuple = ()   # mesh axes for node/edge dim-0 sharding
    backend: str = "auto"    # the segment sums: "auto" | "cuda" | "torch"


def init_params(cfg: GCNConfig, *, generator: torch.Generator, device):
    sizes = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {"layers": [
        {"w": common.normal(generator, (sizes[i], sizes[i + 1]), sizes[i] ** -0.5, device),
         "b": torch.zeros((sizes[i + 1],), dtype=torch.float32, device=device)}
        for i in range(cfg.n_layers)
    ]}


def forward(params, g: dict, cfg: GCNConfig):
    """g: {node_feat [N,F], edge_src [E], edge_dst [E]} (+self-loops added)."""
    x = g["node_feat"].to(torch.float32)
    n = x.shape[0]
    src, dst = g["edge_src"], g["edge_dst"]
    deg = common.segment_counts(dst, n, backend=cfg.backend) + 1.0
    inv_sqrt = torch.rsqrt(deg)
    x = su.maybe_constrain(x, cfg.shard_axes)
    for i, lp in enumerate(params["layers"]):
        h = x @ lp["w"] + lp["b"]
        if cfg.norm == "sym":
            msg = common.gather(h * inv_sqrt[:, None], src)
            agg = common.aggregate(msg, dst, n, backend=cfg.backend) * inv_sqrt[:, None]
            agg = agg + h / deg[:, None]  # self loop
        else:
            msg = common.gather(h, src)
            agg = common.aggregate(msg, dst, n, mode=cfg.aggregator,
                                   backend=cfg.backend) + h
        x = torch.relu(agg) if i < len(params["layers"]) - 1 else agg
        x = su.maybe_constrain(x, cfg.shard_axes)
    return x


def loss_fn(params, g: dict, cfg: GCNConfig):
    logits = forward(params, g, cfg)
    labels = g["labels"]
    mask = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, torch.clamp(labels, min=0).long()[:, None])[:, 0]
    ce = torch.where(mask, lse - gold, 0.0).sum() / torch.clamp(mask.sum(), min=1)
    return ce, {"ce": ce}


def init_model(cfg: GCNConfig, *, generator: torch.Generator,
               device="cuda") -> common.GNNModel:
    """Random weights as ``repro``'s ``init_params`` draws them (N(0,1)/sqrt(fan_in),
    zero biases), from ``generator`` (on ``device``), on ``device``."""
    dev = util.resolve_device(device)
    return common.GNNModel(init_params(cfg, generator=generator, device=dev), cfg, forward)


def from_jax_params(params_np, cfg: GCNConfig, *, device="cuda") -> common.GNNModel:
    """A model holding ``repro``'s ``init_params`` pytree, given as numpy arrays."""
    return common.GNNModel(tensors_from_numpy(params_np, device=device), cfg, forward)
