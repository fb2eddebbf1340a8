"""SchNet (arXiv:1706.08566): continuous-filter convolutions.

The counterpart of ``repro.models.gnn.schnet``.  cfconv: filter W(r_ij)
from an RBF expansion of interatomic distance, message = filter ⊙ h_j,
aggregated with a segment sum (one ``edge_segment_runs`` launch an
interaction on the card, and one for the per-graph energy readout).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ...core import util
from .. import sharding_utils as su
from ..param_tree import tensors_from_numpy
from . import common


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 100
    shard_axes: tuple = ()   # mesh axes for node/edge dim-0 sharding
    backend: str = "auto"    # the segment sums: "auto" | "cuda" | "torch"


def init_params(cfg: SchNetConfig, *, generator: torch.Generator, device):
    d = cfg.d_hidden
    params = {
        "embed": common.normal(generator, (cfg.n_species, d), 0.1, device),
        "interactions": [],
        "readout": common.init_mlp(generator, [d, d // 2, 1], device=device),
    }
    for _ in range(cfg.n_interactions):
        params["interactions"].append(
            {
                "filter": common.init_mlp(generator, [cfg.n_rbf, d, d], device=device),
                "in_lin": common.init_mlp(generator, [d, d], device=device),
                "out": common.init_mlp(generator, [d, d, d], device=device),
            }
        )
    return params


def linspace(stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(0.0, stop, num)`` in float32, by ``jax``'s formula
    (``stop * (i / (num - 1))``, the last point ``stop`` itself)."""
    if num == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / float(num - 1)
    return torch.cat([stop * step, torch.full((1,), stop, dtype=torch.float32,
                                              device=device)])


def rbf_expand(r, cfg: SchNetConfig):
    centers = linspace(cfg.cutoff, cfg.n_rbf, r.device)
    gamma = cfg.n_rbf / cfg.cutoff
    return torch.exp(-gamma * (r[:, None] - centers[None, :]) ** 2)


def forward(params, g: dict, cfg: SchNetConfig):
    """g: {node_feat [N] int species, positions [N,3], edge_src, edge_dst}."""
    species = g["node_feat"].to(torch.int32)
    pos = g["positions"].to(torch.float32)
    src, dst = g["edge_src"], g["edge_dst"]
    n = pos.shape[0]
    embed = params["embed"]
    h = common.embed_rows(embed, species)
    rel = common.gather(pos, dst) - common.gather(pos, src)
    mask = (src < n) & (dst < n)
    r = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12)
    rbf = rbf_expand(r, cfg) * mask[:, None]
    # smooth cutoff (cosine)
    fc = 0.5 * (torch.cos(math.pi * torch.clamp(r / cfg.cutoff, 0, 1)) + 1.0)
    rbf = su.maybe_constrain(rbf, cfg.shard_axes)
    h = su.maybe_constrain(h, cfg.shard_axes)
    for ip in params["interactions"]:
        w = common.mlp(ip["filter"], rbf) * fc[:, None]
        hj = common.mlp(ip["in_lin"], h)
        msg = su.maybe_constrain(common.gather(hj, src) * w, cfg.shard_axes)
        agg = common.aggregate(msg, dst, n, backend=cfg.backend)
        h = su.maybe_constrain(h + common.mlp(ip["out"], agg), cfg.shard_axes)
    site_e = common.mlp(params["readout"], h)[:, 0]           # [N]
    gid = g.get("graph_ids")
    if gid is None:
        return site_e.sum().reshape(1)
    return common.segment_sum(site_e, gid, int(g["n_graphs"]), backend=cfg.backend)


def loss_fn(params, g: dict, cfg: SchNetConfig):
    energy = forward(params, g, cfg)
    target = g["labels"].to(torch.float32)
    mse = torch.mean((energy - target) ** 2)
    return mse, {"mse": mse}


def init_model(cfg: SchNetConfig, *, generator: torch.Generator,
               device="cuda") -> common.GNNModel:
    """Random weights as ``repro``'s ``init_params`` draws them, from
    ``generator`` (on ``device``), on ``device``."""
    dev = util.resolve_device(device)
    return common.GNNModel(init_params(cfg, generator=generator, device=dev), cfg, forward)


def from_jax_params(params_np, cfg: SchNetConfig, *, device="cuda") -> common.GNNModel:
    """A model holding ``repro``'s ``init_params`` pytree, given as numpy arrays."""
    return common.GNNModel(tensors_from_numpy(params_np, device=device), cfg, forward)
