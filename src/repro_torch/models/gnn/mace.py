"""MACE (arXiv:2206.07697): higher-order E(3)-equivariant message passing,
l_max=2, correlation order 3 — in **Cartesian tensor form**.

The counterpart of ``repro.models.gnn.mace``.  For l_max ≤ 2 the irreps
are exactly {scalar, vector, traceless-symmetric matrix}, and every
Clebsch-Gordan coupling is a classical vector/tensor product:

    0⊗0→0: s·s      1⊗1→0: v·v        2⊗2→0: T:T
    0⊗1→1: s·v      1⊗1→1: v×v        2⊗1→1: T·v
    1⊗1→2: sym₀(v⊗v)  0⊗2→2: s·T      2⊗2→2: sym₀(T·T)

All are einsums, equivariant by construction.  The ACE density A is built
per edge from radial (Bessel) × angular (r̂ tensors) × neighbor features
and summed into the nodes: three segment sums a layer, of [E, C], [E, C, 3]
and [E, C, 3, 3] messages, each one ``edge_segment_runs`` launch on the
card over rows of C, 3C and 9C floats.  The product basis B applies the
coupling table recursively to correlation order 3; readout takes invariant
(scalar) channels.  Energy is extensive (sum of site energies); forces
come from ``torch.autograd.grad`` and are equivariant by composition.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ...core import util
from .. import sharding_utils as su
from ..param_tree import tensors_from_numpy
from . import common


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128          # channels per irrep
    l_max: int = 2
    correlation_order: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 100
    # edge-chunked density aggregation: bounds the per-edge rank-2 tensor
    # working set to chunk·C·9 floats (needed for 10⁷–10⁸-edge graphs);
    # 0 = unchunked.  The aggregation is linear in edges, so chunking is
    # exact: each chunk's density is recomputed in the backward
    # (torch.utils.checkpoint), so one chunk's working set is live at a time.
    edge_chunks: int = 0
    shard_axes: tuple = ()   # mesh axes for node/edge dim-0 sharding
    backend: str = "auto"    # the segment sums: "auto" | "cuda" | "torch"


# --- Cartesian irrep algebra -------------------------------------------------
def sym0(t):
    """Symmetric traceless part of [..., 3, 3]."""
    s = 0.5 * (t + t.transpose(-1, -2))
    # the trace as a sum of the three diagonal elements: DTensor on torch
    # 2.11 has no rule for ``diagonal``'s backward
    tr = (s[..., 0, 0] + s[..., 1, 1] + s[..., 2, 2])[..., None, None]
    return s - tr * torch.eye(3, dtype=t.dtype, device=t.device) / 3.0


def _cross(a, b):
    """The cross product over the last dim; under a mesh on each rank's rows
    (``local_map``: DTensor on torch 2.11 has no rule for it), both placed
    as ``a``'s rows with whole vectors (partial sums reduced first)."""
    if not su.is_dtensor(a):
        return torch.linalg.cross(a, b, dim=-1)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    last = a.ndim - 1
    pl = tuple(Replicate() if p.is_partial() or p.is_shard(last) else p
               for p in a.placements)
    a, b = (t if tuple(t.placements) == pl else t.redistribute(a.device_mesh, pl)
            for t in (a, b))
    return local_map(lambda x, y: torch.linalg.cross(x, y, dim=-1), out_placements=list(pl),
                     in_placements=(pl, pl), device_mesh=a.device_mesh)(a, b)


def pairwise_product(a, b, w):
    """All CG couplings of feature dicts a,b -> feature dict.

    a,b: {"s":[...,C], "v":[...,C,3], "t":[...,C,3,3]}; w: per-path
    per-channel weights {"path_name": [C]}.
    """
    ein = torch.einsum
    s = (
        w["ss_s"] * a["s"] * b["s"]
        + w["vv_s"] * ein("...ci,...ci->...c", a["v"], b["v"])
        + w["tt_s"] * ein("...cij,...cij->...c", a["t"], b["t"])
    )
    v = (
        w["sv_v"][:, None] * a["s"][..., None] * b["v"]
        + w["vs_v"][:, None] * b["s"][..., None] * a["v"]
        + w["vv_v"][:, None] * _cross(a["v"], b["v"])
        + w["tv_v"][:, None] * ein("...cij,...cj->...ci", a["t"], b["v"])
        + w["vt_v"][:, None] * ein("...cij,...cj->...ci", b["t"], a["v"])
    )
    t = (
        w["vv_t"][:, None, None] * sym0(ein("...ci,...cj->...cij", a["v"], b["v"]))
        + w["st_t"][:, None, None] * a["s"][..., None, None] * b["t"]
        + w["ts_t"][:, None, None] * b["s"][..., None, None] * a["t"]
        + w["tt_t"][:, None, None] * sym0(ein("...cik,...ckj->...cij", a["t"], b["t"]))
    )
    return {"s": s, "v": v, "t": t}


_PATHS = ["ss_s", "vv_s", "tt_s", "sv_v", "vs_v", "vv_v", "tv_v", "vt_v",
          "vv_t", "st_t", "ts_t", "tt_t"]


def bessel_basis(r, cfg: MACEConfig):
    n = torch.arange(1, cfg.n_rbf + 1, dtype=torch.float32, device=r.device)
    rc = cfg.cutoff
    rs = torch.clamp(r, min=1e-6)[:, None]
    norm = float(np.sqrt(np.float32(2.0 / rc)))  # float32's sqrt, as jnp.sqrt takes it
    basis = norm * torch.sin(n * math.pi * rs / rc) / rs
    # polynomial cutoff envelope (p=6)
    u = torch.clamp(r / rc, 0, 1)[:, None]
    env = 1 - 28 * u**6 + 48 * u**7 - 21 * u**8
    return basis * env


def init_params(cfg: MACEConfig, *, generator: torch.Generator, device):
    c = cfg.d_hidden

    def normal(shape, scale):
        return common.normal(generator, shape, scale, device)

    params = {
        "embed": normal((cfg.n_species, c), 0.3),
        "layers": [],
        "readout": common.init_mlp(generator, [c, c // 2, 1], device=device),
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            # radial MLP -> per-channel weights for the 3 A-paths
            "radial": common.init_mlp(generator, [cfg.n_rbf, 32, 3 * c], device=device),
            "mix_s": normal((c, c), c**-0.5),
            "mix_v": normal((c, c), c**-0.5),
            "mix_t": normal((c, c), c**-0.5),
            "prod2": {p: normal((c,), 0.5) for p in _PATHS},
            "prod3": {p: normal((c,), 0.5) for p in _PATHS},
            "res": normal((c, c), c**-0.5),
            "layer_readout": common.init_mlp(generator, [c, 1], device=device),
        })
    return params


def forward(params, g: dict, cfg: MACEConfig):
    """g: {node_feat [N] species, positions [N,3], edge_src, edge_dst,
    graph_ids?, n_graphs?} -> per-graph energies."""
    species = g["node_feat"].to(torch.int32)
    pos = g["positions"].to(torch.float32)
    src, dst = g["edge_src"], g["edge_dst"]
    n = pos.shape[0]
    c = cfg.d_hidden
    embed = params["embed"]

    def zeros(*shape):  # node-shaped zeros, placed as the nodes under a mesh
        return common.node_zeros(pos, shape)

    h = {
        "s": common.embed_rows(embed, species),
        "v": zeros(n, c, 3),
        "t": zeros(n, c, 3, 3),
    }
    energies = zeros(n)

    def density(lp, h, src_e, dst_e):
        """A-density contribution of an edge set (exact; linear in edges)."""
        rel = common.gather(pos, src_e) - common.gather(pos, dst_e)
        emask = ((src_e < n) & (dst_e < n)).to(torch.float32)
        r = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12)
        rhat = rel / torch.clamp(r, min=1e-6)[:, None]
        y1 = rhat
        y2 = sym0(torch.einsum("ei,ej->eij", rhat, rhat)[:, None])[:, 0]
        rbf = bessel_basis(r, cfg) * emask[:, None]
        rw = common.mlp(lp["radial"], rbf).reshape(-1, 3, c)
        hs = common.gather(h["s"], src_e)
        hv = common.gather(h["v"], src_e)
        ht = common.gather(h["t"], src_e)
        a_s = rw[:, 0] * hs
        a_v = rw[:, 1][..., None] * (hs[..., None] * y1[:, None, :] + hv)
        a_t = rw[:, 2][..., None, None] * (hs[..., None, None] * y2[:, None] + ht)
        sx = cfg.shard_axes
        return {
            "s": su.maybe_constrain(common.aggregate(a_s, dst_e, n, backend=cfg.backend), sx),
            "v": su.maybe_constrain(common.aggregate(a_v, dst_e, n, backend=cfg.backend), sx),
            "t": su.maybe_constrain(common.aggregate(a_t, dst_e, n, backend=cfg.backend), sx),
        }

    chunks = None
    if cfg.edge_chunks > 1:
        # the chunks' id tensors are made once, so each keeps its cached
        # sort through every layer and the recomputation in the backward
        chunks = common.edge_chunks(src, dst, n, cfg.edge_chunks)

    for lp in params["layers"]:
        if chunks is not None:
            agg = {"s": zeros(n, c), "v": zeros(n, c, 3), "t": zeros(n, c, 3, 3)}
            for s_c, d_c in chunks:
                contrib = checkpoint(density, lp, h, s_c, d_c, use_reentrant=False,
                                     context_fn=su.remat_context)
                agg = {k: agg[k] + contrib[k] for k in agg}
        else:
            agg = density(lp, h, src, dst)
        # channel mixing
        A = {
            "s": agg["s"] @ lp["mix_s"],
            "v": torch.einsum("nci,cd->ndi", agg["v"], lp["mix_v"]),
            "t": torch.einsum("ncij,cd->ndij", agg["t"], lp["mix_t"]),
        }
        # product basis: correlation order 2 and 3
        B2 = pairwise_product(A, A, lp["prod2"])
        B3 = pairwise_product(B2, A, lp["prod3"])
        h = {
            "s": su.maybe_constrain(h["s"] @ lp["res"] + A["s"] + B2["s"] + B3["s"],
                                    cfg.shard_axes),
            "v": su.maybe_constrain(A["v"] + B2["v"] + B3["v"], cfg.shard_axes),
            "t": su.maybe_constrain(A["t"] + B2["t"] + B3["t"], cfg.shard_axes),
        }
        energies = energies + common.mlp(lp["layer_readout"], h["s"])[:, 0]
    energies = energies + common.mlp(params["readout"], h["s"])[:, 0]
    gid = g.get("graph_ids")
    if gid is None:
        return energies.sum().reshape(1)
    return common.segment_sum(energies, gid, int(g["n_graphs"]), backend=cfg.backend)


def loss_fn(params, g: dict, cfg: MACEConfig):
    energy = forward(params, g, cfg)
    target = g["labels"].to(torch.float32)
    mse = torch.mean((energy - target) ** 2)
    return mse, {"mse": mse}


def forces(params, g: dict, cfg: MACEConfig):
    """F = -∂E/∂pos."""
    with torch.enable_grad():
        pos = g["positions"].to(torch.float32).detach().requires_grad_(True)
        energy = forward(params, {**g, "positions": pos}, cfg).sum()
        (grad,) = torch.autograd.grad(energy, pos)
    return -grad


def init_model(cfg: MACEConfig, *, generator: torch.Generator,
               device="cuda") -> common.GNNModel:
    """Random weights as ``repro``'s ``init_params`` draws them, from
    ``generator`` (on ``device``), on ``device``."""
    dev = util.resolve_device(device)
    return common.GNNModel(init_params(cfg, generator=generator, device=dev), cfg, forward)


def from_jax_params(params_np, cfg: MACEConfig, *, device="cuda") -> common.GNNModel:
    """A model holding ``repro``'s ``init_params`` pytree, given as numpy arrays."""
    return common.GNNModel(tensors_from_numpy(params_np, device=device), cfg, forward)
