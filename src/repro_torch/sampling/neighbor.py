"""GraphSAGE-style fanout neighbor sampler (minibatch_lg shape).

The counterpart of ``repro.sampling.neighbor``.  Samples a k-hop
neighborhood subgraph around seed nodes from a CSR with per-hop fanouts
(e.g. 15-10).  Output shapes are static (seeds × Π fanouts): each seed
picks ``fanout`` uniform slots of its row, with replacement; seeds without
neighbours (or masked) give masked picks.

``repro`` draws its uniforms with ``jax.random``, which torch cannot
reproduce, so a hop is split into a draw and a pick: ``pick`` takes the
uniforms, ``sample_hop`` draws them from a ``torch.Generator``, and
``sample_subgraph`` takes either a generator or the draws themselves (the
tests hand both packages the same uniforms).

Under a mesh (``seeds`` a ``DTensor``, ``launch.shardings.
gnn_batch_sharding``: block-sharded over every axis) each rank samples its
own seeds' subtrees (:func:`_sharded_layers`): layer h's frontier is
seed-major, so a rank's block of seeds owns the same block of every
layer, and no hop needs another rank's picks.  The picks are then
all-gathered into the global layer-major order, so the blocks, layers and
masks are the unsharded ones, bit for bit, on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..models import sharding_utils as su


@dataclasses.dataclass(frozen=True)
class SampledBlock:
    """One hop: edges (dst_node_idx -> src_node_idx) in *local* numbering."""

    src_nodes: torch.Tensor   # [n_src] global ids of source (sampled) nodes
    edge_src: torch.Tensor    # [n_edges] local index into src_nodes
    edge_dst: torch.Tensor    # [n_edges] local index into the previous layer
    mask: torch.Tensor        # [n_edges] valid edge


def pick(offsets, dst, seeds, seed_mask, r):
    """Pick neighbours with the uniforms ``r`` [S, fanout] in [0, 1).

    Returns (neigh [S, fanout] global ids, valid [S, fanout]); invalid picks
    hold 0.
    """
    start = offsets.index_select(0, seeds)
    deg = offsets.index_select(0, seeds + 1) - start
    slot = (r * torch.clamp(deg, min=1)[:, None]).to(torch.int32)
    idx = start[:, None] + slot
    neigh = dst[torch.clamp(idx, 0, dst.shape[0] - 1).long()]
    valid = ((deg[:, None] > 0) & seed_mask[:, None]).expand(r.shape)
    return torch.where(valid, neigh, 0), valid


def sample_hop(generator: torch.Generator, offsets, dst, seeds, seed_mask, fanout: int):
    """Sample ``fanout`` neighbors per seed (with replacement), drawing the
    uniforms from ``generator`` (on the seeds' device)."""
    r = torch.rand((seeds.shape[0], int(fanout)), generator=generator,
                   dtype=torch.float32, device=seeds.device)
    return pick(offsets, dst, seeds, seed_mask, r)


def sample_subgraph(
    generator: Optional[torch.Generator],
    offsets: torch.Tensor,
    dst: torch.Tensor,
    seeds: torch.Tensor,
    fanouts: Sequence[int],
    *,
    draws: Optional[Sequence[torch.Tensor]] = None,
):
    """Multi-hop sampled subgraph, GraphSAGE layout.

    Layer 0 = seeds; layer h = neighbors of layer h-1 (flattened).  Returns
    a list of SampledBlock (outermost hop first, as consumed by a GNN that
    aggregates inward) plus the full node frontier per layer.  Hop h takes
    its uniforms from ``draws[h]`` ([frontier, fanout]) when given, else
    from ``generator``.
    """
    if su.is_dtensor(seeds):
        layers, masks = _sharded_layers(generator, offsets, dst, seeds, fanouts, draws)
        picks = list(zip(layers[1:], masks[1:]))
    else:
        layers = [seeds]
        masks = [torch.ones(seeds.shape, dtype=torch.bool, device=seeds.device)]
        picks = None
    blocks: list[SampledBlock] = []
    for h, f in enumerate(fanouts):
        f = int(f)
        cur = layers[h]
        if picks is not None:
            neigh, valid = picks[h]
        elif draws is None:
            neigh, valid = sample_hop(generator, offsets, dst, cur, masks[h], f)
        else:
            neigh, valid = pick(offsets, dst, cur, masks[h], draws[h])
        n_prev = cur.shape[0]
        local = torch.arange(n_prev * f, dtype=torch.int32, device=cur.device)
        blocks.append(
            SampledBlock(
                src_nodes=neigh.reshape(-1),
                edge_src=local,
                edge_dst=local // f,
                mask=valid.reshape(-1),
            )
        )
        if picks is None:
            layers.append(neigh.reshape(-1))
            masks.append(valid.reshape(-1))
    return blocks, layers, masks


def _sharded_layers(generator, offsets, dst, seeds, fanouts, draws):
    """Every layer and mask of the sampled subgraph, global and plain on
    every rank, from a mesh's sharded ``seeds`` (``local_map`` sites).

    Placement rule: ``seeds`` ``Shard(0)`` or ``Replicate()`` on each mesh
    dim, splitting evenly; the CSR (``offsets``, ``dst``) replicated (an
    all-gather of ``dst`` where it is sharded: every rank reads any row).
    Hop h's uniforms are the global ``[frontier, fanout]`` tensor, drawn
    from ``generator`` on every rank in the unsharded order (or
    ``draws[h]``, a tensor or a ``DTensor``), of which each rank uses its
    own rows (a frontier shards as its seeds: a ``DTensor`` placed so
    already gives them).  The picks and masks (as uint8) are all-gathered into
    the layer-major order after the last hop.  Any other placement of the
    seeds raises.
    """
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, s_pl = seeds.device_mesh, tuple(seeds.placements)
    for p in s_pl:
        if not (p.is_replicate() or p.is_shard(0)):
            raise ValueError(f"sampler: seeds placed {s_pl}; each mesh dim must shard dim 0 "
                             f"or replicate")
    su.requires_even(seeds, 0, "sampler")
    rep = (Replicate(),) * mesh.ndim
    offsets, dst = (t.redistribute(mesh, rep) if su.is_dtensor(t)
                    else DTensor.from_local(t, mesh, rep, run_check=False)
                    for t in (offsets, dst))
    n_local = su.no_grad_local(seeds).shape[0]
    part, ways = su.local_offset(seeds, 0) // n_local, seeds.shape[0] // n_local
    sizes = flat_sizes(seeds.shape[0], fanouts)

    def hop(off_, dst_, cur_, mask_, r_):
        neigh, valid = pick(off_, dst_, cur_, mask_.bool(), r_)
        return neigh.reshape(-1), valid.reshape(-1).to(torch.uint8)

    site = local_map(hop, out_placements=(list(s_pl), list(s_pl)),
                     in_placements=(rep, rep, s_pl, s_pl, s_pl), device_mesh=mesh)
    cur = seeds
    cur_mask = DTensor.from_local(
        torch.ones((n_local,), dtype=torch.uint8, device=seeds.device), mesh, s_pl,
        run_check=False)
    layers, masks = [], []
    for h, f in enumerate(fanouts):
        if draws is None:
            r = torch.rand((sizes[h], int(f)), generator=generator, dtype=torch.float32,
                           device=seeds.device)
        else:
            r = draws[h]
        if not (su.is_dtensor(r) and tuple(r.placements) == s_pl):
            if su.is_dtensor(r):
                r = r.redistribute(mesh, rep).to_local()
            rows = sizes[h] // ways
            r = DTensor.from_local(r[part * rows:(part + 1) * rows], mesh, s_pl,
                                   run_check=False)
        cur, cur_mask = site(offsets, dst, cur, cur_mask, r)
        layers.append(cur)
        masks.append(cur_mask)
    full = [t.redistribute(mesh, rep).to_local() for t in layers + masks]
    k = len(fanouts)
    return ([su.no_grad_local(seeds.redistribute(mesh, rep))] + full[:k],
            [torch.ones(seeds.shape, dtype=torch.bool, device=seeds.device)]
            + [m.bool() for m in full[k:]])


def flat_sizes(batch_nodes: int, fanouts: Sequence[int]) -> list[int]:
    """Frontier sizes per layer for static shape planning."""
    sizes = [batch_nodes]
    for f in fanouts:
        sizes.append(sizes[-1] * int(f))
    return sizes
