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
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


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
    layers = [seeds]
    masks = [torch.ones(seeds.shape, dtype=torch.bool, device=seeds.device)]
    blocks: list[SampledBlock] = []
    for h, f in enumerate(fanouts):
        f = int(f)
        cur = layers[-1]
        cur_mask = masks[-1]
        if draws is None:
            neigh, valid = sample_hop(generator, offsets, dst, cur, cur_mask, f)
        else:
            neigh, valid = pick(offsets, dst, cur, cur_mask, draws[h])
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
        layers.append(neigh.reshape(-1))
        masks.append(valid.reshape(-1))
    return blocks, layers, masks


def flat_sizes(batch_nodes: int, fanouts: Sequence[int]) -> list[int]:
    """Frontier sizes per layer for static shape planning."""
    sizes = [batch_nodes]
    for f in fanouts:
        sizes.append(sizes[-1] * int(f))
    return sizes
