"""Shared GNN infrastructure: padded graph batches + segment message passing.

The counterpart of ``repro.models.gnn.common``.  Message passing is a
gather over an edge index and a segment sum into the destination nodes
(DESIGN.md: the edge arrays come straight from the core CSR/DiGraph
representations).  ``repro`` sums with ``jax.ops.segment_sum``; here every
segment sum goes through ``kernels/edge_segment_sum`` (the hand-written
``edge_segment_runs`` kernel for CUDA tensors, its plain version for CPU
tensors), whose contract is ascending rows.  GNN edges are not sorted, so
a sum first takes a stable sort of its segment ids (``EdgeOrder``), made
once per id tensor and cached on it: every layer of a forward, the
backward and ``segment_mean``'s counts reuse it.

Under a mesh (``models.sharding_utils``) the graph's node and edge arrays
are ``DTensor``s block-sharded on dim 0 (``launch.shardings.
gnn_batch_sharding``: every axis) and the parameters replicated.  The two
sites that read edges run on each rank's own edges through ``local_map``:

* :func:`segment_sum` (the ``edge_segment_runs`` kernel): each rank sums
  its edges into all ``num`` segments, so the output is ``Partial(sum)``
  on every mesh dim that shards the edges; the messages follow their edges
  (redistributed to the edge placement, a no-op when they are there) and
  the sum is reduced where ``repro``'s constraint asks (``maybe_constrain``
  of the output: a reduce-scatter).  :func:`segment_counts` all-reduces its
  [num] counts.
* :func:`gather`: the node values are all-gathered (one [N, d]
  all-gather), the edge index stays sharded; the values' grad is
  ``Partial(sum)`` where the index is sharded.

Any other placement of the edges raises.

Parameters are trees shaped as ``repro``'s pytrees (``core.tree``);
``GNNModel`` holds one as an ``nn.Module`` whose names mirror the tree's
paths (``params["layers"][0]["w"]`` is ``layers.0.w``), so a checkpoint of
its tree has ``repro``'s keys.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ...core import csr as csr_mod, util
from ...kernels.csr_build import kernel as cb_kernel
from ...kernels.edge_segment_sum import ops as seg_ops
from .. import sharding_utils as su
from ..param_tree import ParamTree


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Padded flat graph (single large graph or flattened molecule batch)."""

    node_feat: torch.Tensor            # [N, F] float or [N] int (species)
    edge_src: torch.Tensor             # [E] int32 (N = padding sink)
    edge_dst: torch.Tensor             # [E] int32
    positions: Optional[torch.Tensor] = None  # [N, 3]
    graph_ids: Optional[torch.Tensor] = None  # [N] for batched molecules
    labels: Optional[torch.Tensor] = None
    n_nodes: int = 0
    n_graphs: int = 1


def graph_batch_from_csr(c: csr_mod.CSR, node_feat, labels=None) -> GraphBatch:
    """One edge a CSR slot: ``edge_src`` the slot's row, ``edge_dst`` its
    destination, on the CSR's device."""
    dev = c.device
    rows = torch.repeat_interleave(
        torch.arange(c.n, dtype=torch.int32, device=dev), c.degrees, output_size=c.m)
    return GraphBatch(
        node_feat=torch.as_tensor(node_feat, device=dev),
        edge_src=rows,
        edge_dst=c.dst,
        labels=None if labels is None else torch.as_tensor(labels, device=dev),
        n_nodes=c.n,
    )


# ---------------------------------------------------------------------------
# sorted segment sums
# ---------------------------------------------------------------------------
class EdgeOrder:
    """The stable sort of one segment-id tensor over ``num`` segments.

    ``key`` [E] int32 is each id, or ``num`` (the sink) for an id outside
    [0, num); ``rows`` [E] int32 is ``key`` sorted ascending, ``perm`` [E]
    int64 the stable permutation that sorts it.  ``counts`` (ids a segment,
    int32 [num]) are read off ``rows`` by the ``degree_offsets`` kernel
    (its plain version for CPU tensors), made on first use.
    """

    def __init__(self, seg: torch.Tensor, num: int):
        self.num = int(num)
        self.key = torch.where((seg >= 0) & (seg < self.num), seg,
                               self.num).to(torch.int32)
        self.rows, self.perm = torch.sort(self.key, stable=True)
        self._counts = None

    def counts(self, backend: str = "auto") -> torch.Tensor:
        if self._counts is None:
            fn = (cb_kernel.degree_offsets_op
                  if util.resolve_backend(backend, self.rows.device) == "cuda"
                  else cb_kernel.degree_offsets_torch)
            off = fn(self.rows, self.num + 1)
            self._counts = off[1:self.num + 1] - off[:self.num]
        return self._counts


_ORDERS = WeakIdKeyDictionary()


def edge_order(seg: torch.Tensor, num: int) -> EdgeOrder:
    """The ``EdgeOrder`` of ``seg`` over ``num`` segments, cached on the
    tensor (weakly: it goes with the tensor) and rebuilt if the tensor was
    written since.  ``edge_order.sorts`` counts the sorts made."""
    per = _ORDERS.get(seg)
    if per is None:
        per = _ORDERS[seg] = {}
    key = (int(num), seg._version)
    order = per.get(key)
    if order is None:
        for stale in [k for k in per if k[1] != seg._version]:
            del per[stale]
        order = per[key] = EdgeOrder(seg, num)
        edge_order.sorts += 1
    return order


edge_order.sorts = 0


class _SortedSegmentSum(torch.autograd.Function):
    """Segment sum of ``vals`` [E, ...] into ``order.num`` rows through the
    edge segment sum op, on the sorted edges.

    bfloat16 values are summed in float32 and the sums cast back; float64
    values (the plain version only) are summed in float64.  The backward is
    the transpose of the sum: ``grad_out[key]`` for each edge, 0 for edges
    into the sink, in the edges' own order.
    """

    @staticmethod
    def forward(ctx, vals, order, backend):
        ctx.order = order
        acc = torch.float64 if vals.dtype == torch.float64 else torch.float32
        flat = vals.reshape(vals.shape[0], -1).index_select(0, order.perm).to(acc)
        out = seg_ops.edge_segment_sum(order.rows, flat, num_segments=order.num,
                                       backend=backend)
        return out.reshape((order.num,) + vals.shape[1:]).to(vals.dtype)

    @staticmethod
    def backward(ctx, grad):
        order = ctx.order
        flat = grad.reshape(order.num, -1)
        padded = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
        g = padded.index_select(0, order.key)
        return g.reshape(order.key.shape + grad.shape[1:]), None, None


def _edge_placements(seg) -> tuple:
    """(this rank's edges' placements, the per-segment output's): edges
    ``Shard(0)`` or ``Replicate()`` on each mesh dim; the output
    ``Partial(sum)`` where the edges are sharded."""
    from torch.distributed.tensor import Partial, Replicate

    for p in seg.placements:
        if not (p.is_replicate() or p.is_shard(0)):
            raise ValueError(f"segment ids must be Shard(0) or Replicate() on each mesh dim, "
                             f"got {seg.placements}")
    return tuple(seg.placements), tuple(Partial() if p.is_shard() else Replicate()
                                        for p in seg.placements)


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, num: int, *,
                backend: str = "auto") -> torch.Tensor:
    """``jax.ops.segment_sum(vals, seg, num)``: ids outside [0, num) drop."""
    if not su.is_dtensor(seg):
        return _SortedSegmentSum.apply(vals, edge_order(seg, num), backend)
    from torch.distributed.tensor.experimental import local_map

    edge_pl, out_pl = _edge_placements(seg)
    if tuple(vals.placements) != edge_pl:
        vals = vals.redistribute(seg.device_mesh, edge_pl)
    order = edge_order(su.no_grad_local(seg), num)
    site = local_map(lambda v: _SortedSegmentSum.apply(v, order, backend),
                     out_placements=list(out_pl), in_placements=(edge_pl,),
                     device_mesh=seg.device_mesh)
    return site(vals)


def segment_counts(seg: torch.Tensor, num: int, dtype=torch.float32, *,
                   backend: str = "auto") -> torch.Tensor:
    """Ids a segment, as ``segment_sum(ones, seg, num)`` gives them."""
    if not su.is_dtensor(seg):
        return edge_order(seg, num).counts(backend).to(dtype)
    from torch.distributed.tensor import DTensor, Replicate

    _, out_pl = _edge_placements(seg)
    local = edge_order(su.no_grad_local(seg), num).counts(backend).to(dtype)
    counts = DTensor.from_local(local, seg.device_mesh, out_pl, run_check=False)
    return counts.redistribute(seg.device_mesh, [Replicate()] * len(out_pl))


def segment_mean(vals, seg, num, *, backend: str = "auto"):
    s = segment_sum(vals, seg, num, backend=backend)
    c = segment_counts(seg, num, vals.dtype, backend=backend)
    return s / torch.clamp(c[:, None] if vals.ndim > 1 else c, min=1.0)


def aggregate(messages, edge_dst, n_nodes, *, mode: str = "sum", backend: str = "auto"):
    """Scatter edge messages into destination nodes; padding edges must
    carry edge_dst >= n_nodes.

    ``repro`` pads the sink region to 256 segments so that its output
    shards evenly over a mesh; here the sink is dropped by the sum itself,
    so the segments are the ``n_nodes`` real ones.
    """
    if mode == "sum":
        return segment_sum(messages, edge_dst, n_nodes, backend=backend)
    extra = messages.shape[1:]
    out = segment_mean(messages.reshape(messages.shape[0], -1), edge_dst, n_nodes,
                       backend=backend)
    return out.reshape((n_nodes,) + extra)


def gather(node_vals, idx):
    """Padding-safe node gather (idx >= N returns zeros)."""
    if su.is_dtensor(idx):
        return _sharded_gather(node_vals, idx)
    return _gather(node_vals, idx)


def embed_rows(table, ids):
    """``table``'s rows at ``ids`` clamped into range (species embeddings);
    under a mesh on each rank's own ids, as :func:`gather` takes them."""
    ids = torch.clamp(ids, 0, table.shape[0] - 1)
    if su.is_dtensor(ids):
        return _sharded_gather(table, ids)
    return table.index_select(0, ids)


def _sharded_gather(node_vals, idx):
    """``gather`` on each rank's own indices: the node values all-gathered,
    the output placed as the index; the values' grad ``Partial(sum)``
    where the index is sharded."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = idx.device_mesh
    rep = [Replicate()] * mesh.ndim
    if not su.is_dtensor(node_vals):
        node_vals = DTensor.from_local(node_vals, mesh, rep, run_check=False)
    node_vals = node_vals.redistribute(mesh, rep)
    idx_pl = tuple(idx.placements)
    grad_pl = tuple(Partial() if p.is_shard() else Replicate() for p in idx_pl)
    site = local_map(_gather, out_placements=list(idx_pl), in_placements=(rep, idx_pl),
                     in_grad_placements=(grad_pl, idx_pl), device_mesh=mesh)
    return site(node_vals, idx)


def _gather(node_vals, idx):
    n = node_vals.shape[0]
    safe = torch.clamp(idx, max=n - 1)
    vals = node_vals.index_select(0, safe)
    mask = (idx < n).reshape((-1,) + (1,) * (vals.ndim - 1))
    return torch.where(mask, vals, 0)


def node_zeros(like, shape, dtype=torch.float32):
    """Zeros of ``shape`` on ``like``'s device; under a mesh a DTensor placed
    as ``like`` (node arrays: rows sharded as the nodes)."""
    if not su.is_dtensor(like):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    from torch.distributed.tensor import zeros

    return zeros(shape, dtype=dtype, device_mesh=like.device_mesh, placements=like.placements)


def edge_chunks(src, dst, n: int, k: int) -> list:
    """``k`` (src, dst) chunks of the edges, the tail padded with the sink
    ``n``.  Under a mesh each rank chunks its own edges (the chunks keep the
    edges' placements), so no edge crosses ranks; the sums over all chunks
    are the same."""
    if not su.is_dtensor(src):
        return list(zip(*(_chunk(t, n, k) for t in (src, dst))))
    from torch.distributed.tensor import DTensor

    mesh, pl = src.device_mesh, src.placements
    return [tuple(DTensor.from_local(t, mesh, pl, run_check=False) for t in pair)
            for pair in zip(*(_chunk(su.no_grad_local(t), n, k) for t in (src, dst)))]


def _chunk(ids, n: int, k: int):
    ck = -(-ids.shape[0] // k)
    pad = torch.full((k * ck - ids.shape[0],), n, dtype=ids.dtype, device=ids.device)
    return torch.cat([ids, pad]).split(ck)


class _Silu(torch.autograd.Function):
    """x·sigmoid(x), saving only x for the backward (autograd of the
    product would keep sigmoid(x) as well: at GraphCast's width a 0.35 GB
    tensor an MLP of a layer)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * torch.sigmoid(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        s = torch.sigmoid(x)
        return grad * s + (grad * x) * ((1 - s) * s)


def silu(x):
    """``jax.nn.silu``'s formula, x·sigmoid(x) (``F.silu`` rounds another
    way in about a quarter of its outputs)."""
    return _Silu.apply(x)


def mlp(params, x, act=silu):
    for i, (w, b) in enumerate(params):
        x = x @ w + b
        if i < len(params) - 1:
            x = act(x)
    return x


def normal(generator: torch.Generator, shape, scale: float, device,
           dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) * scale of ``shape``, drawn from ``generator`` on ``device``."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(scale)


def init_mlp(generator: torch.Generator, sizes, *, device, dtype=torch.float32):
    """[(w, b), ...] as ``repro``'s ``init_mlp`` draws them: w N(0,1)/sqrt(fan_in),
    b 0."""
    return [
        (normal(generator, (sizes[i], sizes[i + 1]), sizes[i] ** -0.5, device, dtype),
         torch.zeros((sizes[i + 1],), dtype=dtype, device=device))
        for i in range(len(sizes) - 1)
    ]


# ---------------------------------------------------------------------------
# the model as a module
# ---------------------------------------------------------------------------
class GNNModel(ParamTree):
    """A GNN: its parameter tree and config, and the module's functional
    ``forward(params, g, cfg)``."""

    def __init__(self, params, cfg, forward: Callable):
        super().__init__(params)
        self.cfg = cfg
        self._forward = forward

    def forward(self, g: dict) -> torch.Tensor:
        return self._forward(self.tree(), g, self.cfg)

