"""k-step reverse walk over the slotted buffer's live prefix.

When the caller supplies per-vertex [lo, hi) block intervals (every
``WalkImage`` does), the walk uses the scatter-free hierarchical prefix
formulation (``make_blocked_step``): the per-slot ``slot_rows`` operand
is folded into the interval geometry and each step moves only the gather
plane plus O(V) interval reads.  Its gather is the ``slot_gather`` CUDA
kernel, its intra-tile level the ``tile_cumsum`` one and its tile-base
level the ``tile_bases`` one (``backend="cuda"``), or their plain PyTorch
versions (``backend="torch"``); ``auto`` picks by the tensors' device.

Interval-less callers (raw arenas, the seed baseline) take the rank-tile
walk (``slot_walk_ranked``, ``repro``'s ``slot_walk_pallas``): per step a
gather, the ``slot_walk_partials`` tile reduction (the CUDA kernel, or its
plain version for ``backend="torch"``) and a fold of the tiles' live ranks
into rows.  The segment-sum walks (``slot_walk_segsum`` and its batched
form, one ``index_add_`` of every slot, ``repro``'s ``xla`` backend) stay
as the plain formulation the tests hold the rank-tile walk against.

Walks only process ``edges_hi`` slots (the arena's bump prefix, quantized
by the caller) instead of the full buffer.
"""
from __future__ import annotations

import torch

from ...core import util
from ...runtime import faultinject, trace
from . import kernel as _kernel

SENTINEL = int(util.SENTINEL)
EB = _kernel.EB  # slots per tile


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(v.max(dim=-1, keepdim=True).values, min=1.0)


def _prep(dst, slot_rows, num_vertices: int, edges_hi: int):
    """Slice the live prefix, mask dead slots, pad to whole tiles.

    Dead/pad slots get row ``sink`` and gather index ``num_vertices`` —
    the step loop extends ``visits`` with a zero sink entry, so no
    per-step masking is needed.
    """
    e = min(int(edges_hi), dst.shape[0])
    t = max(-(-e // EB), 1)
    sink = num_vertices
    d = dst[:e]
    sr = slot_rows[:e]
    valid = (d != SENTINEL) & (sr < num_vertices)
    rows_p = torch.full((t * EB,), sink, dtype=torch.int64, device=dst.device)
    gidx_p = torch.full((t * EB,), num_vertices, dtype=torch.int64, device=dst.device)
    rows_p[:e] = torch.where(valid, sr, sink)
    gidx_p[:e] = torch.where(valid, d.clamp(0, num_vertices - 1), num_vertices)
    return rows_p, gidx_p


def slot_walk_multi_segsum(dst, slot_rows, visits0, steps: int,
                           num_vertices: int, *, edges_hi: int,
                           normalize: bool = False) -> torch.Tensor:
    """Batched segment-sum walk: ``visits0`` [B, V] -> [B, V]."""
    rows_f, gidx_f = _prep(dst, slot_rows, num_vertices, edges_hi)
    v = visits0.to(torch.float32)
    zcol = torch.zeros((v.shape[0], 1), dtype=torch.float32, device=v.device)
    for _ in range(steps):
        vals = torch.cat([v, zcol], dim=1).index_select(1, gidx_f)  # sink -> 0.0
        nxt = torch.zeros((v.shape[0], num_vertices + 1), dtype=torch.float32,
                          device=v.device)
        v = nxt.index_add_(1, rows_f, vals)[:, :num_vertices]
        if normalize:
            v = _normalize(v)
    return v


def slot_walk_segsum(dst, slot_rows, steps: int, num_vertices: int, *,
                     edges_hi: int, normalize: bool = False) -> torch.Tensor:
    """Segment-sum walk from the all-ones vector: -> [V]."""
    ones = torch.ones((1, num_vertices), dtype=torch.float32, device=dst.device)
    return slot_walk_multi_segsum(
        dst, slot_rows, ones, steps, num_vertices,
        edges_hi=edges_hi, normalize=normalize,
    )[0]


def _fold_live(part, rank_rows, b: int, num_vertices: int) -> torch.Tensor:
    """Seam fold: add each tile's per-rank partials into their rows.

    Only live ranks (``rank_rows < sink``) are folded.  ``repro`` folds all
    T*EB entries with ``segment_sum(part, min(rank, sink))`` and slices the
    sink row off; on a large graph most ranks are dead, and an
    ``index_add_`` of those would pile its atomics onto the one sink row.
    """
    rank = rank_rows.reshape(-1)
    sel = torch.nonzero(rank < num_vertices).squeeze(1)
    nxt = torch.zeros((b, num_vertices), dtype=torch.float32, device=part.device)
    return nxt.index_add_(1, rank.index_select(0, sel),
                          part.reshape(b, -1).index_select(1, sel))


def slot_walk_multi_ranked(dst, slot_rows, visits0, steps: int,
                           num_vertices: int, *, edges_hi: int,
                           normalize: bool = False,
                           backend: str = "auto") -> torch.Tensor:
    """Batched rank-tile walk: ``visits0`` [B, V] -> [B, V].

    The B walks' gathered tiles go to one ``slot_walk_partials`` call per
    step; tile t of walk b is owned by ``rows[t]``, so the rows operand is
    shared, not tiled B times.
    """
    backend = util.resolve_backend(backend, dst.device)
    partials = (_kernel.slot_walk_partials if backend == "cuda"
                else _kernel.slot_walk_partials_torch)
    rows_f, gidx_f = _prep(dst, slot_rows, num_vertices, edges_hi)
    rows_t = rows_f.to(torch.int32).reshape(-1, EB)
    v = visits0.to(torch.float32)
    b = v.shape[0]
    zcol = torch.zeros((b, 1), dtype=torch.float32, device=v.device)
    for _ in range(steps):
        vals = torch.cat([v, zcol], dim=1).index_select(1, gidx_f)  # sink -> 0.0
        part, rank = partials(rows_t, vals.reshape(-1, EB), num_vertices)
        v = _fold_live(part, rank, b, num_vertices)
        if normalize:
            v = _normalize(v)
    return v


def slot_walk_ranked(dst, slot_rows, steps: int, num_vertices: int, *,
                     edges_hi: int, normalize: bool = False,
                     backend: str = "auto") -> torch.Tensor:
    """Rank-tile walk from the all-ones vector: -> [V]."""
    ones = torch.ones((1, num_vertices), dtype=torch.float32, device=dst.device)
    return slot_walk_multi_ranked(
        dst, slot_rows, ones, steps, num_vertices,
        edges_hi=edges_hi, normalize=normalize, backend=backend,
    )[0]


def _prep_gidx(dst, num_vertices: int, edges_hi: int) -> torch.Tensor:
    """Tile-padded gather indices [T, EB], masked from ``dst`` ALONE.

    Dead slots carry ``dst == SENTINEL``, so the interval walk needs no
    per-slot owner operand: ``slot_rows`` is folded into the [lo, hi)
    block geometry.
    """
    e = min(int(edges_hi), dst.shape[0])
    t = max(-(-e // EB), 1)
    d = dst[:e]
    gidx = torch.full((t * EB,), num_vertices, dtype=torch.int32, device=dst.device)
    gidx[:e] = torch.where(d == SENTINEL, num_vertices, d.clamp(0, num_vertices - 1))
    return gidx.reshape(t, EB)


def make_blocked_step(gidx_p, block_lo, block_hi, num_vertices: int, *,
                      backend: str = "auto"):
    """Build the scatter-free interval walk step (batched: [B, V] -> [B, V]).

    Each vertex's slots are one contiguous interval [block_lo, block_hi)
    and dead slots gather 0.0 (the ``slot_gather`` kernel), so a step
    reduces to ``P[hi] - P[lo]`` over the running prefix sum of the
    gathered values.  The prefix is hierarchical: an inclusive cumsum
    within each 128-slot tile (the ``tile_cumsum`` kernel) plus the
    exclusive compensated prefix of the T tile totals as two float32 parts
    (the ``tile_bases`` kernel), with the difference assembled per part so
    the large bases are never rounded into the result.  The residual error
    is the intra-tile partial, ~ulp(sum of one tile).  Rows without a
    block pass lo == hi.

    A step's phases are the program spans ``slot_walk.gather``,
    ``slot_walk.scan`` (the tile bases) and ``slot_walk.diff``, with their
    device time on the card; ``tile_cumsum`` between the first two is its
    own kernel in a trace.
    """
    backend = util.resolve_backend(backend, gidx_p.device)
    on_card = gidx_p.is_cuda
    gather = _kernel.slot_gather if backend == "cuda" else _kernel.slot_gather_torch
    cumsum = _kernel.tile_cumsum if backend == "cuda" else _kernel.tile_cumsum_torch
    bases = _kernel.tile_bases if backend == "cuda" else _kernel.tile_bases_torch
    t = gidx_p.shape[0]
    e_pad = t * EB
    lo = block_lo.to(torch.int64).clamp(0, e_pad)
    hi = block_hi.to(torch.int64).clamp(0, e_pad)
    # split each prefix position into (tile, offset); position e_pad folds
    # onto the last tile's tail so the gather stays in range
    q_lo = torch.clamp(lo // EB, max=t - 1)
    q_hi = torch.clamp(hi // EB, max=t - 1)
    r_lo = lo - q_lo * EB
    r_hi = hi - q_hi * EB
    # prefix position (q, r) reads the tile's INCLUSIVE cumsum at lane r-1,
    # or 0.0 at a tile start
    z_lo = r_lo == 0
    z_hi = r_hi == 0
    i_lo = q_lo * EB + (r_lo - 1).clamp(min=0)
    i_hi = q_hi * EB + (r_hi - 1).clamp(min=0)

    def step(visits: torch.Tensor) -> torch.Tensor:
        b = visits.shape[0]
        with trace.span("slot_walk.gather", device=on_card):
            vals = gather(visits.contiguous(), gidx_p)
        incl = cumsum(vals.reshape(b * t, EB)).reshape(b, t * EB)
        with trace.span("slot_walk.scan", device=on_card):
            bh, bl = bases(incl)
        with trace.span("slot_walk.diff", device=on_card):
            ih = torch.where(z_hi, 0.0, incl.index_select(1, i_hi))
            il = torch.where(z_lo, 0.0, incl.index_select(1, i_lo))
            return (bh.index_select(1, q_hi) - bh.index_select(1, q_lo)) + (
                (ih - il)
                + (bl.index_select(1, q_hi) - bl.index_select(1, q_lo))
            )

    return step


def slot_walk_multi_blocked(dst, block_lo, block_hi, visits0, steps: int,
                            num_vertices: int, *, edges_hi: int,
                            normalize: bool = False,
                            backend: str = "auto") -> torch.Tensor:
    """Batched scatter-free prefix-sum walk: visits0 [B, V] -> [B, V].

    The interval index arithmetic is shared; only the gathered values and
    prefix sums carry the batch dim (the kernel sees B*T tiles).
    """
    gidx_p = _prep_gidx(dst, num_vertices, edges_hi)
    step = make_blocked_step(gidx_p, block_lo, block_hi, num_vertices,
                             backend=backend)
    v = visits0.to(torch.float32)
    for _ in range(steps):
        v = step(v)
        if normalize:
            v = _normalize(v)
    return v


def slot_walk_blocked(dst, block_lo, block_hi, steps: int, num_vertices: int,
                      *, edges_hi: int, normalize: bool = False,
                      backend: str = "auto") -> torch.Tensor:
    """Scatter-free walk from the all-ones vector via block intervals."""
    ones = torch.ones((1, num_vertices), dtype=torch.float32, device=dst.device)
    return slot_walk_multi_blocked(
        dst, block_lo, block_hi, ones, steps, num_vertices,
        edges_hi=edges_hi, normalize=normalize, backend=backend,
    )[0]


def slot_walk(dst, slot_rows, steps: int, num_vertices: int, *,
              edges_hi: int | None = None, backend: str = "auto",
              block_lo=None, block_hi=None, normalize: bool = False,
              visits0=None) -> torch.Tensor:
    """k-step reverse walk over the slotted arena's live prefix.

    ``edges_hi`` bounds the slots processed (None: the whole buffer).
    With per-vertex block intervals (``block_lo``/``block_hi``, lo == hi
    for blockless rows) the walk takes the blocked prefix-sum step;
    without them the rank-tile step (``slot_walk_partials``).  ``visits0``
    [B, num_vertices] walks B vectors together and returns [B, V].

    The fault point ``slot_walk.<backend>`` fires once, before the one
    attempt: an injected failure raises to the caller, with no retry and no
    other backend (``repro`` runs this site through its breaker chain).
    """
    if edges_hi is None:
        edges_hi = dst.shape[0]
    edges_hi = min(int(edges_hi), dst.shape[0])
    backend = util.resolve_backend(backend, dst.device)
    faultinject.fire(f"slot_walk.{backend}")
    if visits0 is not None:
        if visits0.ndim != 2 or visits0.shape[1] != num_vertices:
            raise ValueError(
                "visits0 must be [num_walks, num_vertices], got "
                f"{tuple(visits0.shape)}"
            )
        visits0 = torch.as_tensor(visits0, dtype=torch.float32, device=dst.device)
    if block_lo is not None and block_hi is not None:
        if visits0 is not None:
            return slot_walk_multi_blocked(
                dst, block_lo, block_hi, visits0, steps, num_vertices,
                edges_hi=edges_hi, normalize=normalize, backend=backend,
            )
        return slot_walk_blocked(
            dst, block_lo, block_hi, steps, num_vertices,
            edges_hi=edges_hi, normalize=normalize, backend=backend,
        )
    if visits0 is not None:
        return slot_walk_multi_ranked(
            dst, slot_rows, visits0, steps, num_vertices,
            edges_hi=edges_hi, normalize=normalize, backend=backend,
        )
    return slot_walk_ranked(
        dst, slot_rows, steps, num_vertices,
        edges_hi=edges_hi, normalize=normalize, backend=backend,
    )


def slot_walk_image(image, steps: int, *, backend: str = "auto",
                    normalize: bool = False, visits0=None) -> torch.Tensor:
    """Image-input entry point: walk a ``core.walk_image.WalkImage``.

    The image supplies the packed buffers, the quantized prefix bound and
    the per-vertex block intervals, so the walk always takes the blocked
    step.
    """
    block_lo, block_hi = image.device_blocks()
    return slot_walk(
        image.dst, image.rows, steps, image.nv,
        edges_hi=image.edges_hi(), backend=backend,
        block_lo=block_lo, block_hi=block_hi,
        normalize=normalize, visits0=visits0,
    )
