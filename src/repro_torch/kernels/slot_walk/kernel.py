"""The slot walk's tile kernels.

* ``slot_gather``: the gathered plane of the interval walk step,
  ``visits[b, gidx[s]]`` with the sink index reading 0.0
  (``csrc/slot_gather.cu``).  It replaces no TPU kernel: ``repro``
  gathers with ``jnp.concatenate`` and fancy indexing.
* ``tile_cumsum``: the intra-tile prefix level of the interval walk step
  (``csrc/tile_cumsum.cu``).  It replaces the TPU kernel
  ``repro/kernels/slot_walk/kernel.py::tile_cumsum`` (one triangular MXU
  matmul per tile).
* ``tile_bases``: the tile-base level of the same step, the exclusive
  float64 prefix of the tile totals split into two float32 parts
  (``csrc/tile_bases.cu``).  It replaces no TPU kernel: ``repro`` scans the
  totals with ``jax.lax.associative_scan``.
* ``slot_walk_partials``: the per-tile run reduction of the interval-less
  walk step (``csrc/slot_walk_partials.cu``).  It replaces the TPU kernel
  ``repro/kernels/slot_walk/kernel.py::slot_walk_partials`` (one one-hot
  rank MXU matmul per tile).

Each wrapper launches its CUDA kernel for CUDA tensors and uses its plain
PyTorch version (``*_torch``) only for CPU tensors; its ``launches``
attribute counts kernel launches.
"""
from __future__ import annotations

import torch

from ...runtime import trace
from .. import _build

#: slots per tile
EB = 128


def slot_gather_torch(visits: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """Plain version: a zero column appended to ``visits``, then
    ``index_select`` of every slot along dim 1."""
    zcol = torch.zeros((visits.shape[0], 1), dtype=torch.float32, device=visits.device)
    return torch.cat([visits, zcol], dim=1).index_select(1, gidx.reshape(-1))


def gather_rows_per_pass(b: int) -> int:
    """Rows a pass of ``slot_gather`` for B walks: the largest power of two
    up to 16 that B fills.  Above one row a pass packs its rows vertex
    major, so a slot's R values come in one read."""
    r = 1
    while r * 2 <= min(b, 16):
        r *= 2
    return r


def _passes(b: int, rows_per_pass: int):
    """The rows of each pass, as ``csrc/slot_gather.cu`` runs them: full
    passes, then the largest power of two the remaining rows fill."""
    left = b
    while left:
        r = rows_per_pass
        while r > left:
            r //= 2
        yield r
        left -= r


def _launch_gather(visits, gidx, rows_per_pass: int) -> torch.Tensor:
    """One ``repro_slot_gather`` call with ``rows_per_pass`` rows a pass."""
    b, n = visits.shape
    slots = gidx.numel()
    out = torch.empty((b, slots), dtype=torch.float32, device=visits.device)
    if b == 0:
        return out
    pack = (torch.empty(n * rows_per_pass, dtype=torch.float32, device=visits.device)
            if rows_per_pass > 1 else out)
    lib = _build.library()
    _build.check(
        lib.repro_slot_gather(
            visits.data_ptr(), gidx.data_ptr(), out.data_ptr(), pack.data_ptr(),
            b, n, slots, rows_per_pass, _build.stream(visits),
        ),
        "slot_gather",
    )
    return out


def slot_gather(visits: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """The walk step's gathered plane: visits [B, n] f32, gidx [T, EB] int32
    in [0, n] (n, the sink, reads 0.0) -> [B, T·EB] f32, bit for bit what
    ``slot_gather_torch`` gives.  One launch a call (the entry point runs
    the passes ``gather_rows_per_pass`` plans); while ``trace.recording()``
    it adds one counter record to the open span: ``rows``, ``slots``,
    ``rows_per_pass`` and ``bytes``: a pass's plane written and index read,
    the visits read once and, above one row a pass, the pack written and
    read back once."""
    if visits.device.type == "cpu":
        return slot_gather_torch(visits, gidx)
    _build.require(visits, "visits", torch.float32, 2)
    _build.require(gidx, "gidx", torch.int32, 2)
    if gidx.shape[1] != EB:
        raise ValueError(f"gidx: tiles must be {EB} wide, got {gidx.shape[1]}")
    b, n = visits.shape
    if n >= 2**31:
        raise ValueError(f"visits: {n} vertices do not fit int32 indices")
    rpp = gather_rows_per_pass(b)
    out = _launch_gather(visits, gidx, rpp)
    slot_gather.launches += 1
    if trace.recording():
        slots = gidx.numel()
        nbytes = sum(4 * ((r + 1) * slots + r * n * (3 if r > 1 else 1))
                     for r in _passes(b, rpp))
        trace.count(rows=b, slots=slots, rows_per_pass=rpp, bytes=nbytes)
    return out


slot_gather.launches = 0


def tile_cumsum_torch(vals: torch.Tensor) -> torch.Tensor:
    """Plain version: inclusive cumsum along each [EB] tile."""
    return torch.cumsum(vals, dim=-1)


def tile_cumsum(vals: torch.Tensor) -> torch.Tensor:
    """Per-tile inclusive prefix sum: vals [N, EB] f32 -> [N, EB] f32."""
    if vals.device.type == "cpu":
        return tile_cumsum_torch(vals)
    _build.require(vals, "vals", torch.float32, 2)
    if vals.shape[1] != EB:
        raise ValueError(f"vals: tiles must be {EB} wide, got {vals.shape[1]}")
    if vals.data_ptr() % 16:  # the kernel loads float4 vectors
        raise ValueError("vals: data pointer not 16-byte aligned")
    out = torch.empty_like(vals)
    if vals.shape[0] == 0:
        return out
    lib = _build.library()
    _build.check(
        lib.repro_tile_cumsum(
            vals.data_ptr(), out.data_ptr(), vals.shape[0], _build.stream(vals)
        ),
        "tile_cumsum",
    )
    tile_cumsum.launches += 1
    return out


tile_cumsum.launches = 0

#: tile totals one block of ``csrc/tile_bases.cu`` scans (its ``kChunk``)
BASES_CHUNK = 4096


def _twosum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (s = fl(a+b))."""
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def _comp_scan(x: torch.Tensor):
    """Compensated inclusive scan along dim 1: (hi, lo), hi+lo ≈ exact.

    Hillis–Steele doubling: log2(T) passes of whole-tensor ops, each
    combining position i with position i-d by TwoSum of the high parts
    and a plain sum of the low parts and the rounding error.
    """
    hi = x
    lo = torch.zeros_like(x)
    d = 1
    while d < x.shape[1]:
        s, e = _twosum(hi[:, :-d], hi[:, d:])
        lo = torch.cat([lo[:, :d], lo[:, :-d] + lo[:, d:] + e], dim=1)
        hi = torch.cat([hi[:, :d], s], dim=1)
        d *= 2
    return hi, lo


def tile_bases_torch(incl: torch.Tensor):
    """Plain version: ``_comp_scan`` of the tile totals, shifted to exclusive."""
    hi, lo = _comp_scan(incl[:, EB - 1::EB])
    zcol = torch.zeros((incl.shape[0], 1), dtype=torch.float32, device=incl.device)
    return torch.cat([zcol, hi[:, :-1]], dim=1), torch.cat([zcol, lo[:, :-1]], dim=1)


def tile_bases(incl: torch.Tensor):
    """Exclusive compensated tile bases: incl [B, T·EB] f32 -> (bh, bl).

    ``incl`` holds each tile's inclusive cumsum (``tile_cumsum``'s output
    as [B, T·EB]), so lane EB-1 of a tile is its total.  ``bh`` and ``bl``
    are [B, T] f32, and ``bh + bl`` is the sum of the row's totals before
    each tile (column 0 is 0): float64 on the card, TwoSum pairs in the
    plain version.  One launch a call (the entry point runs a reduce and a
    scan kernel); results repeat bit for bit.
    """
    if incl.device.type == "cpu":
        return tile_bases_torch(incl)
    _build.require(incl, "incl", torch.float32, 2)
    b, width = incl.shape
    if width == 0 or width % EB:
        raise ValueError(f"incl: width must be a positive multiple of {EB}, got {width}")
    if incl.data_ptr() % 16:  # the kernel loads each total as a float4's last lane
        raise ValueError("incl: data pointer not 16-byte aligned")
    t = width // EB
    bh = torch.empty((b, t), dtype=torch.float32, device=incl.device)
    bl = torch.empty_like(bh)
    if b == 0:
        return bh, bl
    sums = torch.empty(b * -(-t // BASES_CHUNK), dtype=torch.float64, device=incl.device)
    lib = _build.library()
    _build.check(
        lib.repro_tile_bases(
            incl.data_ptr(), bh.data_ptr(), bl.data_ptr(), sums.data_ptr(), sums.numel(),
            b, t, _build.stream(incl),
        ),
        "tile_bases",
    )
    tile_bases.launches += 1
    return bh, bl


tile_bases.launches = 0


def tile_ranks(rows: torch.Tensor, sink: int):
    """Run ranks of [T, EB] tiles: a run is a maximal stretch of equal rows
    and slot 0 always starts one.  -> (rank [T, EB] int64, the slot's run
    index; rank_rows [T, EB] int32, each rank's row, ``sink`` for unused
    ranks and rows outside [0, sink))."""
    start = torch.ones_like(rows, dtype=torch.bool)
    start[:, 1:] = rows[:, 1:] != rows[:, :-1]
    rank = torch.cumsum(start, dim=1) - 1
    live = (rows >= 0) & (rows < sink)
    # every slot of a run writes the run's (one) value
    rank_rows = torch.full_like(rows, sink).scatter_(
        1, rank, torch.where(live, rows, sink))
    return rank, rank_rows


def slot_walk_partials_torch(rows: torch.Tensor, vals: torch.Tensor, sink: int):
    """Plain version: run flags, cumsum to ranks, ``scatter_add`` per tile.

    ``rows`` [T, EB] int32 in [0, sink], ``vals`` [B*T, EB] f32 (tile t
    reads rows[t % T]) -> (partials [B*T, EB] f32, rank_rows [T, EB] int32).
    """
    t = rows.shape[0]
    rank, rank_rows = tile_ranks(rows, sink)
    b = vals.shape[0] // max(t, 1)
    partials = torch.zeros((b, t, EB), dtype=torch.float32, device=vals.device)
    partials.scatter_add_(2, rank.expand(b, t, EB), vals.reshape(b, t, EB))
    return partials.reshape(b * t, EB), rank_rows


def slot_walk_partials(rows: torch.Tensor, vals: torch.Tensor, sink: int):
    """One walk step's tile reduction: (rows, vals, sink) -> (partials, rank_rows).

    ``rows`` [T, EB] int32 slot owners (dead and pad slots carry ``sink``),
    ``vals`` [B*T, EB] f32 gathered visits; tile t of ``vals`` is owned by
    ``rows[t % T]``, so B walks share one rows operand.  ``partials`` [B*T,
    EB] holds each tile's per-rank run sums (0 for unused ranks) and
    ``rank_rows`` [T, EB] each rank's row (``sink`` for dead or unused
    ranks).
    """
    sink = int(sink)
    if rows.device.type == "cpu":
        return slot_walk_partials_torch(rows, vals, sink)
    _build.require(rows, "rows", torch.int32, 2)
    _build.require(vals, "vals", torch.float32, 2)
    t = rows.shape[0]
    if rows.shape[1] != EB or vals.shape[1] != EB:
        raise ValueError(f"rows and vals: tiles must be {EB} wide")
    if t == 0 or vals.shape[0] % t:
        raise ValueError(
            f"vals: {vals.shape[0]} tiles is not a multiple of rows' {t}")
    if not 0 <= sink < 2**31:
        raise ValueError(f"sink must fit int32, got {sink}")
    if rows.data_ptr() % 16 or vals.data_ptr() % 16:  # 16-byte vector loads
        raise ValueError("rows and vals: data pointers not 16-byte aligned")
    partials = torch.empty_like(vals)
    rank_rows = torch.empty_like(rows)
    lib = _build.library()
    _build.check(
        lib.repro_slot_walk_partials(
            rows.data_ptr(), vals.data_ptr(), vals.shape[0], t, sink,
            partials.data_ptr(), rank_rows.data_ptr(), _build.stream(vals),
        ),
        "slot_walk_partials",
    )
    slot_walk_partials.launches += 1
    return partials, rank_rows


slot_walk_partials.launches = 0
