"""edge_segment_sum parity: the port's op and tile partials against ``repro``'s.

``repro``'s Pallas kernel runs in interpret mode.  Its tile reduction is a
one-hot matmul; the port sums each run in order (the plain version by
``scatter_add``), so values are compared within the bound of two summation
orders: a sum of n terms is within (n-1)·2^-24·Σ|terms| of the exact sum
in any order, so two orders differ by at most twice that.  Rank rows are
integers and must match bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.edge_segment_sum import kernel as j_kernel
from repro.kernels.edge_segment_sum import ops as j_ops
from repro_torch.kernels.edge_segment_sum import kernel as seg_kernel
from repro_torch.kernels.edge_segment_sum import ops as seg_ops

U = 2.0**-24


def _sum_bound(rows, vals, n):
    """Per-segment bound 2·(n-1)·2^-24·Σ|terms| of two summation orders."""
    cnt = np.bincount(rows[rows < n], minlength=n)[:, None].astype(np.float64)
    absum = np.zeros((n + 1, vals.shape[1]))
    np.add.at(absum, np.minimum(rows, n), np.abs(vals).astype(np.float64))
    return 2 * np.maximum(cnt - 1, 0) * U * absum[:n]


def _sorted_rows(rng, e, n, dropped=0):
    """Ascending rows with hubs spanning tiles; ``dropped`` rows >= n at
    the tail (repro's op clamps them to the sink)."""
    rows = np.sort(rng.integers(0, n, e - dropped))
    if e - dropped > 300:
        rows[100:300] = rows[100]  # one row across two tile seams
        rows = np.sort(rows)
    tail = np.sort(rng.integers(n, n + 5, dropped))
    return np.concatenate([rows, tail]).astype(np.int32)


@pytest.mark.parametrize("e,d,n", [(100, 16, 20), (700, 64, 50), (128, 1, 5),
                                   (513, 200, 300), (4096, 32, 17)])
def test_edge_segment_sum_matches_repro(e, d, n):
    rng = np.random.default_rng(e)
    rows = _sorted_rows(rng, e, n, dropped=3)
    vals = rng.standard_normal((e, d)).astype(np.float32)
    exp = np.asarray(j_ops.edge_segment_sum(
        jnp.asarray(rows), jnp.asarray(vals), num_segments=n, interpret=True))
    got = seg_ops.edge_segment_sum(torch.from_numpy(rows), torch.from_numpy(vals),
                                   num_segments=n)
    assert got.shape == (n, d) and got.dtype == torch.float32
    bound = _sum_bound(rows, vals, n)
    assert (np.abs(got.numpy() - exp) <= bound).all()
    ref = seg_ops.edge_segment_sum_reference(torch.from_numpy(rows), torch.from_numpy(vals),
                                             num_segments=n)
    assert (np.abs(got.numpy() - ref.numpy()) <= bound).all()


@pytest.mark.parametrize("d,d_tile", [(48, 16), (5, None)])
def test_edge_segment_sum_pads_edges_not_columns(d, d_tile):
    """The edges are padded to whole tiles with sink rows and zero values;
    the columns stay D wide, whatever column tile ``repro`` pads to."""
    rng = np.random.default_rng(d)
    rows = _sorted_rows(rng, 300, 40)
    vals = rng.standard_normal((300, d)).astype(np.float32)
    rows_t, vals_t = seg_kernel.pad(torch.from_numpy(rows), torch.from_numpy(vals), 40)
    assert tuple(vals_t.shape) == (3, 128, d)
    assert bool((rows_t.reshape(-1)[300:] == 40).all())
    assert bool((vals_t.reshape(-1, d)[300:] == 0).all())
    exp = np.asarray(j_ops.edge_segment_sum(
        jnp.asarray(rows), jnp.asarray(vals), num_segments=40, d_tile=d_tile, interpret=True))
    got = seg_ops.edge_segment_sum(torch.from_numpy(rows), torch.from_numpy(vals),
                                   num_segments=40)
    assert got.shape == (40, d)
    assert (np.abs(got.numpy() - exp) <= _sum_bound(rows, vals, 40)).all()


def test_edge_segment_sum_no_edges():
    got = seg_ops.edge_segment_sum(torch.zeros(0, dtype=torch.int32), torch.zeros(0, 3),
                                   num_segments=4)
    assert torch.equal(got, torch.zeros(4, 3))


@pytest.mark.parametrize("kind", ["int64", "all_dropped", "negative", "no_edges_d5"])
def test_edge_segment_sum_host_glue_matches_repro(kind):
    """Row dtypes and edge cases the op's host side sees, through the plain
    op against ``repro``'s: int64 rows, every row dropped (>= n), negative
    rows (dropped as ``repro``'s rank rows drop them), no edges."""
    rng = np.random.default_rng(11)
    n, d = 30, 5
    rows = _sorted_rows(rng, 700, n, dropped=4).astype(np.int64)
    if kind == "all_dropped":
        rows = np.sort(rng.integers(n, n + 9, 700))
    elif kind == "negative":
        rows[:150] = np.sort(rng.integers(-5, 0, 150))
    elif kind == "no_edges_d5":
        rows = rows[:0]
    vals = rng.standard_normal((rows.shape[0], d)).astype(np.float32)
    got = seg_ops.edge_segment_sum(torch.from_numpy(rows), torch.from_numpy(vals),
                                   num_segments=n)
    assert got.shape == (n, d) and got.dtype == torch.float32
    if rows.shape[0] == 0 or kind == "all_dropped":
        assert torch.equal(got, torch.zeros(n, d))
    if rows.shape[0]:
        exp = np.asarray(j_ops.edge_segment_sum(
            jnp.asarray(rows.astype(np.int32)), jnp.asarray(vals), num_segments=n,
            interpret=True))
        assert (np.abs(got.numpy() - exp) <= _sum_bound(np.where(rows < 0, n, rows), vals, n)
                ).all()
    # the CUDA wrapper's plain version on CPU tensors is the plain op
    assert torch.equal(seg_kernel.edge_segment_runs(torch.from_numpy(rows),
                                                    torch.from_numpy(vals), n), got)


def test_edge_segment_rows_int32_keeps_wide_rows_dropped():
    """The kernel reads int32 rows; wider rows are clamped to [-1, n] first,
    so a row beyond int32 stays dropped and the rows stay ascending."""
    rows = torch.tensor([-2**40, -3, 0, 5, 9, 10, 2**31, 2**40], dtype=torch.int64)
    got = seg_kernel.rows_int32(rows, 10)
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert got.tolist() == [-1, -1, 0, 5, 9, 10, 10, 10]
    same = torch.arange(6, dtype=torch.int32)[::2]
    assert seg_kernel.rows_int32(same, 3).is_contiguous()


def _tiles(rng, t, sink, kind):
    """[T, 128] rows ascending within each tile: runs, hubs, dead rows."""
    if kind == "all_sink":
        return np.full((t, 128), sink, np.int32)
    if kind == "runs_128":  # every slot its own run
        return np.tile(np.arange(128, dtype=np.int32) % sink, (t, 1))
    rows = np.sort(rng.integers(0, sink + 3, (t, 128)), axis=1)
    if kind == "hub":
        rows[:, :100] = rows[:, :1]
    return rows.astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "hub", "all_sink", "runs_128"])
@pytest.mark.parametrize("dp,d_tile", [(1, 1), (16, 16), (64, 64), (256, 128)])
def test_edge_segment_partials_matches_pallas_interpret(kind, dp, d_tile):
    rng = np.random.default_rng(dp)
    sink = 200
    rows = _tiles(rng, 3, sink, kind)
    vals = rng.standard_normal((3, 128, dp)).astype(np.float32)
    exp_p, exp_r = j_kernel.edge_segment_partials(
        jnp.asarray(rows), jnp.asarray(vals), d_tile=d_tile, sink=sink, interpret=True)
    t_rows, t_vals = torch.from_numpy(rows), torch.from_numpy(vals)
    got_p, got_r = seg_kernel.edge_segment_partials_torch(t_rows, t_vals, sink)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(exp_r))
    # each run has at most 128 terms: two orders within 2·127·2^-24·Σ|t|
    absum, _ = seg_kernel.edge_segment_partials_torch(t_rows, t_vals.abs(), sink)
    assert (np.abs(got_p.numpy() - np.asarray(exp_p))
            <= 2 * 127 * U * absum.numpy()).all()
    # unused ranks hold 0
    n_runs = 1 + (rows[:, 1:] != rows[:, :-1]).sum(axis=1)
    unused = np.arange(128)[None] >= n_runs[:, None]
    assert (got_p.numpy()[unused] == 0).all()
