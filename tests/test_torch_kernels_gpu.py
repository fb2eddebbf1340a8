"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels build at first
use) and skip without one.  They import only torch, numpy and
``repro_torch``, so they run where JAX is not installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import DiGraph, edgebatch, traversal, updates
from repro_torch.io import synthetic
from repro_torch.kernels import KERNELS
from repro_torch.kernels.bsr_spmm import kernel as bsr_kernel
from repro_torch.kernels.bsr_spmm import ops as bsr_ops
from repro_torch.configs import h2o_danube_1_8b, two_tower_retrieval
from repro_torch.kernels.csr_build import kernel as cb_kernel
from repro_torch.kernels.edge_segment_sum import kernel as seg_kernel
from repro_torch.kernels.edge_segment_sum import ops as seg_ops
from repro_torch.kernels.embedding_bag import kernel as bag_kernel
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.slot_update import kernel as su_kernel
from repro_torch.kernels.slot_update.ref import merge_rows_reference
from repro_torch.kernels.slot_walk import kernel as sw_kernel
from repro_torch.models.recsys import two_tower
from repro_torch.models.transformer import model as tm

pytestmark = pytest.mark.gpu
SENT = np.iinfo(np.int32).max
PARTIALS_RTOL = 2 * 127 * 2.0**-24
U = 2.0**-24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n_tiles", [1, 7, 1000, 4099])
def test_tile_cumsum_matches_plain(cuda, n_tiles):
    x = torch.from_numpy(
        np.random.default_rng(n_tiles).uniform(0, 1e4, (n_tiles, 128)).astype(np.float32)
    ).to(cuda)
    before = KERNELS["tile_cumsum"].launches
    got = sw_kernel.tile_cumsum(x)
    exp = sw_kernel.tile_cumsum_torch(x)
    assert KERNELS["tile_cumsum"].launches == before + 1
    # the warp scan adds in another order than a sequential cumsum
    scale = exp.abs().amax(dim=1, keepdim=True)
    assert bool(((got - exp).abs() <= 1e-5 * exp.abs() + 1e-6 * scale).all())


@pytest.mark.parametrize("m,n", [(0, 5), (1000, 37), (200_000, 4096)])
def test_count_degrees_bit_exact(cuda, m, n):
    rng = np.random.default_rng(m)
    src = rng.integers(-3, n + 3, m).astype(np.int32)
    s = torch.from_numpy(src).to(cuda)
    got = cb_kernel.count_degrees(s, n)
    assert torch.equal(got, cb_kernel.count_degrees_torch(s, n))


def _merge_case(rng, a, w, k, full=False):
    """Sorted rows with a live prefix and sorted op runs (one op per key)."""
    d = np.full((a, w), SENT, np.int32)
    wt = np.zeros((a, w), np.float32)
    degs = (np.full(a, w) if full else rng.integers(0, w // 2 + 1, a)).astype(np.int32)
    bd = np.full((a, k), SENT, np.int32)
    bw = np.zeros((a, k), np.float32)
    bl = np.zeros((a, k), np.int32)
    for i in range(a):
        vals = np.sort(rng.choice(4 * w + 64, degs[i], replace=False))
        d[i, : degs[i]] = vals
        wt[i, : degs[i]] = rng.random(degs[i])
        pool = np.unique(np.concatenate([vals, rng.integers(0, 4 * w + 64, k)]))
        ops = np.sort(rng.choice(pool, min(int(rng.integers(0, k + 1)), pool.size),
                                 replace=False))
        bd[i, : ops.size] = ops
        bw[i, : ops.size] = rng.random(ops.size)
        bl[i, : ops.size] = rng.integers(0, 2, ops.size)
        if full:  # full rows may only delete or upsert
            bl[i, : ops.size] |= ~np.isin(ops, vals)
    return d, wt, degs, bd, bw, bl


@pytest.mark.parametrize(
    "a,w,k,full",
    [(16, 8, 4, False), (64, 64, 8, False), (8, 1024, 64, False),
     (3, 32768, 512, False), (4, 512, 1024, False), (16, 32, 16, True)],
)
def test_merge_rows_bit_exact(cuda, a, w, k, full):
    case = _merge_case(np.random.default_rng(a * w + k), a, w, k, full)
    args = [torch.from_numpy(x).to(cuda) for x in case]
    od, ow, cnt = su_kernel.merge_rows(*args)
    pd, pw, pc = su_kernel.merge_rows_torch(*args)
    assert torch.equal(od, pd) and torch.equal(ow, pw) and torch.equal(cnt, pc)
    if w <= 1024:
        rd, rw, rc = merge_rows_reference(*case)
        np.testing.assert_array_equal(od.cpu().numpy(), rd)
        np.testing.assert_array_equal(ow.cpu().numpy(), rw)
        np.testing.assert_array_equal(cnt.cpu().numpy(), rc)


def test_digraph_cuda_matches_plain_backend(cuda):
    """One batch stream through the kernels and through the plain versions
    on the card: identical state after every apply, equal walks."""
    c = synthetic.make_graph("social", scale=11, edge_factor=8, seed=4, device=cuda)
    g = DiGraph.from_csr(c, device=cuda)
    p = g.clone()
    rng = np.random.default_rng(2)
    for _ in range(3):
        plan = updates.plan_update(
            inserts=edgebatch.random_insertions(rng, c.n, 800),
            deletes=edgebatch.random_deletions(rng, g.to_csr(), 800),
        )
        g.apply(plan, backend="cuda")
        p.apply(plan, backend="torch")
        tg, tp = g.state_tree(), p.state_tree()
        for key in tg:
            np.testing.assert_array_equal(tg[key], tp[key], err_msg=key)
    v_k = g.reverse_walk(8, backend="cuda", normalize=True)
    v_p = p.reverse_walk(8, backend="torch", normalize=True)
    # the kernel's scan adds in another order: the hub-row envelope, and
    # for rows whose exact sum is 0 the residue of their tile's prefix
    torch.testing.assert_close(v_k, v_p, rtol=5e-4, atol=1e-6)


def _rows_tiles(rng, n_tiles, sink, kind):
    """[T, 128] slot owners: runs of rows, dead runs carry ``sink``."""
    if kind == "all_sink":
        return np.full((n_tiles, 128), sink, np.int32)
    if kind == "runs_128":  # every slot its own run
        return (np.arange(n_tiles * 128) % sink).reshape(n_tiles, 128).astype(np.int32)
    if kind == "hub":  # one row spanning several tiles between short runs
        lens = rng.integers(1, 40, n_tiles * 4)
        lens[:: 5] = 300
    else:
        lens = rng.integers(1, 40, n_tiles * 4)
    ids = rng.integers(0, sink + 1, lens.shape[0])
    flat = np.repeat(ids, lens)
    flat = np.resize(flat, n_tiles * 128) if flat.size < n_tiles * 128 else flat
    return flat[: n_tiles * 128].reshape(n_tiles, 128).astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "all_sink", "runs_128", "hub"])
@pytest.mark.parametrize("n_tiles", [1, 7, 4099])
def test_slot_walk_partials_matches_plain(cuda, n_tiles, kind):
    rng = np.random.default_rng(n_tiles)
    sink = 1000
    rows = torch.from_numpy(_rows_tiles(rng, n_tiles, sink, kind)).to(cuda)
    for b in (1, 3):  # one walk, and three walks sharing the rows
        vals = torch.from_numpy(
            rng.uniform(0, 1e3, (b * n_tiles, 128)).astype(np.float32)).to(cuda)
        before = KERNELS["slot_walk_partials"].launches
        got_p, got_r = sw_kernel.slot_walk_partials(rows, vals, sink)
        exp_p, exp_r = sw_kernel.slot_walk_partials_torch(rows, vals, sink)
        assert KERNELS["slot_walk_partials"].launches == before + 1
        assert torch.equal(got_r, exp_r)
        # a run of n <= 128 non-negative terms summed in two orders (the
        # segmented warp scan, scatter_add's atomics): each is within
        # (n-1)*2^-24 of the exact sum, so they differ by at most this rtol
        torch.testing.assert_close(got_p, exp_p, rtol=PARTIALS_RTOL, atol=0.0)


def _random_bsr(rng, n_row_blocks, n_col_blocks, max_count):
    """BSR parts with empty row-blocks and uneven counts."""
    counts = rng.integers(0, max_count + 1, n_row_blocks)
    counts[:: 4] = 0
    cols = [np.sort(rng.choice(n_col_blocks, c, replace=False)) for c in counts]
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    block_cols = np.concatenate(cols).astype(np.int32)
    blocks = rng.standard_normal((max(block_cols.size, 1), 128, 128)).astype(np.float32)
    return row_ptr, block_cols, blocks, counts


@pytest.mark.parametrize("d", [8, 128, 256])
def test_bsr_spmm_matches_plain(cuda, d):
    rng = np.random.default_rng(d)
    row_ptr, block_cols, blocks, counts = _random_bsr(rng, 37, 29, 5)
    x = rng.standard_normal((29 * 128, d)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (row_ptr, block_cols, blocks, x)]
    before = KERNELS["bsr_spmm"].launches
    got = bsr_kernel.bsr_spmm(*args, d_tile=min(d, 128))
    exp = bsr_kernel.bsr_spmm_torch(*args)
    assert KERNELS["bsr_spmm"].launches == before + 1
    # FP32 FMAs in another order than bmm + index_add_: rtol 1e-5 and an
    # atol of 1e-5 x the largest |y| for sums that cancel
    torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5 * float(exp.abs().max()))
    empty = np.repeat(counts == 0, 128)
    assert bool((got[torch.from_numpy(empty).to(cuda)] == 0).all())


def test_bsr_walk_cuda_matches_plain(cuda):
    """A road graph whose pow-2 max_blocks_per_row exceeds every count."""
    c = synthetic.make_graph("road", scale=14, seed=3, weighted=False, device=cuda)
    bsr = bsr_ops.csr_to_bsr(c)
    counts = (bsr.row_ptr[1:] - bsr.row_ptr[:-1]).cpu().numpy()
    assert bsr.max_blocks_per_row > counts.min()
    before = KERNELS["bsr_spmm"].launches
    got = bsr_ops.reverse_walk_bsr(bsr, 12, c.n, backend="cuda")
    assert KERNELS["bsr_spmm"].launches == before + 12
    exp = bsr_ops.reverse_walk_bsr(bsr, 12, c.n, backend="torch")
    torch.testing.assert_close(got, exp, rtol=1e-5, atol=0.0)
    # the interval-less walk over the same graph's arena; not the image
    # walk, whose prefix differences lose the digits of a road graph's
    # small rows (~5e-4 relative at 12 steps, as in repro)
    g = DiGraph.from_csr(c, device=cuda)
    ref = traversal.reverse_walk_slotted(g.dst, g.slot_rows, 12, c.n, backend="cuda")
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=0.0)


def test_ranked_walk_cuda_matches_plain(cuda):
    """The interval-less walk on a churned scale-10 graph: the kernel path
    against the same glue on the plain partials, one walk and three."""
    c = synthetic.make_graph("social", scale=10, edge_factor=8, seed=5, device=cuda)
    g = DiGraph.from_csr(c, device=cuda)
    rng = np.random.default_rng(5)
    g.apply(updates.plan_update(
        inserts=edgebatch.random_insertions(rng, c.n, 500),
        deletes=edgebatch.random_deletions(rng, c, 500),
    ))
    nv = g.n_max_vertex() + 1
    v0 = torch.from_numpy(rng.random((3, nv)).astype(np.float32)).to(cuda)
    for visits0 in (None, v0):
        before = KERNELS["slot_walk_partials"].launches
        got = traversal.reverse_walk_slotted(g.dst, g.slot_rows, 8, nv, backend="cuda",
                                             normalize=True, visits0=visits0)
        assert KERNELS["slot_walk_partials"].launches == before + 8
        exp = traversal.reverse_walk_slotted(g.dst, g.slot_rows, 8, nv, backend="torch",
                                             normalize=True, visits0=visits0)
        # sums of non-negative terms in another order (and atomics in the
        # fold): a few ulps a step
        torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-6)


def _segment_tiles(rng, n_tiles, sink, kind):
    """[T, 128] rows ascending within each tile (hubs, dead rows >= sink)."""
    if kind == "all_sink":
        return np.full((n_tiles, 128), sink, np.int32)
    if kind == "runs_128":  # every slot its own run
        return np.tile(np.arange(128, dtype=np.int32), (n_tiles, 1))
    rows = np.sort(rng.integers(0, sink + 3, (n_tiles, 128)), axis=1)
    if kind == "hub":
        rows[:, :100] = rows[:, :1]
    return rows.astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "hub", "all_sink", "runs_128"])
@pytest.mark.parametrize("n_tiles,dp", [(1, 1), (7, 3), (7, 6), (1000, 16), (33, 64),
                                        (5, 200), (9, 256)])
def test_edge_segment_partials_matches_plain(cuda, n_tiles, dp, kind):
    rng = np.random.default_rng(n_tiles * dp)
    sink = 200
    rows = torch.from_numpy(_segment_tiles(rng, n_tiles, sink, kind)).to(cuda)
    vals = torch.from_numpy(
        rng.standard_normal((n_tiles, 128, dp)).astype(np.float32)).to(cuda)
    before = KERNELS["edge_segment_partials"].launches
    got_p, got_r = seg_kernel.edge_segment_partials(rows, vals, sink)
    assert KERNELS["edge_segment_partials"].launches == before + 1
    exp_p, exp_r = seg_kernel.edge_segment_partials_torch(rows, vals, sink)
    assert torch.equal(got_r, exp_r)
    # signed terms: a run of n <= 128 summed in two orders differs by at
    # most 2*(n-1)*2^-24 times the run's sum of |terms|
    absum, _ = seg_kernel.edge_segment_partials_torch(rows, vals.abs(), sink)
    assert bool(((got_p - exp_p).abs() <= 2 * 127 * U * absum).all())
    starts = torch.ones_like(rows, dtype=torch.bool)
    starts[:, 1:] = rows[:, 1:] != rows[:, :-1]
    unused = torch.arange(128, device=cuda)[None] >= starts.sum(dim=1, keepdim=True)
    assert bool((got_p[unused] == 0).all())


@pytest.mark.parametrize("e,d", [(1, 1), (300, 16), (5000, 64), (777, 5), (2000, 200)])
def test_edge_segment_sum_cuda_matches_plain(cuda, e, d):
    rng = np.random.default_rng(e + d)
    n = max(e // 20, 2)
    rows_np = np.sort(rng.integers(0, n + 2, e)).astype(np.int32)  # some >= n
    rows = torch.from_numpy(rows_np).to(cuda)
    vals = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32)).to(cuda)
    before = KERNELS["edge_segment_partials"].launches
    got = seg_ops.edge_segment_sum(rows, vals, num_segments=n)
    assert KERNELS["edge_segment_partials"].launches == before + 1
    exp = seg_ops.edge_segment_sum(rows, vals, num_segments=n, backend="torch")
    ref = seg_ops.edge_segment_sum_reference(rows, vals, num_segments=n)
    cnt = torch.bincount(rows.long(), minlength=n + 2)[:n, None].to(torch.float32)
    absum = seg_ops.edge_segment_sum_reference(rows, vals.abs(), num_segments=n)
    bound = 2 * torch.clamp(cnt - 1, min=0) * U * absum
    assert got.shape == (n, d)
    assert bool(((got - exp).abs() <= bound).all())
    assert bool(((got - ref).abs() <= bound).all())


def test_edge_segment_partials_rejects_bad_operands(cuda):
    rows = torch.zeros((2, 128), dtype=torch.int32, device=cuda)
    vals = torch.zeros((2, 128, 8), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        seg_kernel.edge_segment_partials(rows, vals.double(), 4)
    with pytest.raises(ValueError, match="int32"):
        seg_kernel.edge_segment_partials(rows.long(), vals, 4)
    with pytest.raises(ValueError, match="tiles|expected"):
        seg_kernel.edge_segment_partials(rows[:, :64].contiguous(), vals[:, :64].contiguous(), 4)
    off = torch.zeros(2 * 128 * 8 + 1, device=cuda)[1:].view(2, 128, 8)  # 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        seg_kernel.edge_segment_partials(rows, off, 4)


def _bag_case(rng, v, d, b, k):
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(-1, v, (b, k)).astype(np.int32)
    idx[0] = -1        # an empty bag
    idx[1, 0] = v + 7  # reads row v-1
    w = rng.uniform(0.5, 1.5, (b, k)).astype(np.float32)
    return table, idx, w


@pytest.mark.parametrize("combine", ["sum", "mean", "max"])
@pytest.mark.parametrize("v,d,b,k", [(50, 256, 300, 16), (40, 16, 7, 5), (30, 6, 9, 3),
                                     (1000, 260, 70, 40), (20, 1, 5, 64)])
def test_embedding_bag_matches_plain(cuda, combine, v, d, b, k):
    table, idx, w = _bag_case(np.random.default_rng(v + d + k), v, d, b, k)
    args = [torch.from_numpy(a).to(cuda) for a in (table, idx, w)]
    before = KERNELS["embedding_bag"].launches
    got = bag_kernel.embedding_bag(*args, combine)
    assert KERNELS["embedding_bag"].launches == before + 1
    exp = bag_kernel.embedding_bag_torch(*args, combine)
    assert bool((got[0] == 0).all())
    if combine == "max":
        assert torch.equal(got, exp)
    else:
        # FMAs on the card, product then sum in the plain version: two
        # roundings of the same K-term sum, within 2*K*2^-24*sum|row*w|
        t, i, wt = args
        rows = t[i.long().clamp(0, v - 1)].abs()
        absum = (rows * torch.where(i >= 0, wt, 0.0)[..., None]).sum(dim=1)
        assert bool(((got - exp).abs() <= 2 * k * U * absum).all())


def test_embedding_bag_op_pads_and_defaults(cuda):
    table, idx, _ = _bag_case(np.random.default_rng(3), 64, 32, 6, 5)
    t, i = torch.from_numpy(table).to(cuda), torch.from_numpy(idx).to(cuda)
    got = bag_ops.embedding_bag(t, i, combine="max")
    assert torch.equal(got, bag_ops.embedding_bag(t, i, combine="max", backend="torch"))
    one = bag_ops.embedding_bag(t, i[2], combine="max")
    assert torch.equal(one[0], got[2])


def test_embedding_bag_rejects_bad_operands(cuda):
    t = torch.zeros((10, 8), device=cuda)
    i = torch.zeros((3, 4), dtype=torch.int32, device=cuda)
    w = torch.ones((3, 4), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        bag_kernel.embedding_bag(t.double(), i, w, "sum")
    with pytest.raises(ValueError, match="int32"):
        bag_kernel.embedding_bag(t, i.long(), w, "sum")
    with pytest.raises(ValueError, match="differ"):
        bag_kernel.embedding_bag(t, i, w[:, :2].contiguous(), "sum")
    off = torch.zeros(81, device=cuda)[1:].view(10, 8)  # 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        bag_kernel.embedding_bag(off, i, w, "sum")


def test_two_tower_cuda_matches_plain(cuda):
    """SMOKE's model on the card: the bag kernel against the plain bag."""
    cfg = two_tower_retrieval.SMOKE
    m = two_tower.init_model(cfg, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    rng = np.random.default_rng(0)
    k = cfg.bag_size

    def bags(n, nf, vocab):
        ids = rng.integers(0, vocab, (n, nf, k))
        lens = rng.integers(0, k + 1, (n, nf, 1))
        return torch.from_numpy(np.where(np.arange(k) < lens, ids, -1).astype(np.int32)).to(cuda)

    batch = {"user_bags": bags(64, cfg.n_user_fields, cfg.n_users),
             "item_bags": bags(64, cfg.n_item_fields, cfg.n_items)}
    before = KERNELS["embedding_bag"].launches
    got = m.serve_step(batch)
    assert KERNELS["embedding_bag"].launches == before + 2  # one per tower
    exp = m.with_backend("torch").serve_step(batch)
    torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# flash_attention
# --------------------------------------------------------------------------
def _fa_close(got, exp, v, dtype):
    """Kernel against plain: the f32 sums of <= 4096 terms in two orders
    (gamma_4096 = 4096 * 2^-24 = 2^-12 of max|v|), and for bfloat16 one
    rounding of each f32 result (<= 2^-7 relative)."""
    assert got.dtype == exp.dtype == dtype
    torch.testing.assert_close(got.float(), exp.float(),
                               rtol=2**-7 if dtype == torch.bfloat16 else 1e-5,
                               atol=2**-12 * float(v.float().abs().max()))


def _fa_inputs(cuda, dtype, b, hq, hkv, sq, skv, d, seed=0):
    g = torch.Generator(cuda).manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device=cuda).to(dtype)
                 for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 128])
def test_flash_attention_head_dims(cuda, dtype, d):
    q, k, v = _fa_inputs(cuda, dtype, 2, 4, 2, 256, 256, d, seed=d)
    before = KERNELS["flash_attention"].launches
    got = fa_kernel.flash_attention(q, k, v, causal=True, window=0)
    assert KERNELS["flash_attention"].launches == before + 1
    _fa_close(got, fa_kernel.flash_attention_torch(q, k, v, causal=True, window=0), v, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,d,causal,window",
    [
        (1, 4, 4, 128, 128, 32, False, 0),     # group 1, not causal
        (1, 8, 2, 256, 256, 64, True, 96),     # group 4, window
        (2, 4, 2, 320, 320, 80, True, 40),     # group 2, window, a ragged last tile
        (1, 4, 1, 256, 256, 80, False, 33),    # window without causality
        (1, 2, 1, 16, 16, 16, True, 0),        # less than one tile
        (1, 4, 1, 256, 64, 32, True, 16),      # Sq > Skv: rows >= 80 see no key
        (1, 4, 2, 64, 200, 48, False, 0),      # Sq < Skv, ragged keys
        (1, 2, 2, 100, 100, 100, True, 0),     # D not a multiple of 16
    ],
)
def test_flash_attention_masks_and_groups(cuda, dtype, b, hq, hkv, sq, skv, d, causal, window):
    q, k, v = _fa_inputs(cuda, dtype, b, hq, hkv, sq, skv, d, seed=sq + d)
    got = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    exp = fa_kernel.flash_attention_torch(q, k, v, causal=causal, window=window)
    _fa_close(got, exp, v, dtype)
    if sq > skv:
        assert not bool(got[:, :, skv + window:].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_long_window(cuda, dtype):
    """The model's head shape at S = 8192 with its 4096-key window."""
    q, k, v = _fa_inputs(cuda, dtype, 1, 4, 1, 8192, 8192, 80, seed=1)
    got = fa_kernel.flash_attention(q, k, v, causal=True, window=4096)
    _fa_close(got, fa_kernel.flash_attention_torch(q, k, v, causal=True, window=4096), v, dtype)


def test_flash_attention_rejects_bad_operands(cuda):
    q, k, v = _fa_inputs(cuda, torch.float32, 1, 4, 2, 64, 64, 32)
    with pytest.raises(ValueError, match="expected one of"):
        fa_kernel.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="bfloat16"):
        fa_kernel.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa_kernel.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="1..128"):
        fa_kernel.flash_attention(*_fa_inputs(cuda, torch.float32, 1, 1, 1, 8, 8, 160))
    with pytest.raises(ValueError, match="group"):
        fa_kernel.flash_attention(*_fa_inputs(cuda, torch.float32, 1, 3, 2, 8, 8, 16))
    # the op routes a CUDA tensor to the kernel at every shape, Sq == 1 too
    before = KERNELS["flash_attention"].launches
    fa_ops.attention(q[:, :, :1].contiguous(), k, v, causal=False)
    assert KERNELS["flash_attention"].launches == before + 1


def test_transformer_cuda_matches_plain(cuda):
    """SMOKE with flash attention on the card, kernel against plain, f32."""
    cfg = dataclasses.replace(h2o_danube_1_8b.SMOKE, attn_impl="flash", attn_block=16)
    m = tm.init_model(cfg, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 64), device=cuda)
    before = KERNELS["flash_attention"].launches
    got, _ = m(toks)
    assert KERNELS["flash_attention"].launches == before + cfg.n_layers
    exp, _ = m.with_backend("torch")(toks)
    torch.testing.assert_close(got, exp, rtol=1e-4, atol=1e-4)
