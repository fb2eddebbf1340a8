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

from repro_torch.core import DiGraph, csr, edgebatch, traversal, updates
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
from repro_torch.core import tree
from repro_torch.launch import steps as gnn_steps
from repro_torch.models.gnn import common as gnn_common
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


def _sorted_sources(case):
    """(sorted int32 sources, n) for the degree_offsets cases."""
    rng = np.random.default_rng(len(case))
    if case == "empty":
        return np.zeros(0, np.int32), 5
    if case == "n0":
        return np.zeros(0, np.int32), 0
    if case == "n1":
        return np.zeros(9, np.int32), 1
    if case == "gaps_at_both_ends":
        return np.repeat(np.array([1000, 1001, 5000], np.int32), [3, 70, 2]), 2_000_000
    if case == "one_vertex_holds_every_edge":
        return np.full(1_000_003, 777_777, np.int32), 2_097_152
    if case == "hubs_across_blocks":
        return np.repeat(np.arange(0, 50, 7, dtype=np.int32), 300_001), 64
    if case.startswith("tail_"):  # M mod 4 = 1, 2, 3
        m = 4000 + int(case[-1])
        return np.sort(rng.integers(0, 3000, m)).astype(np.int32), 3000
    if case == "many_grid_passes":
        return np.sort(rng.integers(0, 200_000, 5_000_000)).astype(np.int32), 200_000
    if case == "power_law":
        deg = np.minimum(rng.zipf(1.8, 100_000), 50_000)
        return np.repeat(np.arange(100_000, dtype=np.int32), deg), 100_000
    raise ValueError(case)


DEGREE_OFFSET_CASES = ["empty", "n0", "n1", "gaps_at_both_ends", "one_vertex_holds_every_edge",
                       "hubs_across_blocks", "tail_1", "tail_2", "tail_3", "many_grid_passes",
                       "power_law"]


@pytest.mark.parametrize("case", DEGREE_OFFSET_CASES)
@pytest.mark.parametrize("view", [0, 1, 2, 3])
def test_degree_offsets_bit_exact(cuda, case, view):
    """Against torch.searchsorted and the cumsum of count_degrees, on the
    sources as they are and as a view 1-3 elements into a larger buffer
    (a start off the 16-byte boundary of the 128-bit loads)."""
    src, n = _sorted_sources(case)
    buf = torch.from_numpy(np.concatenate([np.zeros(view, np.int32), src])).to(cuda)
    s = buf[view:]
    before = KERNELS["degree_offsets"].launches
    got = cb_kernel.degree_offsets(s, n)
    assert KERNELS["degree_offsets"].launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n + 1,)
    assert torch.equal(got, cb_kernel.degree_offsets_torch(s, n))
    assert torch.equal(got[1:] - got[:-1], cb_kernel.count_degrees(s, n))
    assert int(got[0]) == 0 and int(got[-1]) == s.shape[0]
    assert torch.equal(cb_kernel.degree_offsets(s, n), got)  # same bits every call


@pytest.mark.parametrize("src", [[-3, -1, 0, 2], [0, 1, 4, 4], [5, 6], [-1, -1]])
def test_degree_offsets_out_of_range_sources_make_from_coo_raise(cuda, src):
    s = torch.tensor(sorted(src), dtype=torch.int32, device=cuda)
    got = cb_kernel.degree_offsets(s, 4)
    assert torch.equal(got, cb_kernel.degree_offsets_torch(s, 4))
    assert int(got[0]) != 0 or int(got[4]) != len(src)
    with pytest.raises(ValueError, match="out of range"):
        csr.from_coo(src, list(range(len(src))), n=4, dedup=False, engine="cuda", device=cuda)


def test_degree_offsets_rejects_bad_operands(cuda):
    s = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        cb_kernel.degree_offsets(s.to(torch.int64), 4)
    with pytest.raises(ValueError):
        cb_kernel.degree_offsets(s[::2], 4)
    with pytest.raises(ValueError):
        cb_kernel.degree_offsets(s, -1)


@pytest.mark.parametrize("presorted", [False, True])
def test_device_build_launches_degree_offsets(cuda, presorted):
    src, dst, wgt, n = synthetic.make_coo("social", scale=12, edge_factor=8, seed=3)
    if presorted:
        c = csr.from_coo(src, dst, wgt, n=n, dedup=False, device="cpu")
        src = np.repeat(np.arange(n), np.diff(c.offsets.numpy()))
        dst, wgt = c.dst.numpy(), c.wgt.numpy()
    host = csr.from_coo(src, dst, wgt, n=n, dedup=False, engine="host", device=cuda)
    for k in KERNELS.values():
        k.launches = 0
    got = csr.from_coo(src, dst, wgt, n=n, dedup=False, engine="cuda", device=cuda,
                       presorted=presorted or None)
    assert KERNELS["degree_offsets"].launches == 1
    assert all(v.launches == 0 for k, v in KERNELS.items() if k != "degree_offsets")
    for f in ("offsets", "dst", "wgt"):
        assert torch.equal(getattr(got, f), getattr(host, f))


def _fused_case(rng, a, w, k, *, grow, pad, full):
    """One width group of a plan on a small arena: rows in place or grown
    into a new block, pad rows, sorted op runs whose inserts fit the new
    block.  Untouched slots hold noise, so a stray write shows."""
    cap_e = 2 * a * w + 64
    dst = rng.integers(0, 1 << 30, cap_e).astype(np.int32)
    wgt = rng.standard_normal(cap_e).astype(np.float32)
    slot_rows = rng.integers(0, 1 << 20, cap_e).astype(np.int32)
    nv = a + 3
    row_ops = np.zeros((6, a), np.int32)
    bd = np.full((a, k), SENT, np.int32)
    bw = np.zeros((a, k), np.float32)
    bl = np.zeros((a, k), np.int32)
    row_ids = rng.permutation(nv)[:a].astype(np.int32)
    for r in range(a):
        if r >= a - pad:  # pad row: no block, a SENTINEL run
            row_ops[:, r] = (-1, 0, -1, 0, 0, nv + 7)
            continue
        moved = grow and r % 2 == 0
        old_cap = max(w // 2, 1) if moved else w
        old_start = 32 + r * w
        new_start = 32 + (a + r) * w if moved else old_start
        deg = old_cap if full else int(rng.integers(0, old_cap + 1))
        vals = np.sort(rng.choice(4 * w + 64, deg, replace=False))
        dst[old_start:old_start + deg] = vals
        dst[old_start + deg:old_start + old_cap] = SENT
        pool = np.unique(np.concatenate([vals, rng.integers(0, 4 * w + 64, k)]))
        ops = np.sort(rng.choice(pool, min(int(rng.integers(0, k + 1)), pool.size),
                                 replace=False))
        dels = rng.integers(0, 2, ops.size).astype(bool)
        new = ~np.isin(ops, vals) & ~dels
        # flip inserts of new keys to deletes until the row fits its block
        over = deg + int(new.sum()) - w
        if over > 0:
            dels[np.nonzero(new)[0][:over]] = True
        bd[r, :ops.size] = ops
        bw[r, :ops.size] = rng.random(ops.size)
        bl[r, :ops.size] = dels
        row_ops[:, r] = (old_start, old_cap, new_start, w, deg, row_ids[r])
    lo = rng.integers(0, 1000, nv).astype(np.int32)
    hi = rng.integers(0, 1000, nv).astype(np.int32)
    return (dst, wgt, slot_rows, row_ops, np.stack([bd, bl]), bw), (lo, hi)


@pytest.mark.parametrize(
    "a,w,k,grow,pad,full",
    [(40, 32, 8, False, 3, False), (40, 32, 8, True, 3, False), (64, 32, 64, True, 0, False),
     (16, 32, 16, False, 0, True), (7, 32, 4, True, 7, False), (24, 64, 8, True, 5, False),
     (8, 1024, 64, True, 2, False), (4, 512, 1024, False, 0, False),
     (3, 32768, 512, True, 1, False), (2, 16384, 1024, False, 0, True),
     (16, 8, 4, False, 0, False), (64, 64, 8, False, 0, False), (8, 1024, 64, False, 0, False),
     (3, 32768, 512, False, 0, False), (16, 32, 16, True, 0, True)],
)
def test_merge_rows_fused_matches_plain(cuda, a, w, k, grow, pad, full):
    """In place and grown rows, pad rows, full rows, rows narrower than a
    warp, runs wider than a warp and hub-wide rows (staged in device
    memory): the arena, the owner map, the [lo, hi) refresh and the counts
    bit for bit."""
    rng = np.random.default_rng(a * w + k + grow)
    case, blocks = _fused_case(rng, a, w, k, grow=grow, pad=pad, full=full)
    moves = grow

    def run(fn):
        dst, wgt, slot_rows, row_ops, bdl, bw = (torch.from_numpy(x).to(cuda) for x in case)
        lo, hi = (torch.from_numpy(x).to(cuda) for x in blocks)
        counts = fn(dst, wgt, slot_rows, row_ops, bdl, bw, width=w, moves=moves, lo=lo, hi=hi)
        return dst, wgt, slot_rows, lo, hi, counts

    before = KERNELS["merge_rows_fused"].launches
    got = run(su_kernel.merge_rows_fused)
    assert KERNELS["merge_rows_fused"].launches == before + 1
    exp = run(su_kernel.merge_rows_fused_torch)
    for name, g, e_ in zip(("dst", "wgt", "slot_rows", "lo", "hi", "counts"), got, exp):
        assert torch.equal(g, e_), name
    assert int(got[5][a - pad:].abs().sum()) == 0  # pad rows merge nothing
    if w <= 1024:  # the merged rows (new blocks hold w slots) against numpy
        dst0, wgt0, _, row_ops, bdl, bw = case
        real = row_ops[2] >= 0
        old_s, _, new_s, _, degs, _ = row_ops[:, real].astype(np.int64)
        lane = np.arange(w)
        live = lane < degs[:, None]
        take = old_s[:, None] + np.minimum(lane, np.maximum(degs[:, None] - 1, 0))
        rd, rw, rc = merge_rows_reference(
            np.where(live, dst0[take], SENT).astype(np.int32),
            np.where(live, wgt0[take], 0).astype(np.float32), degs.astype(np.int32),
            bdl[0][real], bw[real], bdl[1][real])
        at = new_s[:, None] + lane
        np.testing.assert_array_equal(got[0].cpu().numpy()[at], rd)
        np.testing.assert_array_equal(got[1].cpu().numpy()[at], rw)
        np.testing.assert_array_equal(got[5].cpu().numpy()[real], rc)


def test_merge_rows_fused_rejects_bad_operands(cuda):
    case, _ = _fused_case(np.random.default_rng(0), 4, 32, 4, grow=False, pad=0, full=False)
    dst, wgt, slot_rows, row_ops, bdl, bw = (torch.from_numpy(x).to(cuda) for x in case)
    with pytest.raises(ValueError, match="float32"):
        su_kernel.merge_rows_fused(dst, wgt.double(), slot_rows, row_ops, bdl, bw, width=32)
    with pytest.raises(ValueError, match="row_ops"):
        su_kernel.merge_rows_fused(dst, wgt, slot_rows, row_ops[:5], bdl, bw, width=32)
    with pytest.raises(ValueError, match="contiguous"):
        su_kernel.merge_rows_fused(dst, wgt, slot_rows, row_ops, bdl, bw.t().contiguous().t(),
                                   width=32)


def test_digraph_batch_kinds_cuda_match_plain(cuda):
    """Delete, insert and mixed batches through the fused kernel against the
    plain backend, with a warm walk image so the [lo, hi) refresh runs."""
    c = synthetic.make_graph("social", scale=11, edge_factor=8, seed=9, device=cuda)
    g = DiGraph.from_csr(c, device=cuda)
    p = g.clone()
    for x in (g, p):
        x.reverse_walk(1)  # warm the image's [lo, hi) blocks
    rng = np.random.default_rng(3)
    for kind in ("delete", "insert", "mixed"):
        plan = updates.plan_update(
            inserts=None if kind == "delete" else edgebatch.random_insertions(rng, c.n, 900),
            deletes=None if kind == "insert" else edgebatch.random_deletions(
                rng, g.to_csr(), 900),
        )
        before = KERNELS["merge_rows_fused"].launches
        g.apply(plan, backend="cuda")
        assert KERNELS["merge_rows_fused"].launches > before
        p.apply(plan, backend="torch")
        tg, tp = g.state_tree(), p.state_tree()
        for key in tg:
            np.testing.assert_array_equal(tg[key], tp[key], err_msg=f"{kind}: {key}")
        for bg, bp in zip(g.to_walk_image().device_blocks(), p.to_walk_image().device_blocks()):
            assert torch.equal(bg, bp), kind


def test_fused_apply_cuda_syncs_only_for_counts(cuda, monkeypatch):
    """On the card ``fused_apply`` synchronises with the host once: the
    counts copy (no nonzero, no boolean-mask indexing, no .item())."""
    import warnings

    from repro_torch.kernels.slot_update import ops as su_ops

    c = synthetic.make_graph("social", scale=10, edge_factor=8, seed=2, device=cuda)
    g = DiGraph.from_csr(c, device=cuda)
    g.reverse_walk(1)
    inner, syncs = su_ops.fused_apply, []

    def watched(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                out = inner(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs.append([str(w.message) for w in seen if "synchroniz" in str(w.message)])
        return out

    monkeypatch.setattr(su_ops, "fused_apply", watched)
    rng = np.random.default_rng(4)
    g.apply(updates.plan_update(inserts=edgebatch.random_insertions(rng, c.n, 500),
                                deletes=edgebatch.random_deletions(rng, g.to_csr(), 500)))
    assert len(syncs) == 1 and len(syncs[0]) == 1, syncs


def test_fused_apply_cuda_reuses_its_staging_buffer(cuda):
    """Batches whose operands fit the pinned staging buffer reuse it; one
    that outgrows it gets a buffer at least twice as large, and state stays
    equal to the plain backend's throughout."""
    from repro_torch.kernels.slot_update import ops as su_ops

    c = synthetic.make_graph("social", scale=10, edge_factor=8, seed=6, device=cuda)
    g = DiGraph.from_csr(c, device=cuda)
    p = g.clone()
    rng = np.random.default_rng(6)
    su_ops._STAGE.clear()
    seen = []
    for n_ops in (600, 200, 6000):
        plan = updates.plan_update(inserts=edgebatch.random_insertions(rng, c.n, n_ops),
                                   deletes=edgebatch.random_deletions(rng, g.to_csr(), n_ops))
        g.apply(plan, backend="cuda")
        p.apply(plan, backend="torch")
        buf = su_ops._STAGE["buf"]
        assert buf.is_pinned()
        seen.append((buf.data_ptr(), buf.numel()))
    assert seen[1] == seen[0]  # the smaller batch reused the buffer
    assert seen[2][1] >= 2 * seen[1][1]  # the larger one grew it
    tg, tp = g.state_tree(), p.state_tree()
    for key in tg:
        np.testing.assert_array_equal(tg[key], tp[key], err_msg=key)


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


REP_NAMES = ["coo", "lazy", "chunked", "vector2d"]


def _rep_stream(cuda, name, seed):
    """A representation loaded on the card, its walk image built, and three
    (delete, insert, mixed) plans for it."""
    from repro_torch.core import REPRESENTATIONS

    c = synthetic.make_graph("social", scale=11, edge_factor=8, seed=seed, device=cuda)
    g = REPRESENTATIONS[name].from_csr(c, device=cuda)
    g.reverse_walk(1)  # builds the image and its [lo, hi) blocks
    rng = np.random.default_rng(seed)
    plans = [updates.plan_update(deletes=edgebatch.random_deletions(rng, c, 600)),
             updates.plan_update(inserts=edgebatch.random_insertions(rng, c.n, 600)),
             updates.plan_update(inserts=edgebatch.random_insertions(rng, c.n, 900),
                                 deletes=edgebatch.random_deletions(rng, c, 900))]
    return c, g, plans


@pytest.mark.parametrize("name", REP_NAMES)
def test_rep_walk_flush_cuda_matches_plain(cuda, name):
    """Each batch, then a walk_flush through the kernels and, on a twin,
    through the plain versions: the patched images bit for bit, the walks
    within the kernel scan's envelope."""
    from repro_torch.core import REPRESENTATIONS

    c, g, plans = _rep_stream(cuda, name, 5)
    p = REPRESENTATIONS[name].from_csr(c, device=cuda)
    p.reverse_walk(1)
    for plan in plans:
        g, _ = g.apply(plan)
        p, _ = p.apply(plan)
        before = {k: KERNELS[k].launches for k in ("merge_rows_fused", "tile_cumsum")}
        v_k = g.reverse_walk(8, backend="cuda", normalize=True)
        assert KERNELS["merge_rows_fused"].launches > before["merge_rows_fused"]
        assert KERNELS["tile_cumsum"].launches == before["tile_cumsum"] + 8
        v_p = p.reverse_walk(8, backend="torch", normalize=True)
        ig, ip = g._image, p._image
        assert (ig.bump, ig.live) == (ip.bump, ip.live)
        for f in ("starts", "caps", "degs"):
            np.testing.assert_array_equal(getattr(ig, f), getattr(ip, f), err_msg=f)
        for f in ("dst", "wgt", "rows"):
            assert torch.equal(getattr(ig, f).view(torch.int32), getattr(ip, f).view(torch.int32)), f
        for x, y in zip(ig.device_blocks(), ip.device_blocks()):
            assert torch.equal(x, y)
        torch.testing.assert_close(v_k, v_p, rtol=5e-4, atol=1e-6)
    ref = DiGraph.from_csr(c, device=cuda)
    for plan in plans:
        ref.apply(plan)
    got, exp = g.to_csr(), ref.to_csr()
    for f in ("offsets", "dst", "wgt"):
        assert torch.equal(getattr(got, f), getattr(exp, f)), f


@pytest.mark.parametrize("name", REP_NAMES)
def test_rep_walk_flush_syncs_only_for_counts(cuda, name):
    """A stream round's walk_flush waits for the device once: the merge
    counts copy, after the walk's steps are queued."""
    import warnings

    _, g, plans = _rep_stream(cuda, name, 7)
    g, _ = g.apply(plans[2])
    torch.cuda.synchronize()
    img = g._image
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            v = img.walk_flush(6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in seen if "synchroniz" in str(w.message)]
    assert v is not None and len(syncs) == 1, syncs


@pytest.mark.parametrize("name", REP_NAMES)
def test_rep_sealed_generation_survives_cuda_patch(cuda, name):
    """A generation sealed before in-place patches on the card keeps its
    buffers and its walk."""
    from repro_torch.core import walk_image

    _, g, plans = _rep_stream(cuda, name, 9)
    gen = walk_image.seal_generation(g, 1)
    bufs = [t.clone() for t in (gen.dst, gen.wgt, gen.rows)]
    v0 = gen.walk(6, normalize=True)
    for plan in plans:
        g, _ = g.apply(plan)
        g.reverse_walk(6)
    assert g._image.dst.data_ptr() != gen.dst.data_ptr()
    for a, b in zip((gen.dst, gen.wgt, gen.rows), bufs):
        assert torch.equal(a, b)
    assert torch.equal(gen.walk(6, normalize=True), v0)


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


def _segment_rows(rng, e, n, kind):
    """[E] ascending edge rows for the segment sum's edge cases."""
    if kind == "all_dropped":
        return np.sort(rng.integers(n, n + 9, e))
    if kind == "negative":
        return np.sort(rng.integers(-6, n + 2, e))
    if kind == "tile_rows":  # runs that begin exactly on tile boundaries
        return np.repeat(np.arange(n), [128, 256, 128, 1, 127, 384] * (n // 6) + [0] * (n % 6))[:e]
    rows = np.sort(rng.integers(0, n + 2, e))  # some >= n
    if kind == "hub":  # one row of 20,000 edges: ~157 tiles
        rows = np.sort(np.concatenate([rows, np.full(20_000, n // 2)]))
    return rows


@pytest.mark.parametrize(
    "e,d,kind",
    [(0, 16, "random"), (1, 1, "random"), (127, 3, "random"), (128, 5, "random"),
     (129, 16, "random"), (5000, 64, "random"), (300, 16, "random"), (777, 5, "random"),
     (2000, 200, "random"), (1000, 256, "random"), (3000, 16, "all_dropped"),
     (3000, 16, "negative"), (1024, 16, "tile_rows"), (1024, 3, "tile_rows"),
     (3000, 16, "hub"), (3000, 3, "hub"), (700, 64, "misaligned"),
     (700, 16, "misaligned"), (900, 16, "int64")],
)
def test_edge_segment_sum_cuda_matches_plain(cuda, e, d, kind):
    rng = np.random.default_rng(e + d)
    n = max(e // 20, 6)
    rows_np = _segment_rows(rng, e, n, kind)
    e = rows_np.shape[0]
    rows = torch.from_numpy(rows_np.astype(np.int64 if kind == "int64" else np.int32)).to(cuda)
    vals = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32)).to(cuda)
    if kind == "misaligned":  # a contiguous view 4 bytes into its storage
        buf = torch.zeros(e * d + 1, device=cuda)
        buf[1:] = vals.reshape(-1)
        vals = buf[1:].view(e, d)
        assert vals.is_contiguous() and vals.data_ptr() % 16
    before = KERNELS["edge_segment_runs"].launches
    got = seg_ops.edge_segment_sum(rows, vals, num_segments=n)
    assert KERNELS["edge_segment_runs"].launches == before + (e > 0)
    exp = seg_ops.edge_segment_sum(rows, vals, num_segments=n, backend="torch")
    ref = seg_ops.edge_segment_sum_reference(torch.where(rows < 0, n, rows), vals,
                                             num_segments=n)
    kept_rows = rows[(rows >= 0) & (rows < n)].long()
    cnt = torch.bincount(kept_rows, minlength=n)[:n, None].to(torch.float32)
    absum = seg_ops.edge_segment_sum_reference(torch.where(rows < 0, n, rows), vals.abs(),
                                               num_segments=n)
    bound = 2 * torch.clamp(cnt - 1, min=0) * U * absum  # two orders of deg terms
    assert got.shape == (n, d) and got.dtype == torch.float32
    assert bool(((got - exp).abs() <= bound).all())
    assert bool(((got - ref).abs() <= bound).all())
    assert bool((got[cnt[:, 0] == 0] == 0).all())  # rows without edges
    assert torch.equal(seg_ops.edge_segment_sum(rows, vals, num_segments=n), got)


@pytest.mark.parametrize("d", [3, 16])
@pytest.mark.parametrize("place", ["middle", "aligned", "end"])
@pytest.mark.parametrize("tiles", [2, 3, 65, 129, 130, 157, 257])
def test_edge_segment_sum_cuda_hub_is_exact(cuda, tiles, place, d):
    """A hub row spanning ``tiles`` tiles, beginning inside a tile and
    ending inside a later one (middle), beginning and ending on tile
    boundaries (aligned), or running into the ragged last tile (end), so
    each exit of the seam fold's gallop and bisect is taken.  The values
    are small integers, so every partial sum is exact in float32 and one
    seam dropped or added twice shows: the op equals the float64 sum."""
    rng = np.random.default_rng(tiles * 7 + len(place) + d)
    lead, tail = {"middle": (77, 50), "aligned": (0, 0), "end": (5, 20)}[place]
    hub = tiles * 128 - lead - tail  # edges of the hub row
    before = np.sort(rng.integers(0, 40, 3 * 128 + lead))  # rows 0..39
    after = np.sort(rng.integers(42, 90, 0 if place == "end" else 300))
    rows_np = np.concatenate([before, np.full(hub, 41), after]).astype(np.int32)
    n = 90
    rows = torch.from_numpy(rows_np).to(cuda)
    vals = torch.from_numpy(rng.integers(-8, 9, (rows_np.shape[0], d)).astype(np.float32)).to(cuda)
    got = seg_ops.edge_segment_sum(rows, vals, num_segments=n)
    exp = torch.zeros((n, d), dtype=torch.float64, device=cuda).index_add_(
        0, rows.long(), vals.double())
    assert torch.equal(got, exp.float())
    assert float(exp[41].abs().max()) < 2.0**24  # every partial sum exact


def test_edge_segment_sum_cuda_is_deterministic(cuda):
    """Two calls on a hub row spanning ~157 tiles and many seams, D = 64:
    the same bits (no atomics; each row summed in edge order)."""
    rng = np.random.default_rng(5)
    rows = torch.from_numpy(_segment_rows(rng, 60_000, 9000, "hub").astype(np.int32)).to(cuda)
    vals = torch.from_numpy(
        rng.standard_normal((rows.shape[0], 64)).astype(np.float32)).to(cuda)
    first = seg_ops.edge_segment_sum(rows, vals, num_segments=9000)
    for _ in range(2):
        assert torch.equal(seg_ops.edge_segment_sum(rows, vals, num_segments=9000), first)


def test_edge_segment_runs_rejects_bad_operands(cuda):
    rows = torch.zeros(256, dtype=torch.int32, device=cuda)
    vals = torch.zeros((256, 8), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        seg_kernel.edge_segment_runs(rows, vals.double(), 4)
    with pytest.raises(ValueError, match="rows"):
        seg_kernel.edge_segment_runs(rows[:100], vals, 4)
    with pytest.raises(ValueError, match="int32"):
        seg_kernel.edge_segment_runs(rows, vals, 2**31)


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


@pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,d,causal,window,q_scale",
    [
        (1, 4, 1, 512, 512, 80, True, 0, 8.0),        # peaked: one key dominates a row
        (1, 2, 1, 256, 4096, 80, False, 0, 1e-3),     # near-uniform over 4,096 keys
        (1, 4, 1, 1000, 1000, 80, True, 0, 1.0),      # ragged: neither tile divides 1000
        (1, 4, 1, 1000, 1000, 80, True, 300, 1.0),    # ragged, with a window
        (1, 4, 1, 1, 777, 80, False, 0, 1.0),         # Sq = 1
        (1, 4, 1, 1, 777, 80, True, 0, 1.0),          # Sq = 1, causal: key 0 only
        (1, 4, 4, 512, 512, 80, True, 200, 1.0),      # group 1
        (1, 8, 2, 512, 512, 80, True, 200, 1.0),      # group 4
        (1, 8, 1, 512, 512, 80, True, 200, 1.0),      # group 8
        (1, 2, 1, 8192, 8192, 80, True, 0, 1.0),      # causal, no window: interior tiles
    ],
    ids=["peaked", "near_uniform", "ragged", "ragged_window", "sq1", "sq1_causal",
         "group1", "group4", "group8", "causal_8192"],
)
def test_flash_attention_tensor_core_cases(cuda, b, hq, hkv, sq, skv, d, causal, window,
                                           q_scale):
    """bf16 at D = 80 runs the wgmma kernel: P split into bf16 hi and lo
    keeps the plain version's f32 p, so the same tolerance holds."""
    q, k, v = _fa_inputs(cuda, torch.bfloat16, b, hq, hkv, sq, skv, d, seed=sq + hq + hkv)
    q = (q.float() * q_scale).bfloat16()
    before = fa_kernel.flash_attention.path_launches["wgmma"]
    got = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    assert fa_kernel.flash_attention.path_launches["wgmma"] == before + 1
    exp = fa_kernel.flash_attention_torch(q, k, v, causal=causal, window=window)
    _fa_close(got, exp, v, torch.bfloat16)


def _fa_cancelling(device, sq=128, skv=512, d=80):
    """Rows whose output nearly cancels.  Row i has q = (1 + i/128) e0; even
    keys have k = 0 and v = +1, odd keys k = -(3/128) e0 and v = -1 (each
    column of either sign), so p is 1 on even keys and x_i in (0.994,
    0.998) on odd ones, and the output is +-(1 - x_i)/(1 + x_i) ~ 2e-3.  One
    bf16 rounding of x_i (up to 2^-9) moves it by up to ~2^-10, four times
    the atol of 2^-12."""
    q = torch.zeros((1, 2, sq, d), device=device)
    q[..., 0] = 1 + torch.arange(sq, device=device) % 128 / 128
    k = torch.zeros((1, 1, skv, d), device=device)
    k[:, :, 1::2, 0] = -3 / 128
    v = torch.where(torch.arange(d, device=device) % 3 == 0, -1.0, 1.0).expand(1, 1, skv, d)
    v = v * torch.where(torch.arange(skv, device=device) % 2 == 0, 1.0, -1.0)[:, None]
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


def test_flash_attention_p_keeps_f32(cuda):
    """A case that one bf16 rounding of p fails: the tensor-core kernel's
    hi/lo split of p keeps the plain version's f32 p."""
    q, k, v = _fa_cancelling(cuda)
    exp = fa_kernel.flash_attention_torch(q, k, v, causal=False, window=0)
    s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    rounded_once = ((p.bfloat16().float() @ v.float()) / p.sum(-1, keepdim=True)).bfloat16()
    with pytest.raises(AssertionError):
        _fa_close(rounded_once, exp, v, torch.bfloat16)
    before = fa_kernel.flash_attention.path_launches["wgmma"]
    got = fa_kernel.flash_attention(q, k, v, causal=False, window=0)
    assert fa_kernel.flash_attention.path_launches["wgmma"] == before + 1
    _fa_close(got, exp, v, torch.bfloat16)


@pytest.mark.parametrize(
    "dtype,d,offset,path",
    [
        (torch.bfloat16, 80, 0, "wgmma"),
        (torch.bfloat16, 40, 0, "wgmma"),    # D = 8 (mod 16): TMA zero-fills to 48
        (torch.bfloat16, 100, 0, "simt"),    # D % 8 != 0: no 16-byte row pitch
        (torch.bfloat16, 80, 1, "simt"),     # q not 16-byte aligned
        (torch.float32, 80, 0, "simt"),
        (torch.float32, 64, 0, "simt"),
    ],
)
def test_flash_attention_dispatch(cuda, dtype, d, offset, path):
    """Type, head dim and alignment pick the kernel; every call counts."""
    q, k, v = _fa_inputs(cuda, dtype, 1, 4, 2, 96, 96, d, seed=d)
    if offset:
        buf = torch.empty(q.numel() + offset, dtype=dtype, device=cuda)
        q = buf[offset:].view(q.shape).copy_(q)
    launches = KERNELS["flash_attention"].launches
    before = dict(fa_kernel.flash_attention.path_launches)
    got = fa_kernel.flash_attention(q, k, v, causal=True, window=0)
    assert KERNELS["flash_attention"].launches == launches + 1
    assert fa_kernel.flash_attention.path_launches == {
        p: n + (p == path) for p, n in before.items()}
    _fa_close(got, fa_kernel.flash_attention_torch(q, k, v, causal=True, window=0), v, dtype)


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


# -- durability on the card (-k durable) -------------------------------------
DURABLE_REPS = ["digraph", "coo", "lazy", "chunked", "vector2d"]
CRASH_POINTS = ("durable.pre_append", "durable.post_append", "durable.post_apply")


@pytest.fixture
def port_faults():
    """The port's fault-point registry, disarmed around the test; a test
    that leaks an armed point fails."""
    from repro_torch.runtime import faultinject

    faultinject.disarm()
    yield faultinject
    leaked = faultinject.armed()
    faultinject.disarm()
    assert not leaked, f"test leaked armed port faultinject points: {leaked}"


def _durable_stream(cuda, tmp_path, name, point, faults, kcrash=2, n_plans=4):
    """A durable ``name`` on the card driven into a crash at ``point`` on
    plan ``kcrash`` (a differential checkpoint after plan 0).  Returns the
    journal and checkpoint directories, the base CSR, the plans and how
    many of them the uncrashed twin applies."""
    from repro_torch.core import REPRESENTATIONS
    from repro_torch.runtime import durable

    c = synthetic.make_graph("social", scale=10, edge_factor=8, seed=13, device=cuda)
    rng = np.random.default_rng(13)
    plans = [updates.plan_update(inserts=edgebatch.random_insertions(rng, c.n, 300),
                                 deletes=edgebatch.random_deletions(rng, c, 300))
             for _ in range(n_plans)]
    wal, ck = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    g = durable.DurableGraph(REPRESENTATIONS[name].from_csr(c, device=cuda), wal, ck,
                             diff=True)
    g.apply(plans[0])
    g.checkpoint()
    for plan in plans[1:kcrash]:
        g.apply(plan)
    with faults.injected(point):
        with pytest.raises(faults.SimulatedCrash):
            g.apply(plans[kcrash])
    g.close()
    return wal, ck, c, plans, kcrash if point == "durable.pre_append" else kcrash + 1


@pytest.mark.parametrize("point", CRASH_POINTS)
@pytest.mark.parametrize("name", DURABLE_REPS)
def test_durable_crash_recovery_on_card(cuda, tmp_path, port_faults, name, point):
    """Recovered on the card, bit for bit against a card twin (every
    state_tree slot: both ran the same device path), the replay through
    the row-merge kernel and the walk within the kernels' envelope."""
    from repro_torch.core import REPRESENTATIONS
    from repro_torch.runtime import durable

    wal, ck, c, plans, upto = _durable_stream(cuda, tmp_path, name, point, port_faults)
    twin = REPRESENTATIONS[name].from_csr(c, device=cuda)
    for plan in plans[:upto]:
        twin, _ = twin.apply(plan)
    st = {}
    r = durable.DurableGraph.recover(wal, ck, stats=st, device=cuda)
    assert st["records"] == upto - 1
    got, exp = r.to_csr(), twin.to_csr()
    assert got.dst.device == exp.dst.device
    for f in ("offsets", "dst", "wgt"):
        assert torch.equal(getattr(got, f), getattr(exp, f)), f
    a, b = r.rep.state_tree(), twin.state_tree()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    torch.testing.assert_close(r.reverse_walk(6, normalize=True),
                               twin.reverse_walk(6, normalize=True), rtol=5e-4, atol=1e-6)


@pytest.mark.parametrize("name", DURABLE_REPS)
def test_durable_card_journal_recovers_on_cpu(cuda, tmp_path, port_faults, name):
    """A journal and checkpoints written on the card recover on the CPU:
    the same edges and weights (to_csr), though dead slots may differ."""
    from repro_torch.core import REPRESENTATIONS
    from repro_torch.runtime import durable

    wal, ck, c, plans, upto = _durable_stream(cuda, tmp_path, name, "durable.post_append",
                                              port_faults)
    twin = REPRESENTATIONS[name].from_csr(c, device=cuda)
    for plan in plans[:upto]:
        twin, _ = twin.apply(plan)
    r = durable.DurableGraph.recover(wal, ck, device="cpu")
    got, exp = r.to_csr(), twin.to_csr()
    assert got.dst.device.type == "cpu"
    for f in ("offsets", "dst", "wgt"):
        assert torch.equal(getattr(got, f), getattr(exp, f).cpu()), f


@pytest.mark.parametrize("kind", ["wgt_flip", "degs"])
def test_durable_audit_catches_corruption_on_card(cuda, port_faults, kind):
    """The audit's device reductions catch a flipped live weight and a
    corrupted image geometry of a CUDA representation."""
    from repro_torch.core import REPRESENTATIONS

    c = synthetic.make_graph("social", scale=10, edge_factor=8, seed=17, device=cuda)
    g = REPRESENTATIONS["coo"].from_csr(c, device=cuda)
    assert port_faults.audit(g)["m"] == c.m
    img = g.to_walk_image()
    row = int(np.nonzero((img.degs > 0) & (img.caps > img.degs))[0][0])
    if kind == "wgt_flip":
        img.wgt[int(img.starts[row])] += 1.0
        msg = "image wgt payload != csr wgt"
    else:
        img.degs[row] += 1
        msg = "degree sum"
    with pytest.raises(port_faults.AuditError, match=msg):
        port_faults.audit(g)


# -- walk serving on the card (-k serve) --------------------------------------
@pytest.mark.parametrize("b,t", [(2, 4099), (16, 8192)])
def test_tile_cumsum_batched_walk_shape(cuda, b, t):
    """The served walk's batched [B·T, 128] tiles, and the batched blocked
    step through the kernel against its plain twin."""
    from repro_torch.kernels.slot_walk import ops as sw_ops

    rng = np.random.default_rng(b * t)
    x = torch.from_numpy(rng.uniform(0, 1e4, (b * t, 128)).astype(np.float32)).to(cuda)
    got, exp = sw_kernel.tile_cumsum(x), sw_kernel.tile_cumsum_torch(x)
    scale = exp.abs().amax(dim=1, keepdim=True)
    assert bool(((got - exp).abs() <= 1e-5 * exp.abs() + 1e-6 * scale).all())
    c = synthetic.make_graph("social", scale=10, edge_factor=8, seed=b, device=cuda)
    img = DiGraph.from_csr(c, device=cuda).to_walk_image()
    v0 = torch.from_numpy(rng.random((b, img.nv)).astype(np.float32)).to(cuda)
    before = KERNELS["tile_cumsum"].launches
    vk = sw_ops.slot_walk_image(img, 4, visits0=v0, normalize=True)
    assert KERNELS["tile_cumsum"].launches == before + 4
    vp = sw_ops.slot_walk_image(img, 4, visits0=v0, normalize=True, backend="torch")
    torch.testing.assert_close(vk, vp, rtol=5e-4, atol=1e-6)


def test_served_batches_on_card_match_oracle(cuda, port_faults):
    """A WalkServer over a DiGraph on the card: the writer's applies launch
    merge_rows_fused, the batched walks tile_cumsum (never its plain
    version), every served walk matches the card-side oracle at its own
    generation, and a slot_walk.cuda fault is served by retry."""
    from repro_torch.kernels.slot_walk import kernel as swk
    from repro_torch.launch import serve as launch_serve
    from repro_torch.runtime import serve as serve_mod

    rep, c = launch_serve.build_rep(kind="social", scale=10, device=cuda)
    plain = {"n": 0}
    inner = swk.tile_cumsum_torch

    def spy(vals):
        plain["n"] += 1
        return inner(vals)

    swk.tile_cumsum_torch = spy
    counts = {k: KERNELS[k].launches for k in ("tile_cumsum", "merge_rows_fused")}
    srv = serve_mod.WalkServer(rep, batch_max=16).start()
    try:
        walks, upds = launch_serve.run_traffic(srv, c.n, requests=120, update_every=10,
                                               update_size=64, seed=13)
        port_faults.arm("slot_walk.cuda", times=2)
        walks += [srv.submit_walk([1, 2, 3], steps=4) for _ in range(8)]
        for t in walks:
            assert t.wait(120.0)
    finally:
        stats = srv.stop(timeout=120.0)
        swk.tile_cumsum_torch = inner
        port_faults.disarm()
    srv.assert_no_lost()
    assert stats["served"] == 128 and stats["failed"] == 0 and stats["dispatch_retries"] >= 1
    assert plain["n"] == 0
    assert KERNELS["tile_cumsum"].launches > counts["tile_cumsum"]
    assert KERNELS["merge_rows_fused"].launches > counts["merge_rows_fused"]
    assert all(t.visits.device.type == "cuda" for t in walks)
    torn, checked = launch_serve.count_torn_reads(
        launch_serve.GenerationOracle(c), walks, upds)
    assert torn == 0 and checked == 128


# -- the sharded graph in local mode on the card (-k sharded) -----------------
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_walk_cuda_matches_plain(cuda, n_shards):
    """The sharded walk through the tile_cumsum kernel (one launch a healthy
    shard a step) against its backend="torch" twin and the DiGraph image
    walk of the same CSR, one walk and a batch of 16."""
    from repro_torch.core import distributed as dist
    from repro_torch.kernels.slot_walk import kernel as swk

    c = synthetic.make_graph("social", scale=12, edge_factor=8, seed=n_shards, device=cuda)
    g = dist.shard_csr(c, n_shards, device=cuda)
    plain = {"n": 0}
    inner = swk.tile_cumsum_torch

    def spy(vals):
        plain["n"] += 1
        return inner(vals)

    before = KERNELS["tile_cumsum"].launches
    swk.tile_cumsum_torch = spy
    try:
        vk = g.reverse_walk(6, backend="cuda")
    finally:
        swk.tile_cumsum_torch = inner
    assert KERNELS["tile_cumsum"].launches == before + 6 * n_shards and plain["n"] == 0
    vp = g.reverse_walk(6, backend="torch")
    vi = DiGraph.from_csr(c, device=cuda).to_walk_image().walk(6)
    scale = float(vp.abs().max())
    torch.testing.assert_close(vk, vp, rtol=5e-4, atol=1e-6 * scale)
    torch.testing.assert_close(vk, vi, rtol=5e-4, atol=1e-6 * scale)
    v0 = torch.from_numpy(np.random.default_rng(n_shards).random((16, c.n), np.float32)).to(cuda)
    bk = g.reverse_walk(4, visits0=v0)
    bp = g.reverse_walk(4, visits0=v0, backend="torch")
    assert bk.shape == (16, c.n) and bk.device.type == "cuda"
    torch.testing.assert_close(bk, bp, rtol=5e-4, atol=1e-6 * float(bp.abs().max()))
    g.quarantine(0)  # a down shard runs no step: its rows read exact zeros
    before = KERNELS["tile_cumsum"].launches
    vd = g.reverse_walk(2)
    assert KERNELS["tile_cumsum"].launches == before + 2 * (n_shards - 1)
    assert bool((vd[g.down_rows()] == 0).all())


def test_sharded_apply_and_parallel_recovery_on_card(cuda, tmp_path, port_faults):
    """Routed applies through merge_rows_fused gather to the DiGraph's CSR
    after the same plans; a crash at durable.post_append recovers on the
    card with the parallel replay, every shard's state_trees() bit for bit
    against a card twin."""
    from repro_torch.core import distributed as dist
    from repro_torch.runtime import durable

    c = synthetic.make_graph("social", scale=11, edge_factor=8, seed=21, device=cuda)
    rng = np.random.default_rng(21)
    plans = [updates.plan_update(inserts=edgebatch.random_insertions(rng, c.n, 200),
                                 deletes=edgebatch.random_deletions(rng, c, 200))
             for _ in range(4)]
    wal, ck = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    dg = durable.DurableGraph(dist.shard_csr(c, 4, device=cuda), wal, ck, diff=True)
    twin = dist.shard_csr(c, 4, device=cuda)
    ref = DiGraph.from_csr(c, device=cuda)
    before = KERNELS["merge_rows_fused"].launches
    dg.apply(plans[0])
    dg.checkpoint()
    dg.apply(plans[1])
    with port_faults.injected("durable.post_append"):
        with pytest.raises(port_faults.SimulatedCrash):
            dg.apply(plans[2])
    dg.close()
    assert KERNELS["merge_rows_fused"].launches > before
    for plan in plans[:3]:
        twin.apply(plan)
        ref.apply(plan)
    got, exp = dist.gather_csr(twin), ref.to_csr()
    for f in ("offsets", "dst", "wgt"):
        assert torch.equal(getattr(got, f), getattr(exp, f)), f
    r = durable.DurableGraph.recover(wal, ck, device=cuda, parallel=True, diff=True)
    assert r.rep.device.type == "cuda" and r.seq == 3
    assert r.rep.generation == twin.generation == 0
    a, b = r.rep.state_trees(), twin.state_trees()
    for s in b:
        for k in b[s]:
            np.testing.assert_array_equal(a[s][k], b[s][k], err_msg=f"shard {s}: {k}")
    assert torch.equal(r.reverse_walk(4), twin.reverse_walk(4))
    r.close()


# ---------------------------------------------------------------------------
# GNN training (the edge segment sum on every aggregate)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [1, 7, 16, 512, 1152])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gnn_segment_sum_cuda_matches_plain(cuda, d, dtype):
    """The wrapped sum on unsorted destinations with sink edges in the
    middle: the kernel after the stable sort against the plain version on
    the card, within 2*gamma(deg)*sum|terms|; the same bits on two calls;
    the backward (a gather) equal to the plain one."""
    rng = np.random.default_rng(d)
    n, e = 3000, 60_000 if d < 512 else 8_000
    dst_np = rng.integers(0, n, e).astype(np.int32)
    dst_np[::13] = n
    dst_np[5:400] = 17  # a hub, unsorted among the rest
    dst = torch.from_numpy(dst_np).to(cuda)
    vals = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32)).to(cuda)
    vals = vals.to(dtype).requires_grad_()
    before = KERNELS["edge_segment_runs"].launches
    out = gnn_common.segment_sum(vals, dst, n)
    assert KERNELS["edge_segment_runs"].launches == before + 1
    assert out.dtype == dtype and out.shape == (n, d)
    again = gnn_common.segment_sum(vals, dst, n)
    assert torch.equal(out, again)
    ref = gnn_common.segment_sum(vals, dst, n, backend="torch")
    assert KERNELS["edge_segment_runs"].launches == before + 2
    absum = gnn_common.segment_sum(vals.detach().abs().float(), dst, n, backend="torch")
    deg = gnn_common.segment_counts(dst, n)[:, None].double()
    gamma = deg * U / (1 - deg * U)
    tol = 2 * gamma * absum.double()
    if dtype == torch.bfloat16:  # each result rounded once to bfloat16
        tol = tol + 2.0**-7 * ref.float().abs().double()
    assert bool(((out.double() - ref.double()).abs() <= tol).all())
    grad = torch.randn((n, d), device=cuda).to(dtype)
    (g_k,) = torch.autograd.grad(out, vals, grad)
    (g_p,) = torch.autograd.grad(ref, vals, grad)
    assert torch.equal(g_k, g_p)
    keep = (dst < n)[:, None]
    assert torch.equal(g_k, torch.where(keep, grad[dst.clamp(max=n - 1).long()], 0).to(dtype))


@pytest.mark.parametrize("arch", ["gcn-cora", "graphcast"])
def test_gnn_step_cuda_matches_cpu(cuda, arch):
    """Three train steps of the SMOKE cell on the card against the same
    steps on the CPU, from the same weights: losses rtol 1e-5, params rtol
    1e-5 / atol 1e-6; one edge_segment_runs launch an aggregate."""
    cells = {dev: gnn_steps.build_cell(arch, "full_graph_sm", reduced=True, device=dev)
             for dev in ("cpu", "cuda")}
    with torch.no_grad():
        tree.tree_map(lambda t, v: t.copy_(v), cells["cuda"].args[0]["params"],
                      cells["cpu"].args[0]["params"])
    layers = cells["cpu"].meta["cfg"].n_layers
    losses = {}
    for dev, cell in cells.items():
        state, batch = cell.args
        before = {k: KERNELS[k].launches for k in ("edge_segment_runs", "degree_offsets")}
        losses[dev] = []
        for _ in range(3):
            state, m = cell.step_fn(state, batch)
            losses[dev].append(float(m["loss"]))
        runs = KERNELS["edge_segment_runs"].launches - before["edge_segment_runs"]
        offs = KERNELS["degree_offsets"].launches - before["degree_offsets"]
        if dev == "cuda":
            assert runs == 3 * layers
            assert offs == (1 if arch == "gcn-cora" else 0)  # GCN's degrees, once
        else:
            assert runs == offs == 0
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    for (k, a), (_, b) in zip(tree.paths(cells["cuda"].args[0]["params"]),
                              tree.paths(cells["cpu"].args[0]["params"])):
        np.testing.assert_allclose(a.detach().cpu().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_from_coo_reads_device_ids_in_place(cuda):
    """Ids already on the card go to the device build without the host:
    the same CSR as from host arrays, one degree_offsets launch."""
    rng = np.random.default_rng(17)
    n = 5000
    src = rng.integers(0, n, 80_000).astype(np.int32)
    dst = rng.integers(0, n, 80_000).astype(np.int32)
    want = csr.from_coo(src, dst, n=n, dedup=False, device=cuda)
    before = KERNELS["degree_offsets"].launches
    got = csr.from_coo(torch.from_numpy(src).to(cuda), torch.from_numpy(dst).to(cuda), n=n,
                       dedup=False, device=cuda)
    assert KERNELS["degree_offsets"].launches == before + 1
    assert torch.equal(got.offsets, want.offsets) and torch.equal(got.dst, want.dst)
    assert got.wgt is None and got.m == want.m


# -- LM and two-tower training on the card (-k train_on_card) ---------------
@pytest.mark.parametrize("hq,hkv", [(64, 4), (56, 8), (64, 8), (96, 8)],
                         ids=["qwen3_g16", "arctic_g7", "qwen2_g8", "mistral_g12"])
def test_flash_attention_large_lm_geometry_on_card(cuda, hq, hkv):
    """The large LMs' heads (D = 128, groups 16 / 7 / 8 / 12) in bfloat16,
    causal, on the tensor-core kernel, against the plain attention."""
    q, k, v = _fa_inputs(cuda, torch.bfloat16, 1, hq, hkv, 1024, 1024, 128, seed=hq + hkv)
    paths = dict(fa_kernel.flash_attention.path_launches)
    got = fa_kernel.flash_attention(q, k, v, causal=True, window=0)
    assert fa_kernel.flash_attention.path_launches["wgmma"] == paths["wgmma"] + 1
    _fa_close(got, fa_kernel.flash_attention_torch(q, k, v, causal=True, window=0), v,
              torch.bfloat16)


#: launches of each large-LM prefill geometry in the repeat test
PREFILL_REPEATS = 24


@pytest.mark.parametrize("hq,hkv", [(64, 4), (56, 8), (64, 8), (96, 8)],
                         ids=["qwen3_g16", "arctic_g7", "qwen2_g8", "mistral_g12"])
def test_flash_attention_large_prefills_repeated(cuda, hq, hkv):
    """The four cost1 prefills' attention (``chip_smoke.LARGE_PREFILLS``:
    batch 1, D = 128, groups 16 / 7 / 8 / 12, causal, bfloat16) at 4,096 of
    their 32,768 tokens, launched PREFILL_REPEATS times on the wgmma kernel
    with a synchronise after each: every launch completes and gives the
    first one's output bit for bit (the kernel is deterministic), which
    holds against the plain attention.  A launch that faults (an illegal
    instruction, a bad address) fails here at its own launch."""
    q, k, v = _fa_inputs(cuda, torch.bfloat16, 1, hq, hkv, 4096, 4096, 128, seed=hq * hkv)
    paths = dict(fa_kernel.flash_attention.path_launches)
    first = fa_kernel.flash_attention(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    for i in range(PREFILL_REPEATS - 1):
        got = fa_kernel.flash_attention(q, k, v, causal=True, window=0)
        torch.cuda.synchronize()
        assert torch.equal(got, first), f"launch {i + 2} differs from the first"
    assert fa_kernel.flash_attention.path_launches["wgmma"] == paths["wgmma"] + PREFILL_REPEATS
    _fa_close(first, fa_kernel.flash_attention_torch(q, k, v, causal=True, window=0), v,
              torch.bfloat16)


def test_bag_train_on_card_kernel_forward_plain_backward(cuda):
    """The op under autograd on the card: the forward launches the kernel,
    the table grad (plain index_add_) equals the CPU's within the sums'
    reordering (atomic adds: 2*K*2^-24 of each row's sum of |terms|)."""
    rng = np.random.default_rng(3)
    v, d, b, k = 500, 64, 300, 16
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(-1, v // 4, (b, k)).astype(np.int32)  # repeated rows
    cot = rng.standard_normal((b, d)).astype(np.float32)
    grads = {}
    for dev in ("cpu", "cuda"):
        t = torch.tensor(table, device=dev, requires_grad=True)
        before = KERNELS["embedding_bag"].launches
        out = bag_ops.embedding_bag(t, torch.from_numpy(idx).to(dev), combine="mean")
        assert KERNELS["embedding_bag"].launches == before + (dev == "cuda")
        (grads[dev],) = torch.autograd.grad((out * torch.from_numpy(cot).to(dev)).sum(), t)
    absum = np.zeros((v, d))
    valid = idx >= 0
    cnt = np.maximum(valid.sum(1, keepdims=True), 1)
    np.add.at(absum, np.clip(idx, 0, v - 1)[valid],
              np.abs(np.repeat(cot / cnt, k, axis=0).reshape(b, k, d)[valid]))
    err = np.abs(grads["cuda"].cpu().numpy() - grads["cpu"].numpy())
    assert (err <= 2 * b * k * U * absum + 1e-30).all()


def test_moe_ffn_on_card_matches_cpu(cuda):
    """moe_ffn (float32 compute) on the card against the CPU: the dispatch
    state bit for bit, the output within 1e-5 of max|out|, aux rtol 1e-5."""
    from repro_torch.models.transformer import moe

    rng = np.random.default_rng(4)
    t, d, e, kk, f = 512, 64, 16, 4, 48
    x = rng.standard_normal((t, d)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) / 4
          for s in ((d, e), (e, d, f), (e, d, f), (e, f, d))]
    cap = 64  # against a mean load of 128: drops
    out = {}
    for dev in ("cpu", "cuda"):
        args = [torch.from_numpy(a).to(dev) for a in [x, *ws]]
        out[dev] = (moe.dispatch(args[0], args[1], top_k=kk, capacity=cap),
                    *moe.moe_ffn(*args, top_k=kk, capacity=cap, compute_dtype=torch.float32))
    for key in ("slot", "keep", "idx_buf", "flat_expert"):
        assert torch.equal(getattr(out["cuda"][0], key).cpu(), getattr(out["cpu"][0], key)), key
    assert int(out["cpu"][0].dropped) > 0
    scale = float(out["cpu"][1].abs().max())
    torch.testing.assert_close(out["cuda"][1].cpu(), out["cpu"][1], rtol=1e-5, atol=1e-5 * scale)
    torch.testing.assert_close(out["cuda"][2].cpu(), out["cpu"][2], rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "two-tower-retrieval"])
def test_train_on_card_matches_cpu(cuda, arch):
    """Two train steps of the SMOKE cell on the card against the same steps
    on the CPU, from the same weights: losses rtol 1e-5, params rtol 1e-5,
    atol 1e-6; two bag launches a two-tower step, none for the LM (its
    SMOKE attention is the dense reference)."""
    shape = "train_batch" if arch == "two-tower-retrieval" else "train_4k"
    cells = {dev: gnn_steps.build_cell(arch, shape, reduced=True, device=dev)
             for dev in ("cpu", "cuda")}
    with torch.no_grad():
        tree.tree_map(lambda t, v: t.copy_(v), cells["cuda"].args[0]["params"],
                      cells["cpu"].args[0]["params"])
    losses = {}
    for dev, cell in cells.items():
        state, batch = cell.args
        before = KERNELS["embedding_bag"].launches
        losses[dev] = []
        for _ in range(2):
            state, m = cell.step_fn(state, batch)
            losses[dev].append(float(m["loss"]))
        bags = KERNELS["embedding_bag"].launches - before
        assert bags == (4 if dev == "cuda" and arch == "two-tower-retrieval" else 0)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    for (k, a), (_, b) in zip(tree.paths(cells["cuda"].args[0]["params"]),
                              tree.paths(cells["cpu"].args[0]["params"])):
        np.testing.assert_allclose(a.detach().float().cpu().numpy(), b.detach().float().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
