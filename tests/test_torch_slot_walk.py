"""slot_walk parity: the port's walk engine against ``repro``'s.

The port's tile kernels' plain versions (``tile_cumsum``,
``slot_walk_partials``) against ``repro``'s Pallas kernels in interpret
mode, and the blocked interval walk, the interval-less rank-tile walk, the
segment-sum walk and the flat seed walk against ``repro``'s on the same
buffers of a churned graph.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import traversal as j_traversal
from repro.core.walk_image import WalkImage as JWalkImage
from repro.kernels.slot_walk import kernel as j_kernel
from repro.kernels.slot_walk import ops as j_ops
from repro_torch.core import DiGraph, WalkImage, csr, edgebatch, traversal
from repro_torch.io import synthetic
from repro_torch.kernels.slot_walk import kernel as sw_kernel
from repro_torch.kernels.slot_walk import ops as sw_ops
from repro_torch.kernels.slot_walk.ref import slot_walk_host, slot_walk_reference

STEPS = 4


@pytest.fixture(scope="module")
def churned():
    """A DiGraph after deletions and growing inserts (dead slots, moved
    blocks, stale slot_rows), with its interval geometry."""
    rng = np.random.default_rng(3)
    src, dst = synthetic.uniform_edges(rng, 300, 2400)
    c = csr.from_coo(src, dst, n=300, device="cpu")
    g = DiGraph.from_csr(c, device="cpu")
    g.remove_edges(edgebatch.random_deletions(rng, c, c.m // 3))
    g.add_edges(edgebatch.random_insertions(rng, c.n, c.m // 4))
    nv = g.n_max_vertex() + 1
    starts = g.starts[:nv]
    has = starts >= 0
    lo = np.where(has, starts, 0).astype(np.int32)
    hi = np.where(has, starts + g.degrees[:nv], 0).astype(np.int32)
    oracle = traversal.reverse_walk_dense_oracle(g.to_csr().to_dense(), STEPS)[:nv]
    return g, nv, lo, hi, oracle


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_cumsum_matches_pallas_interpret(seed):
    rng = np.random.default_rng(seed)
    vals = (rng.random((6, 128)) * 10.0 ** rng.integers(-2, 6, (6, 1))).astype(np.float32)
    exp = np.asarray(j_kernel.tile_cumsum(jnp.asarray(vals), interpret=True))
    t = torch.from_numpy(vals)
    for got in (sw_kernel.tile_cumsum_torch(t), sw_kernel.tile_cumsum(t)):
        # the MXU matmul and a sequential cumsum add in different orders:
        # rtol 1e-5, atol 1e-6 x the tile's largest |prefix|
        scale = np.abs(exp).max(axis=1, keepdims=True)
        assert (np.abs(_np(got) - exp) <= 1e-5 * np.abs(exp) + 1e-6 * scale).all()


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_blocked_walk_matches_repro(churned, engine):
    g, nv, lo, hi, oracle = churned
    kw = {"interpret": True} if engine == "pallas" else {}
    exp = np.asarray(j_ops.slot_walk(
        jnp.asarray(g.dst.numpy()), jnp.asarray(g.slot_rows.numpy()), STEPS, nv,
        backend=engine, block_lo=jnp.asarray(lo), block_hi=jnp.asarray(hi), **kw,
    ))
    got = sw_ops.slot_walk(g.dst, g.slot_rows, STEPS, nv,
                           block_lo=torch.from_numpy(lo), block_hi=torch.from_numpy(hi))
    np.testing.assert_allclose(_np(got), exp, rtol=1e-4)
    np.testing.assert_allclose(_np(got), oracle, rtol=1e-4)


def test_multi_walk_matches_repro(churned):
    g, nv, lo, hi, _ = churned
    v0 = np.random.default_rng(4).random((3, nv)).astype(np.float32)
    exp = np.asarray(j_ops.slot_walk(
        jnp.asarray(g.dst.numpy()), jnp.asarray(g.slot_rows.numpy()), STEPS, nv,
        backend="xla", block_lo=jnp.asarray(lo), block_hi=jnp.asarray(hi),
        visits0=jnp.asarray(v0), normalize=True,
    ))
    got = g.reverse_walk(STEPS, visits0=torch.from_numpy(v0), normalize=True,
                         auto_compact=False)
    assert tuple(got.shape) == (3, nv)
    np.testing.assert_allclose(_np(got), exp, rtol=1e-4)


SINK = 50


def _tile_case(name):
    """Hand-made [T, 128] rows tiles (sink = SINK) for the partials parity."""
    rng = np.random.default_rng(len(name))
    if name == "all_sink":
        return np.full((2, 128), SINK)
    if name == "distinct_128":
        return np.stack([np.arange(128) % SINK, (np.arange(128) + 7) % (SINK + 1)])
    if name == "one_run":
        return np.full((3, 128), 17)
    if name == "recurring":  # row 4 in two runs of one tile, split by row 9
        return np.repeat([[4, 9, 4, 4, 12, SINK]], 128 // 6 + 1, axis=1)[:, :128]
    if name == "dead_tail":  # live blocks, then a dead tail inside a block
        r = np.concatenate([np.full(40, 3), np.full(30, 8), np.full(20, SINK),
                            np.full(38, 11)])
        return np.stack([r, np.roll(r, 64)])
    lens = rng.integers(1, 30, 40)  # "random": runs across the tile seams
    return np.repeat(rng.integers(0, SINK + 1, 40), lens)[: 4 * 128].reshape(4, 128)


def _assert_partials_match(rows, vals, sink):
    exp_p, exp_r = j_kernel.slot_walk_partials(
        jnp.asarray(rows, jnp.int32), jnp.asarray(vals), sink=sink, interpret=True)
    for fn in (sw_kernel.slot_walk_partials_torch, sw_kernel.slot_walk_partials):
        got_p, got_r = fn(torch.from_numpy(rows.astype(np.int32)), torch.from_numpy(vals), sink)
        np.testing.assert_array_equal(got_r.numpy(), np.asarray(exp_r))
        # the one-hot matmul adds in another order: rtol 1e-6 plus
        # 1e-6 x the tile's largest |value|
        scale = np.abs(vals).max(axis=1, keepdims=True)
        assert (np.abs(got_p.numpy() - np.asarray(exp_p))
                <= 1e-6 * np.abs(np.asarray(exp_p)) + 1e-6 * scale).all()


@pytest.mark.parametrize(
    "case", ["all_sink", "distinct_128", "one_run", "recurring", "dead_tail", "random"])
def test_slot_walk_partials_matches_pallas_interpret(case):
    rows = _tile_case(case)
    vals = (np.random.default_rng(1).random(rows.shape) * 1e3).astype(np.float32)
    _assert_partials_match(rows, vals, SINK)


def test_slot_walk_partials_on_churned_tiles(churned):
    g, nv, *_ = churned
    rows_f, gidx_f = sw_ops._prep(g.dst, g.slot_rows, nv, g.layout.bump)
    visits = np.random.default_rng(2).random(nv + 1).astype(np.float32)
    visits[nv] = 0.0
    vals = visits[gidx_f.numpy()].reshape(-1, 128)
    _assert_partials_match(rows_f.numpy().reshape(-1, 128), vals, nv)


@pytest.mark.parametrize("multi", [False, True])
def test_ranked_walk_matches_repro(churned, multi):
    """The interval-less walk (rank tiles through the plain partials, the
    glue the CUDA kernel runs in) against ``repro``'s Pallas walk in
    interpret mode, its segment-sum walk and the dense oracle."""
    g, nv, _, _, oracle = churned
    d, r = jnp.asarray(g.dst.numpy()), jnp.asarray(g.slot_rows.numpy())
    hi = g.layout.bump
    if multi:
        v0 = np.random.default_rng(6).random((3, nv)).astype(np.float32)
        exps = [j_ops.slot_walk_multi_pallas(d, r, jnp.asarray(v0), STEPS, nv,
                                             edges_hi=hi, interpret=True),
                j_ops.slot_walk_multi_xla(d, r, jnp.asarray(v0), STEPS, nv, edges_hi=hi)]
        got = traversal.reverse_walk_slotted(g.dst, g.slot_rows, STEPS, nv, edges_hi=hi,
                                             visits0=torch.from_numpy(v0))
        assert tuple(got.shape) == (3, nv)
    else:
        exps = [j_ops.slot_walk_pallas(d, r, STEPS, nv, edges_hi=hi, interpret=True),
                j_ops.slot_walk_xla(d, r, STEPS, nv, edges_hi=hi)]
        got = traversal.reverse_walk_slotted(g.dst, g.slot_rows, STEPS, nv, edges_hi=hi)
        np.testing.assert_allclose(_np(got), oracle, rtol=1e-4)
    for exp in exps:
        np.testing.assert_allclose(_np(got), np.asarray(exp), rtol=1e-4)


@pytest.mark.parametrize("multi", [False, True])
def test_segment_sum_walks_match_repro(churned, multi):
    g, nv, _, _, oracle = churned
    d, r = g.dst.numpy(), g.slot_rows.numpy()
    hi = min(1 << int(np.ceil(np.log2(g.layout.bump))), g.cap_e)
    if multi:
        v0 = np.random.default_rng(5).random((2, nv)).astype(np.float32)
        exp = np.asarray(j_ops.slot_walk_multi_xla(
            jnp.asarray(d), jnp.asarray(r), jnp.asarray(v0), STEPS, nv, edges_hi=hi))
        got = sw_ops.slot_walk_multi_segsum(g.dst, g.slot_rows, torch.from_numpy(v0),
                                            STEPS, nv, edges_hi=hi)
        host = slot_walk_host(d, r, STEPS, nv, edges_hi=hi, visits0=v0)
    else:
        exp = np.asarray(j_ops.slot_walk_xla(jnp.asarray(d), jnp.asarray(r), STEPS, nv,
                                             edges_hi=hi))
        got = sw_ops.slot_walk_segsum(g.dst, g.slot_rows, STEPS, nv, edges_hi=hi)
        host = slot_walk_host(d, r, STEPS, nv, edges_hi=hi)
        np.testing.assert_allclose(_np(got), oracle, rtol=1e-4)
        np.testing.assert_allclose(
            _np(slot_walk_reference(g.dst, g.slot_rows, STEPS, nv)), oracle, rtol=1e-4)
    np.testing.assert_allclose(_np(got), exp, rtol=1e-4)
    np.testing.assert_allclose(host, exp, rtol=1e-4)


def test_flat_seed_walk_matches_repro(churned):
    g, nv, _, _, oracle = churned
    d, r = g.dst.numpy(), g.slot_rows.numpy()
    exp = np.asarray(j_traversal.reverse_walk_flat(jnp.asarray(d), jnp.asarray(r), STEPS, nv))
    got = traversal.reverse_walk_flat(g.dst, g.slot_rows, STEPS, nv)
    np.testing.assert_allclose(_np(got), exp, rtol=1e-4)
    np.testing.assert_allclose(_np(got), oracle, rtol=1e-4)


def test_compensated_scan_is_near_exact():
    rng = np.random.default_rng(9)
    x = (rng.random((2, 3000)) * 10.0 ** rng.integers(-3, 9, (2, 3000))).astype(np.float32)
    hi, lo = sw_kernel._comp_scan(torch.from_numpy(x))
    exact = np.cumsum(x.astype(np.float64), axis=1)
    got = hi.numpy().astype(np.float64) + lo.numpy().astype(np.float64)
    np.testing.assert_allclose(got, exact, rtol=1e-9)


@pytest.mark.parametrize("b,t", [(1, 1), (1, 7), (3, 300)])
def test_tile_bases_plain_is_the_shifted_compensated_scan(b, t):
    """The plain tile bases are ``_comp_scan`` of lane EB-1 of each tile,
    shifted to exclusive with a zero column, bit for bit."""
    rng = np.random.default_rng(b * t)
    incl = torch.from_numpy(
        (rng.random((b, t * sw_kernel.EB)) * 10.0 ** rng.integers(-3, 9, (b, 1))).astype(np.float32))
    hi, lo = sw_kernel._comp_scan(incl[:, sw_kernel.EB - 1::sw_kernel.EB])
    zero = torch.zeros((b, 1), dtype=torch.float32)
    bh, bl = sw_kernel.tile_bases(incl)
    assert torch.equal(bh, torch.cat([zero, hi[:, :-1]], dim=1))
    assert torch.equal(bl, torch.cat([zero, lo[:, :-1]], dim=1))
    assert bh.shape == bl.shape == (b, t)


def _gather_case(b, t, n, seed):
    """visits [b, n] (with -0.0, inf and a NaN) and a [t, EB] int32 index
    that holds 0, n-1 and the sink n, the rest uniform over [0, n]."""
    rng = np.random.default_rng(seed)
    visits = rng.random((b, n)).astype(np.float32)
    visits[0, :3] = [-0.0, np.inf, np.nan][:min(3, n)]
    gidx = rng.integers(0, n + 1, (t, sw_kernel.EB)).astype(np.int32)
    gidx.reshape(-1)[:3] = [0, n - 1, n]
    return torch.from_numpy(visits), torch.from_numpy(gidx)


@pytest.mark.parametrize("b,t,n", [(1, 1, 5), (1, 7, 300), (3, 7, 300), (16, 4, 1000)])
def test_slot_gather_plain_is_cat_index_select(b, t, n):
    """The plain gather (and the wrapper on CPU tensors) is the zero column
    appended, then index_select along dim 1, bit for bit, and ``repro``'s
    ``jnp.concatenate([visits, zrow], axis=1)[:, gidx]`` too: sink columns
    read +0.0, every other slot its vertex's bits."""
    visits, gidx = _gather_case(b, t, n, b * t)
    zcol = torch.zeros((b, 1), dtype=torch.float32)
    exp = torch.cat([visits, zcol], dim=1).index_select(1, gidx.reshape(-1))
    for got in (sw_kernel.slot_gather_torch(visits, gidx), sw_kernel.slot_gather(visits, gidx)):
        assert got.shape == (b, t * sw_kernel.EB)
        assert torch.equal(got.view(torch.int32), exp.view(torch.int32))
    sink = gidx.reshape(-1) == n
    assert sink.any() and not got[:, sink].view(torch.int32).any()
    j = np.asarray(jnp.concatenate([jnp.asarray(visits.numpy()), jnp.zeros((b, 1), jnp.float32)],
                                   axis=1)[:, gidx.numpy().reshape(-1)])
    assert np.array_equal(j.view(np.int32), got.numpy().view(np.int32))


@pytest.mark.parametrize("b", [1, 2, 3, 7, 16, 17, 40])
def test_gather_pass_plan_covers_the_rows(b):
    """The pass plan takes every row once: full passes of the largest power
    of two up to 16 that B fills, then powers of two the rest fills."""
    rpp = sw_kernel.gather_rows_per_pass(b)
    assert rpp <= min(b, 16) < 2 * rpp or rpp == 16
    passes = list(sw_kernel._passes(b, rpp))
    assert sum(passes) == b and max(passes) == rpp
    assert all(r & (r - 1) == 0 and r <= rpp for r in passes)
    assert passes == sorted(passes, reverse=True)


def test_blocked_step_torch_backend_is_the_written_out_step(churned):
    """``make_blocked_step(backend="torch")`` is the gather (zero column,
    index_select), the tile cumsum, the plain tile bases and the interval
    differences, bit for bit over four batched steps."""
    g, nv, lo, hi, _ = churned
    gidx = sw_ops._prep_gidx(g.dst, nv, g.dst.shape[0])
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    step = sw_ops.make_blocked_step(gidx, lo_t, hi_t, nv, backend="torch")
    eb, t = sw_kernel.EB, gidx.shape[0]
    q_lo, q_hi = (torch.clamp(x.long() // eb, max=t - 1) for x in (lo_t, hi_t))
    r_lo, r_hi = lo_t.long() - q_lo * eb, hi_t.long() - q_hi * eb
    i_lo, i_hi = (q * eb + (r - 1).clamp(min=0) for q, r in ((q_lo, r_lo), (q_hi, r_hi)))
    v = w = torch.from_numpy(np.random.default_rng(4).random((3, nv)).astype(np.float32))
    for _ in range(4):
        vals = torch.cat([w, torch.zeros((3, 1))], dim=1).index_select(1, gidx.reshape(-1))
        incl = torch.cumsum(vals.reshape(-1, eb), dim=-1).reshape(3, -1)
        bh, bl = sw_kernel.tile_bases_torch(incl)
        ih = torch.where(r_hi == 0, 0.0, incl.index_select(1, i_hi))
        il = torch.where(r_lo == 0, 0.0, incl.index_select(1, i_lo))
        w = (bh.index_select(1, q_hi) - bh.index_select(1, q_lo)) + (
            (ih - il) + (bl.index_select(1, q_hi) - bl.index_select(1, q_lo)))
        v = step(v)
        assert torch.equal(v, w)


def test_blocked_path_no_prefix_cancellation():
    """Large prefix totals must not leak float error into small row sums.

    A naive global f32 cumsum gives P[hi]-P[lo] errors of ~ulp(total); the
    two-level compensated prefix keeps integer-valued counts exact.
    """
    rng = np.random.default_rng(1)
    src, dst = synthetic.uniform_edges(rng, 1024, 10240)
    c = csr.from_coo(src, dst, n=1024, device="cpu")
    g = DiGraph.from_csr(c, device="cpu")
    g.remove_edges(edgebatch.random_deletions(rng, c, int(c.m * 0.85)))
    got = g.reverse_walk(6, auto_compact=False).numpy()
    nv = g.n_max_vertex() + 1
    exp = traversal.reverse_walk_dense_oracle(g.to_csr().to_dense(), 6)[:nv]
    np.testing.assert_allclose(got, exp, rtol=1e-6)


@pytest.mark.parametrize("dense", [None, True])
def test_walk_image_from_csr_arrays_matches_repro(dense):
    c = synthetic.make_graph("web", scale=8, edge_factor=4, seed=6, device="cpu")
    o, d, w = c.offsets.numpy(), c.dst.numpy(), c.wgt.numpy()
    img = WalkImage.from_csr_arrays(o, d, w, c.n, device="cpu", dense=dense)
    jimg = JWalkImage.from_csr_arrays(o, d, w, c.n, engine="host", dense=dense)
    for f in ("dst", "wgt", "rows"):
        np.testing.assert_array_equal(getattr(img, f).numpy(), np.asarray(getattr(jimg, f)))
    for f in ("starts", "caps", "degs", "nv", "bump", "live"):
        np.testing.assert_array_equal(getattr(img, f), getattr(jimg, f))
    assert img.edges_hi() == jimg.edges_hi() and img.occupancy == jimg.occupancy
    exp = traversal.reverse_walk_dense_oracle(c.to_dense(), STEPS)
    got = traversal.reverse_walk_image(img, STEPS).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-4)
