"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels build at first
use) and skip without one.  They import only torch, numpy and
``repro_torch``, so they run where JAX is not installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import DiGraph, edgebatch, updates
from repro_torch.io import synthetic
from repro_torch.kernels import KERNELS
from repro_torch.kernels.csr_build import kernel as cb_kernel
from repro_torch.kernels.slot_update import kernel as su_kernel
from repro_torch.kernels.slot_update.ref import merge_rows_reference
from repro_torch.kernels.slot_walk import kernel as sw_kernel

pytestmark = pytest.mark.gpu
SENT = np.iinfo(np.int32).max


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
