"""bsr_spmm parity: the port's BSR conversion, SpMM and walk against ``repro``'s.

``csr_to_bsr`` must give bit-identical BSR parts; ``spmm`` (the plain
version of the port's ``bsr_spmm`` CUDA kernel, on CPU tensors) and the
SpMM walk must agree with ``repro``'s Pallas kernel in interpret mode, its
per-row-block oracle and the dense numpy oracle.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import csr as j_csr
from repro.kernels.bsr_spmm import ops as j_bsr
from repro_torch.core import csr, traversal
from repro_torch.io import synthetic
from repro_torch.kernels.bsr_spmm import ops as bsr_ops
from repro_torch.kernels.bsr_spmm.ref import bsr_to_dense

#: the shapes of repro's own BSR tests (tests/test_kernels.py)
SHAPES = [(100, 600, 32, 16), (300, 2000, 128, 64), (64, 300, 8, 8), (200, 1500, 64, 130)]


def _graphs(n, m, seed, weighted=False):
    """The same deduplicated CSR in both packages."""
    rng = np.random.default_rng(seed)
    src, dst = synthetic.uniform_edges(rng, n, m)
    w = rng.uniform(0.1, 2.0, src.shape[0]).astype(np.float32) if weighted else None
    return (csr.from_coo(src, dst, w, n=n, device="cpu"),
            j_csr.from_coo(src, dst, w, n=n), rng)


def _assert_same_bsr(got, exp):
    for f in ("row_ptr", "block_cols", "blocks"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(exp, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("n_rows", "n_cols", "max_blocks_per_row", "block_size"):
        assert getattr(got, f) == getattr(exp, f), f


@pytest.mark.parametrize("n,m,b,d", SHAPES)
def test_csr_to_bsr_bit_identical(n, m, b, d):
    c, jc, _ = _graphs(n, m, n)
    bsr = bsr_ops.csr_to_bsr(c, block_size=b)
    _assert_same_bsr(bsr, j_bsr.csr_to_bsr(jc, block_size=b))
    dense = bsr_to_dense(bsr.row_ptr, bsr.block_cols, bsr.blocks, bsr.n_rows, bsr.n_cols)
    np.testing.assert_array_equal(dense[:n, :n], (c.to_dense() != 0).astype(np.float32))


def test_csr_to_bsr_weighted_bit_identical():
    c, jc, _ = _graphs(90, 400, 7, weighted=True)
    bsr = bsr_ops.csr_to_bsr(c, block_size=32, weighted=True)
    _assert_same_bsr(bsr, j_bsr.csr_to_bsr(jc, block_size=32, weighted=True))


@pytest.mark.parametrize("n,m,b,d", SHAPES)
def test_spmm_matches_repro(n, m, b, d):
    c, jc, rng = _graphs(n, m, n)
    bsr = bsr_ops.csr_to_bsr(c, block_size=b)
    x = rng.standard_normal((n, d)).astype(np.float32)
    exp = np.asarray(j_bsr.spmm(j_bsr.csr_to_bsr(jc, block_size=b), jnp.asarray(x),
                                interpret=True))
    got = bsr_ops.spmm(bsr, torch.from_numpy(x))
    assert tuple(got.shape) == (n, d)
    # sums of signed terms in another order: rtol 1e-5, and an atol of
    # 1e-5 x the largest |y| for entries that cancel to near 0
    atol = 1e-5 * np.abs(exp).max()
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(bsr_ops.spmm_reference(bsr, torch.from_numpy(x)).numpy(),
                               exp, rtol=1e-5, atol=atol)
    dense = (c.to_dense() != 0).astype(np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-5, atol=atol)


def test_spmm_weighted_matches_repro():
    c, jc, rng = _graphs(90, 400, 7, weighted=True)
    x = rng.standard_normal((90, 8)).astype(np.float32)
    exp = np.asarray(j_bsr.spmm(j_bsr.csr_to_bsr(jc, block_size=32, weighted=True),
                                jnp.asarray(x), interpret=True))
    got = bsr_ops.spmm(bsr_ops.csr_to_bsr(c, block_size=32, weighted=True),
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5 * np.abs(exp).max())


@pytest.mark.parametrize("kind,b", [("uniform", 64), ("uniform", 128), ("road", 128)])
def test_reverse_walk_bsr_matches_repro(kind, b):
    if kind == "road":  # the chip run's graph family, at 2^9 vertices
        src, dst, _, n = synthetic.make_coo("road", scale=9, seed=11, weighted=False)
        c, jc = csr.from_coo(src, dst, n=n, device="cpu"), j_csr.from_coo(src, dst, n=n)
    else:
        c, jc, _ = _graphs(200, 1500, 11)
    n = c.n
    jbsr = j_bsr.csr_to_bsr(jc, block_size=b)
    bsr = bsr_ops.csr_to_bsr(c, block_size=b)
    _assert_same_bsr(bsr, jbsr)
    exp = np.asarray(j_bsr.reverse_walk_bsr(jbsr, 5, n, interpret=True))
    got = bsr_ops.reverse_walk_bsr(bsr, 5, n)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5)
    oracle = traversal.reverse_walk_dense_oracle(c.to_dense(), 5)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5)
    np.testing.assert_allclose(
        bsr_ops.reverse_walk_bsr(bsr, 5, n, backend="torch").numpy(), oracle, rtol=1e-5)
