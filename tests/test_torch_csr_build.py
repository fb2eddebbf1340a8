"""csr_build parity: the port's ingest engines against ``repro``'s.

Same numpy inputs through both packages: degree counts, CSR offsets /
dst / wgt and arena images must be bit-identical.  ``repro``'s Pallas
degree kernel runs in interpret mode; the port's ``count_degrees`` CUDA
kernel is represented here by its plain version (CPU tensors), which the
card-side tests hold the kernel against.
"""
import numpy as np
import pytest
import torch

from repro.core import alloc as j_alloc
from repro.core import csr as j_csr
from repro.core import edgebatch as j_eb
from repro.io import synthetic as j_syn
from repro.kernels.csr_build import ops as j_ops
from repro.kernels.csr_build import ref as j_ref
from repro_torch.core import alloc, csr, edgebatch
from repro_torch.io import synthetic
from repro_torch.kernels.csr_build import kernel as cb_kernel
from repro_torch.kernels.csr_build import ops as cb_ops
from repro_torch.kernels.csr_build import ref as cb_ref


def _eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_array_equal(a, b)


def _random_coo(seed, n=64, m=400):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, n, m),
        rng.integers(0, n, m),
        rng.uniform(0.5, 1.5, m).astype(np.float32),
        n,
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_count_degrees_engines_agree(seed):
    src, _, _, n = _random_coo(seed)
    src = np.concatenate([src, [-2, n, n + 5]])  # out of range: dropped
    exp = j_ref.count_degrees_reference(src, n)
    _eq(np.asarray(j_ops.count_degrees(src, n, engine="pallas", interpret=True)), exp)
    _eq(cb_ref.count_degrees_reference(src, n), exp)
    _eq(cb_ops.count_degrees(src, n, engine="host"), exp)
    s = torch.from_numpy(src.astype(np.int32))
    _eq(cb_ops.count_degrees(s, n, engine="torch"), exp.astype(np.int32))
    _eq(cb_kernel.count_degrees(s, n), exp.astype(np.int32))


DEGREE_OFFSET_CASES = {
    "empty": (np.zeros(0, np.int64), 5),
    "n0_empty": (np.zeros(0, np.int64), 0),
    "n1": (np.zeros(7, np.int64), 1),
    "leading_and_trailing_gaps": (np.repeat([3, 4, 9], [2, 5, 1]), 40),
    "one_vertex_holds_every_edge": (np.full(300, 17), 64),
    "random": (np.random.default_rng(5).integers(0, 100, 1003), 100),
}


@pytest.mark.parametrize("case", sorted(DEGREE_OFFSET_CASES))
def test_degree_offsets_match_repro(case):
    """The device build's offsets (plain version on the CPU) equal
    ``repro``'s host offsets, and their differences its degree histogram."""
    src, n = DEGREE_OFFSET_CASES[case]
    src = np.sort(src)
    dst = np.zeros_like(src)
    j = j_csr.from_coo(src, dst, n=n, dedup=False)
    got = cb_ops.degree_offsets(torch.from_numpy(src.astype(np.int32)), n, engine="torch")
    assert got.dtype == torch.int32 and got.shape == (n + 1,)
    _eq(got, j.offsets)
    _eq(torch.diff(got), j_ref.count_degrees_reference(src, n).astype(np.int32))
    c = csr.from_coo(src, dst, n=n, dedup=False, engine="torch", presorted=True, device="cpu")
    _eq(c.offsets, j.offsets)


def test_degree_offsets_of_out_of_range_sources_fail_the_range_check():
    s = torch.tensor([-2, 0, 1, 1, 4, 9], dtype=torch.int32)
    o = cb_ops.degree_offsets(s, 4, engine="torch")
    assert int(o[0]) == 1 and int(o[4]) == 4  # off 0 and off M = 6
    for src in ([-1, 0, 2], [0, 2, 4]):
        with pytest.raises(ValueError, match="out of range"):
            csr.from_coo(src, [0, 1, 2], n=4, dedup=False, engine="torch", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        cb_ops.degree_offsets(s, 4, engine="host")


@pytest.mark.parametrize("seed", [3, 4])
def test_from_coo_engine_parity(seed):
    src, dst, wgt, n = _random_coo(seed)
    o_ref, d_ref, w_ref = j_ref.coo_to_csr_reference(src, dst, wgt, n=n)
    jx = j_csr.from_coo(src, dst, wgt, n=n, dedup=False, engine="xla")
    for engine in ("host", "torch"):
        c = csr.from_coo(src, dst, wgt, n=n, dedup=False, engine=engine, device="cpu")
        assert c.offsets.dtype == torch.int32 and c.dst.dtype == torch.int32
        # the same edges in CSR order skip the sort and give the same CSR
        p = csr.from_coo(np.repeat(np.arange(n), np.diff(o_ref)), d_ref, w_ref, n=n,
                         dedup=False, engine=engine, presorted=True, device="cpu")
        for f in ("offsets", "dst", "wgt"):
            _eq(getattr(p, f), getattr(c, f))
        _eq(c.offsets, o_ref)
        _eq(c.dst, d_ref)
        _eq(c.wgt, w_ref)
        _eq(c.offsets, jx.offsets)
        _eq(c.dst, jx.dst)
        _eq(c.wgt, jx.wgt)


@pytest.mark.parametrize("dedup", [True, False])
def test_from_coo_host_matches_repro(dedup):
    src, dst, wgt, n = _random_coo(9)
    a = csr.from_coo(src, dst, wgt, n=n, dedup=dedup, device="cpu")
    j = j_csr.from_coo(src, dst, wgt, n=n, dedup=dedup)
    assert (a.n, a.m) == (j.n, j.m)
    _eq(a.offsets, j.offsets)
    _eq(a.dst, j.dst)
    _eq(a.wgt, j.wgt)
    # feed the sorted edges back through: the presorted shortcut
    b = csr.from_coo(
        np.repeat(np.arange(n), np.diff(a.offsets.numpy())),
        a.dst.numpy(), a.wgt.numpy(), n=n, dedup=False, device="cpu",
    )
    _eq(a.offsets, b.offsets)
    _eq(a.dst, b.dst)
    _eq(a.wgt, b.wgt)
    if dedup:
        csr.validate(a)


@pytest.mark.parametrize("engine", ["host", "torch"])
def test_from_coo_rejects_out_of_range_sources(engine):
    with pytest.raises(ValueError, match="out of range"):
        csr.from_coo([0, 7], [1, 0], n=4, dedup=False, engine=engine, device="cpu")


def test_arena_image_engines_and_reference():
    src, dst, wgt, n = _random_coo(11)
    c = csr.from_coo(src, dst, wgt, n=n, device="cpu")
    degrees = np.diff(c.offsets.numpy())
    caps = np.where(degrees > 0, alloc.edge_capacities(degrees), 0)
    _eq(caps, np.where(degrees > 0, j_alloc.edge_capacities(degrees), 0))
    csum = np.cumsum(caps)
    starts = np.where(caps > 0, csum - caps, -1)
    total = int(csum[-1])
    cap_e = alloc.next_pow2(max(total, 2))
    cap_v = n + 7
    args = (c.offsets, c.dst, c.wgt, starts, caps, cap_e, cap_v)
    r_d, r_w, r_r = cb_ref.arena_image_reference(*args)
    j = j_ops.arena_image(c.offsets.numpy(), c.dst.numpy(), c.wgt.numpy(),
                          starts, caps, cap_e, cap_v, total=total, engine="xla")
    for engine in ("host", "torch"):
        got = cb_ops.arena_image(*args, total=total, device="cpu", engine=engine)
        for g_, r_, j_ in zip(got, (r_d, r_w, r_r), j):
            _eq(g_, r_)
            _eq(g_, j_)


@pytest.mark.parametrize("kind", ["web", "social", "road", "uniform"])
def test_synthetic_same_seed_same_graph(kind):
    a = synthetic.make_graph(kind, scale=8, edge_factor=4, seed=5, device="cpu")
    j = j_syn.make_graph(kind, scale=8, edge_factor=4, seed=5)
    assert (a.n, a.m) == (j.n, j.m)
    _eq(a.offsets, j.offsets)
    _eq(a.dst, j.dst)
    _eq(a.wgt, j.wgt)


def test_edgebatch_parity_and_validation():
    rng = np.random.default_rng(3)
    s, d = rng.integers(0, 50, 80), rng.integers(0, 50, 80)
    w = rng.random(80).astype(np.float32)
    a = edgebatch.from_arrays(s, d, w, symmetric=True)
    j = j_eb.from_arrays(s, d, w, symmetric=True)
    assert a.n == j.n and a.capacity == j.capacity
    for x, y in zip((a.src, a.dst, a.wgt), (j.src, j.dst, j.wgt)):
        _eq(x, y)
    with pytest.raises(ValueError, match="negative"):
        edgebatch.from_arrays([0, -1], [1, 2])
    with pytest.raises(ValueError, match="non-finite"):
        edgebatch.from_arrays([0], [1], [np.nan])
    with pytest.raises(TypeError):
        edgebatch.from_arrays(np.array(["a"]), np.array(["b"]))
