"""slot_update parity: the port's row merge and plan layout against ``repro``.

The port's ``merge_rows_torch`` (the plain version the CUDA kernel is held
against on the card) must be bit-identical to ``repro``'s XLA merge, its
Pallas kernel in interpret mode, and the numpy oracle; UpdatePlans built
from the same batches must match array for array.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import DiGraph as JDiGraph
from repro.core import csr as j_csr
from repro.core import edgebatch as j_eb
from repro.core import updates as j_updates
from repro.core import util as j_util
from repro.kernels.slot_update import ops as j_ops
from repro.kernels.slot_update.ref import merge_rows_reference as j_reference
from repro_torch.core import DiGraph, alloc, csr, edgebatch, updates, util
from repro_torch.io import synthetic
from repro_torch.kernels.slot_update import kernel as su_kernel
from repro_torch.kernels.slot_update import ops as su_ops
from repro_torch.kernels.slot_update.ref import merge_rows_reference

SENT = np.iinfo(np.int32).max
#: jitted once per shape: eager op-by-op dispatch compiles every primitive
j_merge = jax.jit(j_ops.merge_rows, static_argnames=("backend", "interpret", "max_holes"))


def _random_merge_case(rng, a=8, w=64, k=8, vmax=500):
    d_rows = np.full((a, w), SENT, np.int32)
    w_rows = np.zeros((a, w), np.float32)
    degs = rng.integers(0, w // 2, a).astype(np.int32)
    for i in range(a):
        vals = np.sort(rng.choice(vmax, degs[i], replace=False)).astype(np.int32)
        d_rows[i, : degs[i]] = vals
        w_rows[i, : degs[i]] = rng.random(degs[i])
    b_d = np.full((a, k), SENT, np.int32)
    b_w = np.zeros((a, k), np.float32)
    b_l = np.zeros((a, k), np.int32)
    for i in range(a):
        kk = int(rng.integers(0, k + 1))
        pool = np.concatenate([d_rows[i, : degs[i]], rng.choice(vmax, 10)])
        vals = np.unique(rng.choice(pool, kk)) if kk else np.empty(0, np.int64)
        b_d[i, : len(vals)] = vals
        b_w[i, : len(vals)] = rng.random(len(vals))
        b_l[i, : len(vals)] = rng.integers(0, 2, len(vals))
    return d_rows, w_rows, degs, b_d, b_w, b_l


def _assert_merge_equal(got, exp, tag):
    for g, e, name in zip(got, exp, ("out_d", "out_w", "counts")):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(e), err_msg=f"{tag}: {name}")


@pytest.mark.parametrize(
    "seed,a,w,k,legs",
    [
        (0, 8, 64, 8, ("xla", "pallas")),
        (1, 8, 64, 8, ("xla", "pallas")),
        (2, 8, 64, 8, ("xla", "pallas")),
        (3, 4, 64, 64, ("xla", "pallas")),   # K > 32: the sort path
        (4, 4, 128, 128, ("xla",)),          # K > 32, wider rows
        (5, 4, 1024, 16, ("xla",)),          # W = 1024: no interpret [W,W]
    ],
)
def test_merge_rows_parity(seed, a, w, k, legs):
    case = _random_merge_case(np.random.default_rng(seed), a, w, k, vmax=max(500, 4 * w))
    exp = j_reference(*case)
    _assert_merge_equal(merge_rows_reference(*case), exp, "port reference")
    args = [torch.from_numpy(x) for x in case]
    _assert_merge_equal(su_kernel.merge_rows_torch(*args), exp, "port plain")
    jargs = tuple(jnp.asarray(x) for x in case)
    for leg in legs:
        kw = {"interpret": True} if leg == "pallas" else {}
        _assert_merge_equal(j_merge(*jargs, backend=leg, **kw), exp, leg)


@pytest.mark.parametrize("seed", [6, 7])
def test_merge_rows_bounded_hole_window(seed):
    """With max_holes = the pow-2 delete-run ceiling, as fused_apply passes."""
    case = _random_merge_case(np.random.default_rng(seed), 8, 64, 8)
    d_k = 1 << int(np.ceil(np.log2(max(int(case[5].sum(axis=1).max()), 1))))
    exp = j_merge(*(jnp.asarray(x) for x in case), backend="xla", max_holes=d_k)
    got = su_kernel.merge_rows_torch(*(torch.from_numpy(x) for x in case), max_holes=d_k)
    _assert_merge_equal(got, [np.asarray(x) for x in exp], "bounded window")
    _assert_merge_equal(got, j_reference(*case), "reference")


def test_update_plan_layout_parity():
    rng_a, rng_b = np.random.default_rng(2), np.random.default_rng(2)
    c = csr.from_coo(*synthetic.uniform_edges(np.random.default_rng(0), 60, 500),
                     n=60, device="cpu")
    jc = j_csr.from_coo(*synthetic.uniform_edges(np.random.default_rng(0), 60, 500), n=60)
    p = updates.plan_update(inserts=edgebatch.random_insertions(rng_a, 70, 90),
                            deletes=edgebatch.random_deletions(rng_a, c, 60))
    q = j_updates.plan_update(inserts=j_eb.random_insertions(rng_b, 70, 90),
                              deletes=j_eb.random_deletions(rng_b, jc, 60))
    for f in ("q_src", "q_dst", "q_wgt", "q_del", "rows", "run_first",
              "run_count", "ins_count"):
        np.testing.assert_array_equal(getattr(p, f), getattr(q, f), err_msg=f)
    assert p.run_width == q.run_width
    degrees = np.bincount(np.repeat(np.arange(60), np.diff(c.offsets.numpy())),
                          minlength=80)
    sel, rows, deg_old, ins = p.active_rows(degrees, 80)
    caps = np.maximum(deg_old + ins, 1) * 2
    starts = np.cumsum(caps) - caps
    grow = np.zeros(rows.shape[0], bool)
    args = (sel, rows, deg_old, grow, starts, caps, starts, caps, 8, 80)
    (pg, pl), (qg, ql) = p.fused_groups(*args), q.fused_groups(*args)
    assert [g[:5] for g in pg] == [g[:5] for g in qg]
    for a, b in zip(pg, qg):
        for x, y in zip(a[5], b[5]):
            np.testing.assert_array_equal(x, y)
    assert [(w, a) for w, _, a in pl] == [(w, a) for w, _, a in ql]


def test_dispatch_policies():
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert su_ops.width_floor(cpu) == j_ops.width_floor("xla") == 8
    assert su_ops.width_floor(gpu) == 32
    assert su_ops.choose_scatter(1 << 10, 4, gpu)
    for cap_e, touched in ((1 << 10, 4), (1 << 22, 4), (1 << 22, 1 << 20)):
        assert su_ops.choose_scatter(cap_e, touched, cpu) == j_ops.choose_scatter(cap_e, touched)
    for cap_e, bump in ((1 << 10, 1), (1 << 12, 3000), (1 << 20, 1 << 20)):
        assert alloc.quantized_prefix(cap_e, bump) == j_ops.quantized_prefix(cap_e, bump)


def test_scatter_write_back_matches_repro(monkeypatch):
    """The GPU write-back (per-group scatters) run on the CPU in both
    packages: identical state after grow-and-move updates."""
    monkeypatch.setattr(su_ops, "choose_scatter", lambda *a: True)
    monkeypatch.setattr(j_ops, "choose_scatter", lambda *a: True)
    rng = np.random.default_rng(8)
    src, dst = synthetic.uniform_edges(rng, 40, 300)
    g = DiGraph.from_csr(csr.from_coo(src, dst, n=40, device="cpu"), device="cpu")
    jg = JDiGraph.from_csr(j_csr.from_coo(src, dst, n=40))
    s = rng.integers(0, 40, 120)
    d = rng.integers(0, 60, 120)
    w = rng.random(120).astype(np.float32)
    ds, dd = rng.integers(0, 40, 50), rng.integers(0, 40, 50)
    relayouts = g.stats.relayouts
    g.apply(updates.plan_update(inserts=edgebatch.from_arrays(s, d, w),
                                deletes=edgebatch.from_arrays(ds, dd)))
    jg.apply(j_updates.plan_update(inserts=j_eb.from_arrays(s, d, w),
                                   deletes=j_eb.from_arrays(ds, dd)))
    assert g.stats.relayouts > relayouts  # rows grew: blocks moved
    a, b = g.state_tree(), jg.state_tree()
    for key in b:
        np.testing.assert_array_equal(a[key], np.asarray(b[key]), err_msg=key)


def test_padded_row_helpers_match_repro():
    rng = np.random.default_rng(10)
    flat = rng.integers(0, 100, 64).astype(np.int32)
    starts = np.array([0, 10, 60, 30], np.int32)
    lengths = np.array([3, 0, 4, 8], np.int32)
    got = util.rows_to_padded(torch.from_numpy(flat), torch.from_numpy(starts),
                              torch.from_numpy(lengths), 8, int(SENT))
    exp = j_util.rows_to_padded(jnp.asarray(flat), jnp.asarray(starts),
                                jnp.asarray(lengths), 8, SENT)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    mask = np.arange(8)[None, :] < lengths[:, None]
    got = util.scatter_padded_rows(torch.from_numpy(flat), got,
                                   torch.from_numpy(starts), torch.from_numpy(mask))
    exp = j_util.scatter_padded_rows(jnp.asarray(flat), exp, jnp.asarray(starts),
                                     jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    offsets = np.array([0, 2, 2, 5, 9], np.int32)
    np.testing.assert_array_equal(
        util.expand_rows(torch.from_numpy(offsets), 9).numpy(),
        np.asarray(j_util.expand_rows(jnp.asarray(offsets), 9)))
