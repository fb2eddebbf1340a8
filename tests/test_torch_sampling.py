"""The port's neighbour sampler against ``repro``'s (``repro_torch.sampling``).

``repro`` draws its uniforms with ``jax.random``; the port's ``pick`` and
``sample_subgraph`` take the same uniforms (``jax.random.uniform`` for
``repro``'s keys, split as ``repro`` splits them), so the sampled ids, the
masks and the minibatch_lg cells' subgraphs must match bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.launch import steps as j_steps
from repro.sampling import neighbor as j_neighbor
from repro_torch.launch import steps
from repro_torch.sampling import neighbor

j_base.all_archs()  # the whole registry, before any single config module loads


def _csr(rng, n, e, empty_rows=()):
    """offsets [n + 1] int32 (some rows empty) and dst [e] int32."""
    src = rng.integers(0, n, e)
    src = src[~np.isin(src, empty_rows)]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=offsets[1:])
    dst = rng.integers(0, n, offsets[-1]).astype(np.int32)
    return offsets.astype(np.int32), dst


def _hop_draws(key, sizes, fanouts):
    """The uniforms repro's sample_subgraph draws: one split a hop."""
    draws = []
    for s, f in zip(sizes, fanouts):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.uniform(sub, (s, f))))
    return draws


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("fanout", [1, 4, 15])
def test_sample_hop_bit_for_bit(fanout):
    rng = np.random.default_rng(fanout)
    n = 200
    offsets, dst = _csr(rng, n, 3000, empty_rows=(3, 7, 11))
    seeds = np.concatenate([[3, 7, 0, n - 1], rng.integers(0, n, 60)]).astype(np.int32)
    seed_mask = rng.random(seeds.shape[0]) < 0.8
    key = jax.random.PRNGKey(fanout)
    want = j_neighbor.sample_hop(key, jax.numpy.asarray(offsets), jax.numpy.asarray(dst),
                                 jax.numpy.asarray(seeds), jax.numpy.asarray(seed_mask), fanout)
    r = np.asarray(jax.random.uniform(key, (seeds.shape[0], fanout)))
    got = neighbor.pick(_t(offsets), _t(dst), _t(seeds), _t(seed_mask), _t(r))
    for a, b in zip(got, want):
        assert a.dtype == (torch.int32 if b.dtype == np.int32 else torch.bool)
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert not got[1][:2].any()  # the empty rows' seeds pick nothing


def test_sample_hop_draws_from_a_generator():
    rng = np.random.default_rng(0)
    offsets, dst = _csr(rng, 50, 400)
    seeds = _t(rng.integers(0, 50, 30).astype(np.int32))
    mask = torch.ones(30, dtype=torch.bool)
    a = neighbor.sample_hop(torch.Generator().manual_seed(3), _t(offsets), _t(dst), seeds, mask, 5)
    b = neighbor.sample_hop(torch.Generator().manual_seed(3), _t(offsets), _t(dst), seeds, mask, 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    o = _t(offsets).long()
    rows = [set(dst[o[s]:o[s + 1]].tolist()) for s in seeds.tolist()]
    assert all(int(v) in rows[i] for i in range(30) for v in a[0][i])


@pytest.mark.parametrize("fanouts", [(3, 2), (15, 10), (2, 2, 2)])
def test_sample_subgraph_bit_for_bit(fanouts):
    rng = np.random.default_rng(len(fanouts))
    n = 300
    offsets, dst = _csr(rng, n, 4000, empty_rows=(5,))
    seeds = np.concatenate([[5], rng.integers(0, n, 15)]).astype(np.int32)
    key = jax.random.PRNGKey(7)
    jb, jl, jm = j_neighbor.sample_subgraph(key, jax.numpy.asarray(offsets),
                                            jax.numpy.asarray(dst),
                                            jax.numpy.asarray(seeds), fanouts)
    sizes = neighbor.flat_sizes(seeds.shape[0], fanouts)
    draws = [_t(d) for d in _hop_draws(key, sizes[:-1], fanouts)]
    tb, tl, tm = neighbor.sample_subgraph(None, _t(offsets), _t(dst), _t(seeds), fanouts,
                                          draws=draws)
    assert len(tb) == len(jb) == len(fanouts)
    for a, b in zip(tb, jb):
        for f in ("src_nodes", "edge_src", "edge_dst", "mask"):
            assert np.array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f))), f
            assert getattr(a, f).numpy().dtype == np.asarray(getattr(b, f)).dtype, f
    for a, b in zip(tl + tm, list(jl) + list(jm)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def _repro_subgraph(cell):
    """repro's own ``build_subgraph`` (a closure of its sampled cell's step)."""
    step = cell.step_fn
    free = dict(zip(step.__code__.co_freevars, (c.cell_contents for c in step.__closure__)))
    return free["build_subgraph"]


@pytest.mark.parametrize("arch", ["gcn-cora", "schnet", "graphcast", "mace"])
def test_sampled_cell_subgraph_bit_for_bit(arch):
    jcell = j_steps.build_cell(arch, "minibatch_lg", reduced=True)
    _, jbatch = jcell.args
    want = _repro_subgraph(jcell)(
        jbatch["offsets"], jbatch["dst"], jbatch["seeds"], jbatch["key"],
        jbatch["node_feat"], jbatch.get("positions"), jbatch["labels"])
    cell = steps.build_cell(arch, "minibatch_lg", reduced=True, device="cpu")
    _, batch = cell.args
    for k in ("offsets", "dst", "seeds", "node_feat", "labels", "positions"):
        if k in jbatch:  # repro's reduced arrays, the same draws
            assert np.array_equal(batch[k].numpy(), np.asarray(jbatch[k])), k
    sizes = neighbor.flat_sizes(4, (3, 2))  # the reduced cell's seeds and fanouts
    draws = [_t(d) for d in _hop_draws(jbatch["key"], sizes[:-1], (3, 2))]
    got = cell.meta["graph"]({**batch, "draws": draws})
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, int):
            assert got[k] == v
            continue
        a, b = got[k].numpy(), np.asarray(v)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    # a masked edge carries the sink n_sub at both ends
    n_sub = cell.meta["n_sub"]
    assert np.array_equal(got["edge_dst"].numpy() == n_sub, got["edge_src"].numpy() == n_sub)


def test_flat_sizes():
    assert neighbor.flat_sizes(1024, (15, 10)) == j_neighbor.flat_sizes(1024, (15, 10)) \
        == [1024, 15360, 153600]
    assert sum(neighbor.flat_sizes(1024, (15, 10))) == 169_984
    assert neighbor.flat_sizes(4, ()) == [4]
