"""The port's GNN family against ``repro``'s: GCN, SchNet, GraphCast and
MACE, their segment sums, the arch registry and the 16 GNN cells.

Inputs are ``repro``'s reduced-cell arrays (``np.random.default_rng(0)``
draws) and weights ``repro``'s ``init_params``, carried into the port by
``from_jax_params``.  ``repro`` runs jitted on the CPU (its GNNs reach no
Pallas kernel); the port on CPU tensors, where every segment sum takes the
plain ``edge_segment_sum`` after its stable sort.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.core import csr as j_csr
from repro.launch import steps as j_steps
from repro.models.gnn import common as j_common
from repro.models.gnn import graphcast as j_graphcast
from repro.models.gnn import mace as j_mace
from repro_torch.configs import base
from repro_torch.core import csr, tree
from repro_torch.kernels import KERNELS
from repro_torch.launch import steps
from repro_torch.models.gnn import common, graphcast, mace, schnet

j_base.all_archs()  # the whole registry, before any single config module loads

ARCHS = {"gcn": "gcn-cora", "schnet": "schnet", "graphcast": "graphcast", "mace": "mace"}
#: forward against repro's: float32 products and sums in other orders;
#: MACE's products of products (correlation order 3) compound them.  The
#: atol is of the output's scale (max|out|, at least 1): XLA's and torch's
#: float32 matmuls add in other orders (at GraphCast's K = 96, 82% of the
#: outputs differ, by up to 2.4e-6 at a scale of 9), so an output near 0
#: keeps the absolute error of its larger neighbours
FWD_TOL = {"gcn": (1e-5, 1e-6), "schnet": (1e-5, 1e-6), "graphcast": (1e-5, 1e-6),
           "mace": (1e-4, 1e-5)}
#: the loss and every gradient
GRAD_TOL = (1e-4, 1e-6)
#: parameters after three AdamW steps (lr 1e-4 warmup: the updates are small)
STEP_TOL = (1e-5, 1e-6)
#: repro's reduced-cell sizes
N, E, N_GRAPHS = 48, 160, 4


def _jax(g):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in g.items()}


def _torch(g):
    return {k: (torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) else v)
            for k, v in g.items()}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_trees_close(got, want, rtol, atol, what):
    gp, wp = dict(tree.paths(got)), dict(tree.paths(want))
    assert sorted(gp) == sorted(wp), what
    for k in wp:
        np.testing.assert_allclose(_np(gp[k]), _np(wp[k]), rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


def _grads(loss, params):
    """d loss / d each parameter leaf, zeros for a leaf the loss does not
    read (MACE's last layer feeds no correlation-3 vector or tensor path
    into the energy)."""
    leaves = tree.leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


@torch.no_grad()
def _load(params, params_np):
    """Copy repro's weights into the port's parameter tensors, in place."""
    tree.tree_map(lambda t, v: t.copy_(torch.from_numpy(np.array(v))), params, params_np)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def case(request):
    """One model's reference results from repro, on its reduced cell's graph
    (and on the same graph with sink edges in the middle)."""
    model = request.param
    entry = j_base.get(ARCHS[model])
    cfg = entry.smoke
    jmod = j_steps.GNN_MODULES[model]
    d_feat = getattr(cfg, "d_in", 16)
    g = {k: np.asarray(v) for k, v in j_steps._gnn_graph_arrays(
        model, cfg, N, E, d_feat, reduced=True, n_graphs=N_GRAPHS).items()}
    if model in ("mace", "schnet"):
        g["n_graphs"] = N_GRAPHS
    sink = dict(g, edge_src=g["edge_src"].copy(), edge_dst=g["edge_dst"].copy())
    sink["edge_dst"][::7] = N
    sink["edge_src"][3::11] = N
    params = jmod.init_params(jax.random.PRNGKey(0), cfg)
    jg, js = _jax(g), _jax(sink)

    @jax.jit
    def ref(p):
        (loss, _), grads = jax.value_and_grad(
            lambda q: jmod.loss_fn(q, jg, cfg), has_aux=True)(p)
        return jmod.forward(p, jg, cfg), jmod.forward(p, js, cfg), loss, grads

    out, out_sink, loss, grads = ref(params)
    cell = j_steps.build_cell(ARCHS[model], "full_graph_sm", reduced=True)
    state, batch = cell.args
    jstep = jax.jit(cell.step_fn)
    losses = []
    for _ in range(3):
        state, m = jstep(state, batch)
        losses.append(float(m["loss"]))
    return dict(model=model, arch=ARCHS[model], g=g, sink=sink,
                params=jax.tree.map(np.asarray, params), out=np.asarray(out),
                out_sink=np.asarray(out_sink), loss=float(loss),
                grads=jax.tree.map(np.asarray, grads), step_losses=losses,
                step_params=jax.tree.map(np.asarray, state["params"]))


def _port_model(case):
    tmod = steps.GNN_MODULES[case["model"]]
    return tmod.from_jax_params(case["params"], base.get(case["arch"]).smoke, device="cpu")


def test_forward_matches_repro(case):
    model = _port_model(case)
    rtol, atol = FWD_TOL[case["model"]]
    with torch.no_grad():
        out = model(_torch(case["g"]))
        out_sink = model(_torch(case["sink"]))
    assert out.shape == case["out"].shape and out.dtype == torch.float32
    for got, want in ((out, case["out"]), (out_sink, case["out_sink"])):
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=atol * scale)


def test_loss_and_grads_match_repro(case):
    model = _port_model(case)
    tmod = steps.GNN_MODULES[case["model"]]
    params = model.tree()
    loss, _ = tmod.loss_fn(params, _torch(case["g"]), model.cfg)
    grads = _grads(loss, params)
    np.testing.assert_allclose(float(loss), case["loss"], rtol=GRAD_TOL[0])
    got = dict(zip([k for k, _ in tree.paths(params)], grads))
    for k, want in tree.paths(case["grads"]):
        np.testing.assert_allclose(_np(got[k]), want, rtol=GRAD_TOL[0], atol=GRAD_TOL[1],
                                   err_msg=k)


def test_train_steps_match_repro(case):
    cell = steps.build_cell(case["arch"], "full_graph_sm", reduced=True, device="cpu")
    state, batch = cell.args
    _load(state["params"], case["params"])
    losses = []
    for _ in range(3):
        state, m = cell.step_fn(state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, case["step_losses"], rtol=STEP_TOL[0])
    _assert_trees_close(state["params"], case["step_params"], *STEP_TOL, "params after 3 steps")
    assert int(state["opt_state"]["step"]) == 3


@pytest.mark.parametrize("shape", list(base.GNN_SHAPES))
def test_gnn_cell_one_step(case, shape):
    """The port's reduced cell: one step, finite metrics, the params
    changed (as tests/test_smoke_archs.py holds repro's); for the full and
    batched kinds the loss is repro's (the same arrays and weights)."""
    cell = steps.build_cell(case["arch"], shape, reduced=True, device="cpu")
    state, batch = cell.args
    _load(state["params"], case["params"])
    before = [p.detach().clone() for p in tree.leaves(state["params"])]
    state, m = cell.step_fn(state, batch)
    assert all(bool(torch.isfinite(v).all()) for v in m.values())
    assert all(bool(torch.isfinite(p).all()) for p in tree.leaves(state["params"]))
    assert any(not torch.equal(a, b) for a, b in zip(before, tree.leaves(state["params"])))
    if base.GNN_SHAPES[shape]["kind"] in ("full", "batched"):
        np.testing.assert_allclose(float(m["loss"]), case["step_losses"][0], rtol=1e-5)
    else:
        g = cell.meta["graph"](batch)
        assert g["edge_src"].shape == g["edge_dst"].shape == (cell.meta["n_sub"] - 4,)
        out = cell.forward(state["params"], batch)
        assert bool(torch.isfinite(out).all())


def test_edge_order_is_sorted_once_per_graph():
    """A full-graph cell sorts each id tensor once over its steps; the
    sampled cell once a step (a new subgraph)."""
    cell = steps.build_cell("graphcast", "ogb_products", reduced=True, device="cpu")
    state, batch = cell.args
    state, _ = cell.step_fn(state, batch)
    before = common.edge_order.sorts
    for _ in range(2):
        state, _ = cell.step_fn(state, batch)
    assert common.edge_order.sorts == before
    cell = steps.build_cell("graphcast", "minibatch_lg", reduced=True, device="cpu")
    state, batch = cell.args
    before = common.edge_order.sorts
    for _ in range(2):
        state, _ = cell.step_fn(state, batch)
    assert common.edge_order.sorts == before + 2


# ---------------------------------------------------------------------------
# the segment sums
# ---------------------------------------------------------------------------
def _unsorted_edges(rng, n, e):
    """Unsorted destinations, with sink (and beyond-sink) edges in the middle."""
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[5::9] = n
    dst[7::23] = n + 3
    return dst


@pytest.mark.parametrize("extra", [(), (5,), (4, 3), (4, 3, 3)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_aggregate_matches_repro(extra, mode):
    rng = np.random.default_rng(len(extra) + 10 * (mode == "mean"))
    n, e = 37, 700
    dst = _unsorted_edges(rng, n, e)
    msg = rng.standard_normal((e,) + extra).astype(np.float32)
    want = np.asarray(j_common.aggregate(jnp.asarray(msg), jnp.asarray(dst), n, mode=mode))
    got = common.aggregate(torch.from_numpy(msg), torch.from_numpy(dst), n, mode=mode)
    assert got.shape == (n,) + extra
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-6)


def test_segment_mean_and_counts_match_repro():
    rng = np.random.default_rng(3)
    n, e = 50, 900
    seg = _unsorted_edges(rng, n, e)
    vals = rng.standard_normal((e, 6)).astype(np.float32)
    want = np.asarray(j_common.segment_mean(jnp.asarray(vals), jnp.asarray(seg), n))
    got = common.segment_mean(torch.from_numpy(vals), torch.from_numpy(seg), n)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-6)
    counts = common.segment_counts(torch.from_numpy(seg), n)
    assert np.array_equal(_np(counts), np.bincount(seg[seg < n], minlength=n).astype(np.float32))


def test_segment_sum_sorts_once_and_reuses_the_order():
    rng = np.random.default_rng(4)
    n, e = 30, 400
    dst = torch.from_numpy(_unsorted_edges(rng, n, e))
    vals = torch.from_numpy(rng.standard_normal((e, 8)).astype(np.float32)).requires_grad_()
    before = common.edge_order.sorts
    out = common.aggregate(vals, dst, n) + common.aggregate(vals * 2, dst, n)
    common.segment_counts(dst, n)
    out.sum().backward()
    assert common.edge_order.sorts == before + 1
    order = common.edge_order(dst, n)
    assert bool((order.rows[1:] >= order.rows[:-1]).all())
    assert torch.equal(order.rows, order.key[order.perm])
    # the backward: each edge's destination's gradient, 0 into the sink
    want = torch.where((dst < n)[:, None], torch.full((e, 8), 3.0), 0.0)
    assert torch.equal(vals.grad, want)
    dst.add_(0)  # a write moves the version: the next sum sorts again
    common.aggregate(vals, dst, n)
    assert common.edge_order.sorts == before + 2


def test_wrapped_sum_gradcheck():
    """The wrapped sum's backward against finite differences, in float64 on
    the plain version."""
    rng = np.random.default_rng(5)
    n, e = 9, 60
    seg = torch.from_numpy(_unsorted_edges(rng, n, e))
    vals = torch.from_numpy(rng.standard_normal((e, 3))).requires_grad_()
    assert torch.autograd.gradcheck(lambda v: common.segment_sum(v, seg, n), (vals,))
    vals1 = torch.from_numpy(rng.standard_normal(e)).requires_grad_()
    assert torch.autograd.gradcheck(lambda v: common.segment_sum(v, seg, n), (vals1,))


def test_silu_is_jax_formula_and_its_gradient():
    rng = np.random.default_rng(11)
    x = rng.standard_normal(5000).astype(np.float32) * 6
    got = common.silu(torch.from_numpy(x))
    assert np.array_equal(_np(got), _np(torch.from_numpy(x) * torch.sigmoid(torch.from_numpy(x))))
    np.testing.assert_allclose(_np(got), np.asarray(jax.nn.silu(jnp.asarray(x))),
                               rtol=2.0**-22, atol=2.0**-126)
    x64 = torch.from_numpy(rng.standard_normal(40) * 4).requires_grad_()
    assert torch.autograd.gradcheck(common.silu, (x64,))


def test_bf16_messages_sum_in_float32():
    rng = np.random.default_rng(6)
    n, e = 25, 500
    dst = torch.from_numpy(_unsorted_edges(rng, n, e))
    msg = torch.from_numpy(rng.standard_normal((e, 16)).astype(np.float32)).to(torch.bfloat16)
    got = common.aggregate(msg, dst, n)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, common.aggregate(msg.float(), dst, n).to(torch.bfloat16))


def test_gnn_on_cpu_launches_no_kernel():
    for k in KERNELS.values():
        k.launches = 0
    cell = steps.build_cell("mace", "molecule", reduced=True, device="cpu")
    cell.step_fn(*cell.args)
    assert all(k.launches == 0 for k in KERNELS.values())


def test_graph_batch_from_csr_bit_for_bit():
    rng = np.random.default_rng(7)
    n = 40
    src, dst = rng.integers(0, n, 300), rng.integers(0, n, 300)
    feat = rng.standard_normal((n, 5)).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.int32)
    jb = j_common.graph_batch_from_csr(j_csr.from_coo(src, dst, n=n), feat, labels)
    tb = common.graph_batch_from_csr(csr.from_coo(src, dst, n=n, device="cpu"), feat, labels)
    for f in ("node_feat", "edge_src", "edge_dst", "labels"):
        a, b = _np(getattr(tb, f)), np.asarray(getattr(jb, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert tb.n_nodes == jb.n_nodes == n


# ---------------------------------------------------------------------------
# the model properties repro's tests hold (tests/test_models.py), on the port
# ---------------------------------------------------------------------------
def _mol(rng, n=24, e=64):
    return {
        "node_feat": torch.from_numpy(rng.integers(0, 10, n).astype(np.int32)),
        "positions": torch.from_numpy((rng.standard_normal((n, 3)) * 2).astype(np.float32)),
        "edge_src": torch.from_numpy(rng.integers(0, n, e).astype(np.int32)),
        "edge_dst": torch.from_numpy(rng.integers(0, n, e).astype(np.int32)),
        "graph_ids": torch.zeros((n,), dtype=torch.int32),
        "n_graphs": 1,
        "labels": torch.tensor([0.0]),
    }


def _rotation(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return torch.from_numpy(q.astype(np.float32))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("seed", [0, 1])
def test_mace_e3_equivariance(seed):
    rng = np.random.default_rng(seed)
    cfg = mace.MACEConfig(d_hidden=16, n_rbf=6)
    m = mace.init_model(cfg, generator=_gen(), device="cpu")
    p = m.tree()
    g = _mol(rng)
    q = _rotation(rng)
    pos = g["positions"]
    with torch.no_grad():
        e1 = mace.forward(p, g, cfg)
        e2 = mace.forward(p, {**g, "positions": pos @ q.T}, cfg)
        e3 = mace.forward(p, {**g, "positions": pos + 7.0}, cfg)
    np.testing.assert_allclose(_np(e1), _np(e2), rtol=1e-4, atol=1e-5)  # E invariant
    f1 = mace.forces(p, g, cfg)
    f2 = mace.forces(p, {**g, "positions": pos @ q.T}, cfg)
    np.testing.assert_allclose(_np(f1 @ q.T), _np(f2), rtol=1e-2, atol=1e-2)  # F equivariant
    np.testing.assert_allclose(_np(e1), _np(e3), rtol=1e-4, atol=1e-5)  # translation


def test_mace_chunked_equals_unchunked():
    g = _mol(np.random.default_rng(3))
    cfg1 = mace.MACEConfig(d_hidden=16, n_rbf=6)
    cfg2 = dataclasses.replace(cfg1, edge_chunks=4)
    p = mace.init_model(cfg1, generator=_gen(), device="cpu").tree()
    e1 = mace.forward(p, g, cfg1)
    e2 = mace.forward(p, g, cfg2)
    np.testing.assert_allclose(_np(e1), _np(e2), rtol=1e-4)
    g1, g2 = _grads(e1.sum(), p), _grads(e2.sum(), p)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-6)


def test_mace_forces_match_repro(monkeypatch):
    """Forces at rtol 1e-4, plus the rounding of each atom's sum of its
    edges' terms: a self-loop edge (src == dst, r = 0) feeds r̂ = rel / 1e-6,
    so its two terms (+g from the source, -g from the destination, each
    ~1e6 times the upstream gradient) cancel in float32 in both packages,
    leaving a few ulps of |g|, in each package's own summation order."""
    rng = np.random.default_rng(8)
    cfg_j = j_mace.MACEConfig(d_hidden=16, n_rbf=6)
    cfg_t = mace.MACEConfig(d_hidden=16, n_rbf=6)
    g = {k: (_np(v) if isinstance(v, torch.Tensor) else v) for k, v in _mol(rng).items()}
    n = g["positions"].shape[0]
    params = j_mace.init_params(jax.random.PRNGKey(0), cfg_j)
    jg = _jax(g)
    want = np.asarray(jax.jit(lambda p: j_mace.forces(p, jg, cfg_j))(params))
    model = mace.from_jax_params(jax.tree.map(np.asarray, params), cfg_t, device="cpu")
    # each atom's sum of |terms|: every gather of the positions, its |grad|
    terms = torch.zeros((n, 3), dtype=torch.float64)
    counts = torch.zeros(n, dtype=torch.float64)
    gather = common.gather

    def spy(node_vals, idx):
        out = gather(node_vals, idx)
        if node_vals.requires_grad and node_vals.is_leaf and node_vals.shape == (n, 3):
            ok = idx < n
            rows = torch.clamp(idx, max=n - 1).long()
            counts.index_add_(0, rows, ok.double())

            def hook(gr):
                terms.index_add_(0, rows, torch.where(ok[:, None], gr.abs().double(), 0.0))

            out.register_hook(hook)
        return out

    monkeypatch.setattr(common, "gather", spy)
    got = _np(mace.forces(model.tree(), _torch(g), cfg_t))
    # a float32 sum of k terms is within gamma_k = k*2^-24/(1-k*2^-24) of
    # sum|terms|; the two packages' sums within twice that
    k = counts.numpy()[:, None]
    gamma = k * 2.0**-24 / (1 - k * 2.0**-24)
    bound = 1e-4 * np.abs(want) + 2 * gamma * terms.numpy()
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()
    assert np.isfinite(got).all()


def test_schnet_cutoff_kills_far_edges():
    """Edges beyond the cutoff must contribute (numerically) nothing."""
    rng = np.random.default_rng(5)
    cfg = schnet.SchNetConfig(n_rbf=8, d_hidden=16, cutoff=2.0)
    p = schnet.init_model(cfg, generator=_gen(), device="cpu").tree()
    n = 8
    pos = np.zeros((n, 3), np.float32)
    pos[4:] += 100.0  # second cluster far beyond cutoff
    g = {
        "node_feat": torch.from_numpy(rng.integers(0, 5, n).astype(np.int32)),
        "positions": torch.from_numpy(pos),
        "edge_src": torch.tensor([0, 4], dtype=torch.int32),   # 0-4 crosses clusters
        "edge_dst": torch.tensor([4, 0], dtype=torch.int32),
        "graph_ids": torch.zeros((n,), dtype=torch.int32),
        "n_graphs": 1,
        "labels": torch.tensor([0.0]),
    }
    with torch.no_grad():
        e_with = schnet.forward(p, g, cfg)
        g2 = {**g, "edge_src": torch.tensor([n, n], dtype=torch.int32),
              "edge_dst": torch.tensor([n, n], dtype=torch.int32)}  # masked edges
        e_without = schnet.forward(p, g2, cfg)
    np.testing.assert_allclose(_np(e_with), _np(e_without), atol=1e-5)


def _graphcast_graph(rng, n=64, e=256, nv=8):
    return {
        "node_feat": torch.from_numpy(rng.standard_normal((n, nv)).astype(np.float32)),
        "edge_src": torch.from_numpy(rng.integers(0, n, e).astype(np.int32)),
        "edge_dst": torch.from_numpy(rng.integers(0, n, e).astype(np.int32)),
        "positions": torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)),
        "labels": torch.from_numpy(rng.standard_normal((n, nv)).astype(np.float32)),
    }


def test_graphcast_bf16_close_to_f32():
    """The bound tests/test_models.py holds repro's bf16 mode to."""
    g = _graphcast_graph(np.random.default_rng(6))
    cfg = graphcast.GraphCastConfig(n_layers=2, d_hidden=32, n_vars=8)
    cfgb = dataclasses.replace(cfg, bf16=True)
    p = graphcast.init_model(cfg, generator=_gen(), device="cpu").tree()
    with torch.no_grad():
        o1 = graphcast.forward(p, g, cfg)
        o2 = graphcast.forward(p, g, cfgb)
    assert o2.dtype == torch.float32
    np.testing.assert_allclose(_np(o1), _np(o2), rtol=0.1, atol=0.15)


def test_graphcast_bf16_matches_repro_bf16_bound():
    """repro's bf16 forward and the port's, on the same weights, each within
    the bf16 bound of repro's float32 forward."""
    rng = np.random.default_rng(9)
    g = _graphcast_graph(rng)
    cfg_j = j_graphcast.GraphCastConfig(n_layers=2, d_hidden=32, n_vars=8)
    params = j_graphcast.init_params(jax.random.PRNGKey(1), cfg_j)
    jg = _jax({k: _np(v) for k, v in g.items()})
    ref = np.asarray(j_graphcast.forward(params, jg, cfg_j))
    cfg_t = graphcast.GraphCastConfig(n_layers=2, d_hidden=32, n_vars=8, bf16=True)
    model = graphcast.from_jax_params(jax.tree.map(np.asarray, params), cfg_t, device="cpu")
    with torch.no_grad():
        got = model(g)
    np.testing.assert_allclose(_np(got), ref, rtol=0.1, atol=0.15)


def test_graphcast_remat_equals_no_remat():
    g = _graphcast_graph(np.random.default_rng(10))
    cfg = graphcast.GraphCastConfig(n_layers=3, d_hidden=32, n_vars=8)
    p = graphcast.init_model(cfg, generator=_gen(), device="cpu").tree()
    grads = []
    for c in (cfg, dataclasses.replace(cfg, remat=True)):
        loss, _ = graphcast.loss_fn(p, g, c)
        grads.append(_grads(loss, p))
    for a, b in zip(*grads):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
def test_shape_sets_match_repro():
    assert base.GNN_SHAPES == j_base.GNN_SHAPES
    assert base.LM_SHAPES == j_base.LM_SHAPES
    assert base.RECSYS_SHAPES == j_base.RECSYS_SHAPES
    assert base.FAMILY_SHAPES == j_base.FAMILY_SHAPES


@pytest.mark.parametrize("arch", sorted(ARCHS.values()))
def test_gnn_configs_match_repro(arch):
    """FULL and SMOKE field for field; the port adds only ``backend``."""
    je, te = j_base.get(arch), base.get(arch)
    assert (te.family, te.model, te.skip_shapes) == (je.family, je.model, je.skip_shapes)
    for which in ("full", "smoke"):
        jc, tc = getattr(je, which), getattr(te, which)
        jf = {f.name for f in dataclasses.fields(jc)}
        assert {f.name for f in dataclasses.fields(tc)} == jf | {"backend"}
        for f in jf:
            assert getattr(tc, f) == getattr(jc, f), (arch, which, f)
        assert tc.backend == "auto"


def test_all_cells_match_repro():
    assert set(base.all_archs()) == set(j_base.all_archs())
    assert base.all_cells() == sorted(j_base.all_cells(), key=lambda c: c[0])
    assert len(base.all_cells()) == 40


def test_shard_axes_are_noops_without_a_mesh():
    """``shard_axes`` is carried: without a mesh the constraints are no-ops,
    so the forward equals the unconstrained one bit for bit."""
    cfg = dataclasses.replace(base.get("gcn-cora").smoke, shard_axes=("data", "model"))
    cell = steps.build_cell("gcn-cora", "full_graph_sm", reduced=True, device="cpu")
    fwd = steps.GNN_MODULES["gcn"].forward
    got = fwd(cell.args[0]["params"], cell.args[1], cfg)
    want = fwd(cell.args[0]["params"], cell.args[1], base.get("gcn-cora").smoke)
    assert torch.equal(got, want)
