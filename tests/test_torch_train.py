"""The port's train loop, optimizers, checkpoints and train CLI against
``repro``'s (``repro_torch.train``, ``repro_torch.launch.train``).

The same parameters and grads, made with numpy, go through both packages'
optimizers; their schedules, clipping and the grad-accumulation step are
held against each other; a train state crosses the packages through the
checkpoint format both share.
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as j_ckpt
from repro.configs import base as j_base
from repro.launch import steps as j_steps
from repro.train import loop as j_loop
from repro.train import optimizer as j_opt
from repro_torch.core import tree
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.train import loop, optimizer as opt

j_base.all_archs()  # the whole registry, before any single config module loads

#: the port's update against repro's: the same float32 formulas, whose sums
#: (norms, Adafactor's means) add in other orders.  A parameter that five
#: updates bring near 0 keeps the absolute error of its larger terms, so the
#: trees are held at rtol 1e-6 of each element plus 1e-6 of the tree's max
OPT_RTOL = 1e-6

OPTIMIZERS = {
    "adamw": dict(name="adamw"),
    "adamw_bf16": dict(name="adamw", state="bf16"),
    "adafactor": dict(name="adafactor"),
    "sgd": dict(name="sgd"),
}


def _cfgs(name, **kw):
    spec = dict(OPTIMIZERS[name])
    bf16 = spec.pop("state", None) == "bf16"
    common = dict(lr=0.05, warmup_steps=2, total_steps=8, weight_decay=0.1, clip_norm=1.0)
    common.update(kw)
    j = j_opt.OptimizerConfig(**spec, **common,
                              state_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    t = opt.OptimizerConfig(**spec, **common,
                            state_dtype=torch.bfloat16 if bf16 else torch.float32)
    return j, t


def _params(rng):
    return {"w": rng.standard_normal((6, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32),
            "k": rng.standard_normal((2, 3, 5)).astype(np.float32),
            "layers": [{"w": rng.standard_normal((4, 3)).astype(np.float32)}]}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == ml_dtypes.bfloat16 else x


def _assert_trees_close(got, want, rtol, atol=0.0, what="", scaled=False):
    """Leaf by leaf; ``scaled`` adds ``rtol`` times the leaf's max|want| to
    ``atol``."""
    gp, wp = dict(tree.paths(got)), dict(tree.paths(want))
    assert sorted(gp) == sorted(wp), what
    for k in wp:
        w = _np(wp[k])
        tol = atol + (rtol * float(np.abs(w).max(initial=0.0)) if scaled else 0.0)
        np.testing.assert_allclose(_np(gp[k]), w, rtol=rtol, atol=tol, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_update_matches_repro(name):
    """Five updates of the same params with the same grads (large enough
    that clipping engages): params and state within rtol 1e-6."""
    jcfg, tcfg = _cfgs(name)
    rng = np.random.default_rng(1)
    p0 = _params(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = tree.tree_map(torch.from_numpy, jax.tree.map(np.copy, p0))
    js, ts = j_opt.init(jp, jcfg), opt.init(tp, tcfg)
    for i in range(5):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * (0.2 + i)).astype(np.float32), p0)
        jp, js, jm = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp, jcfg)
        tp, ts, tm = opt.update(tree.tree_map(torch.from_numpy, g), ts, tp, tcfg)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=OPT_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=OPT_RTOL)
    _assert_trees_close(tp, jp, OPT_RTOL, what="params", scaled=True)
    _assert_trees_close(ts, js, OPT_RTOL, what="state", scaled=True)
    assert int(ts["step"]) == int(js["step"]) == 5 and ts["step"].dtype == torch.int32


@pytest.mark.parametrize("warmup,total,min_ratio", [(100, 10_000, 0.1), (0, 50, 0.0),
                                                    (10, 1000, 0.1)])
def test_schedule_matches_repro(warmup, total, min_ratio):
    kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=total, min_lr_ratio=min_ratio)
    jcfg, tcfg = j_opt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
    for s in (0, 1, 5, 10, 99, 100, 101, 500, 999, 1000, 5000, 10_000, 20_000):
        got = opt.schedule(torch.tensor(s, dtype=torch.int32), tcfg)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(j_opt.schedule(jnp.int32(s), jcfg)),
                                   rtol=OPT_RTOL)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_clip_by_global_norm_matches_repro(scale):
    rng = np.random.default_rng(2)
    g = jax.tree.map(lambda a: a * scale, _params(rng))
    jg, jn = j_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tg, tn = opt.clip_by_global_norm(tree.tree_map(torch.from_numpy, g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_RTOL)
    _assert_trees_close(tg, jg, OPT_RTOL, what="clipped grads")


def test_grad_accum_matches_full_batch():
    """accumulated microbatch grads == one full-batch grad step (as
    tests/test_train.py holds repro), and both equal repro's."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((6, 3)).astype(np.float32)
    xs = rng.standard_normal((8, 6)).astype(np.float32)
    ys = rng.standard_normal((8, 3)).astype(np.float32)

    def loss_fn(p, batch):
        pred = batch["x"] @ p["w"]
        return torch.mean((pred - batch["y"]) ** 2), {}

    cfg = opt.OptimizerConfig(lr=0.1, warmup_steps=0, weight_decay=0.0, clip_norm=0.0)

    def fresh():
        return loop.init_state({"w": torch.tensor(w, requires_grad=True)}, cfg)

    s1, m1 = loop.make_train_step(loss_fn, cfg)(fresh(), {"x": torch.tensor(xs),
                                                          "y": torch.tensor(ys)})
    mb = {"x": torch.tensor(xs.reshape(4, 2, 6)), "y": torch.tensor(ys.reshape(4, 2, 3))}
    s2, m2 = loop.make_train_step(loss_fn, cfg, grad_accum=4)(fresh(), mb)
    np.testing.assert_allclose(_np(s1["params"]["w"]), _np(s2["params"]["w"]), rtol=1e-5)
    jcfg = j_opt.OptimizerConfig(lr=0.1, warmup_steps=0, weight_decay=0.0, clip_norm=0.0)
    js, jm = jax.jit(j_loop.make_train_step(
        lambda p, b: (jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2), {}), jcfg, grad_accum=4))(
        j_loop.init_state({"w": jnp.asarray(w)}, jcfg),
        {"x": jnp.asarray(xs.reshape(4, 2, 6)), "y": jnp.asarray(ys.reshape(4, 2, 3))})
    np.testing.assert_allclose(_np(s2["params"]["w"]), np.asarray(js["params"]["w"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(m2["loss"]), float(jm["loss"]), rtol=1e-5)


def test_adamw_converges():
    cfg = opt.OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=200, weight_decay=0.0)
    state = loop.init_state({"x": torch.ones((4, 4), requires_grad=True)}, cfg)
    step = loop.make_train_step(
        lambda p, b: (torch.sum((p["x"] - b["target"]) ** 2), {}), cfg)
    batch = {"target": torch.full((4, 4), 3.0)}
    for _ in range(200):
        state, m = step(state, batch)
    assert float(m["loss"]) < 1e-2


@pytest.mark.parametrize("name", ["adafactor", "sgd"])
def test_other_optimizers_step(name):
    cfg = opt.OptimizerConfig(name=name, lr=0.05, warmup_steps=0, total_steps=100)
    state = loop.init_state({"w": torch.ones((8, 4), requires_grad=True),
                             "b": torch.zeros(4, requires_grad=True)}, cfg)
    step = loop.make_train_step(
        lambda p, b: (torch.sum((torch.ones(8) @ p["w"] + p["b"] - 1.0) ** 2), {}), cfg)
    losses = []
    for _ in range(50):
        state, m = step(state, {})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_compress_hook_and_train_loop():
    """``compress_fn`` sees the grads before the optimizer; ``train`` logs
    every ``log_every`` steps and runs its hooks."""
    cfg = opt.OptimizerConfig(lr=0.2, warmup_steps=0, weight_decay=0.0)
    seen = []

    def compress(grads):
        seen.append(float(grads["x"].abs().sum()))
        return tree.tree_map(lambda g: g * 0, grads)  # drops every update

    state = loop.init_state({"x": torch.ones(8, requires_grad=True)}, cfg)
    step = loop.make_train_step(
        lambda p, b: (torch.sum((p["x"] - b["t"]) ** 2), {}), cfg, compress_fn=compress)
    hooks_at = []
    state, hist = loop.train(state, step, [{"t": torch.full((8,), -2.0)}] * 5,
                             hooks=[lambda i, s: hooks_at.append(i)], log_every=2)
    assert len(seen) == 5 and seen[0] > 0
    assert torch.equal(state["params"]["x"].detach(), torch.ones(8))
    assert hooks_at == [0, 1, 2, 3, 4]
    assert [h["step"] for h in hist] == [0, 2, 4] and all("loss" in h for h in hist)


# ---------------------------------------------------------------------------
# the train CLI and checkpoints across the packages
# ---------------------------------------------------------------------------
def test_train_cli_e2e(tmp_path):
    """launch/train.py reduces loss and restarts from checkpoints (as
    tests/test_launch.py holds repro's)."""
    ck = str(tmp_path / "ck")
    losses = train_cli.main(["--arch", "gcn-cora", "--steps", "25", "--ckpt-dir", ck,
                             "--ckpt-every", "10", "--log-every", "10", "--device", "cpu"])
    assert losses[-1] < losses[0]
    assert j_ckpt.all_steps(ck) == [10, 20, 25]
    losses2 = train_cli.main(["--arch", "gcn-cora", "--steps", "5", "--ckpt-dir", ck,
                              "--resume", "--device", "cpu"])
    assert losses2[0] <= losses[0]
    np.testing.assert_allclose(losses2[0], losses[-1], rtol=0.05)


def _j_state():
    cell = j_steps.build_cell("gcn-cora", "full_graph_sm", reduced=True)
    return cell.args[0]


def test_port_checkpoint_restores_in_repro(tmp_path):
    ck = str(tmp_path / "ck")
    train_cli.main(["--arch", "gcn-cora", "--steps", "3", "--ckpt-dir", ck, "--device", "cpu"])
    restored, at = j_ckpt.restore(ck, _j_state())
    assert at == 3
    cell = steps.build_cell("gcn-cora", "full_graph_sm", reduced=True, device="cpu")
    state = cell.args[0]
    assert train_cli.restore(ck, state) == 3
    assert int(restored["opt_state"]["step"]) == 3
    _assert_trees_close(state, restored, 0.0, what="restored state")


def test_repro_checkpoint_resumes_in_port(tmp_path):
    ck = str(tmp_path / "ck")
    cell = j_steps.build_cell("gcn-cora", "full_graph_sm", reduced=True)
    state, batch = cell.args
    step = jax.jit(cell.step_fn)
    for _ in range(4):
        state, _ = step(state, batch)
    j_ckpt.save(ck, 4, state)
    tcell = steps.build_cell("gcn-cora", "full_graph_sm", reduced=True, device="cpu")
    tstate = tcell.args[0]
    params_before = tstate["params"]["layers"][0]["w"]
    assert train_cli.restore(ck, tstate) == 4
    assert tstate["params"]["layers"][0]["w"] is params_before  # in place
    _assert_trees_close(tstate, state, 0.0, what="restored state")
    # and the port trains on from it, as repro does
    tstate, tm = tcell.step_fn(tstate, tcell.args[1])
    state, jm = step(state, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_trees_close(tstate["params"], state["params"], 1e-5, 1e-6, what="step 5")
    assert os.path.isdir(os.path.join(ck, "step_0000000004"))
