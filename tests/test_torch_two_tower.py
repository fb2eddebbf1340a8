"""Two-tower parity: the port's model against ``repro``'s, serving and
training.

``repro``'s ``init_params`` is carried across with ``from_jax_params``; the
same numpy bags go through both.  ``repro`` runs its jnp bag path
(``use_kernel=False``: the Pallas kernel needs a TPU outside interpret
mode, and ``tests/test_torch_embedding_bag.py`` holds the kernel itself).
Scores agree within rtol 1e-5 and atol 1e-6: float32 products of up to
1024 terms summed in other orders by XLA and PyTorch.  The in-batch
softmax loss and every gradient (the tables' through the bag's plain
backward) agree within rtol 1e-4, atol 1e-6 of the leaf's max|grad|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.configs import two_tower_retrieval as j_cfgs
from repro.models.recsys import two_tower as j_tt
from repro_torch.configs import base
from repro_torch.configs import two_tower_retrieval as cfgs
from repro_torch.core import tree
from repro_torch.models.recsys import two_tower as tt

#: FULL's widths (embed_dim 256, towers 1024-512-256, 4 and 2 fields, bags
#: of 16) with a vocabulary of 1000
FULL_WIDTH = dataclasses.replace(j_cfgs.FULL, n_users=1000, n_items=1000)
#: ``repro``'s config fields the port renames (``use_kernel`` is ``backend``)
NOT_CARRIED = {"use_kernel"}


def _bags(rng, n, nf, k, vocab, min_len=0):
    """Ids uniform over the vocabulary, a ragged tail of -1 (lengths
    min_len..k)."""
    ids = rng.integers(0, vocab, (n, nf, k))
    lens = rng.integers(min_len, k + 1, (n, nf, 1))
    return np.where(np.arange(k) < lens, ids, -1).astype(np.int32)


def _models(j_cfg, seed):
    params = j_tt.init_params(jax.random.PRNGKey(seed), j_cfg)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    cfg = cfgs.TwoTowerConfig(**{
        f.name: getattr(j_cfg, f.name)
        for f in dataclasses.fields(j_cfg) if f.name not in NOT_CARRIED})
    return params, tt.from_jax_params(params_np, cfg, device="cpu")


@pytest.mark.parametrize("j_cfg", [j_cfgs.SMOKE, FULL_WIDTH], ids=["smoke", "full_width"])
def test_serve_step_matches_repro(j_cfg):
    params, model = _models(j_cfg, 0)
    rng = np.random.default_rng(1)
    k = j_cfg.bag_size
    batch = {"user_bags": _bags(rng, 8, j_cfg.n_user_fields, k, j_cfg.n_users),
             "item_bags": _bags(rng, 8, j_cfg.n_item_fields, k, j_cfg.n_items)}
    exp = np.asarray(j_tt.serve_step(params, {n: jnp.asarray(b) for n, b in batch.items()},
                                     j_cfg))
    got = model.serve_step({n: torch.from_numpy(b) for n, b in batch.items()})
    assert got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("j_cfg", [j_cfgs.SMOKE, FULL_WIDTH], ids=["smoke", "full_width"])
def test_score_candidates_matches_repro(j_cfg):
    params, model = _models(j_cfg, 2)
    rng = np.random.default_rng(3)
    k = j_cfg.bag_size
    ub = _bags(rng, 1, j_cfg.n_user_fields, k, j_cfg.n_users)
    cb = _bags(rng, 16, j_cfg.n_item_fields, k, j_cfg.n_items)
    exp = np.asarray(j_tt.score_candidates(params, jnp.asarray(ub), jnp.asarray(cb), j_cfg))
    got = model.score_candidates(torch.from_numpy(ub), torch.from_numpy(cb))
    assert got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-6)
    # the candidates scored against the tiled query, pair by pair
    pair = model.serve_step({"user_bags": torch.from_numpy(np.tile(ub, (16, 1, 1))),
                             "item_bags": torch.from_numpy(cb)})
    np.testing.assert_allclose(got.numpy(), pair.numpy(), rtol=1e-5, atol=1e-6)


def test_plain_backend_is_the_same_model():
    _, model = _models(j_cfgs.SMOKE, 4)
    plain = model.with_backend("torch")
    assert plain.user.table.data_ptr() == model.user.table.data_ptr()
    rng = np.random.default_rng(4)
    batch = {"user_bags": torch.from_numpy(_bags(rng, 5, 2, 4, 1000)),
             "item_bags": torch.from_numpy(_bags(rng, 5, 2, 4, 1000))}
    assert torch.equal(plain.serve_step(batch), model.serve_step(batch))


def test_init_model_shapes_and_scale():
    cfg = cfgs.SMOKE
    m = tt.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert tuple(m.user.table.shape) == (cfg.n_users, cfg.embed_dim)
    tree = m.tree()
    assert [tuple(lp["w"].shape) for lp in tree["item"]["mlp"]] == [(2 * 16, 32), (32, 16)]
    assert 0.005 < float(m.user.table.std()) < 0.015
    assert all(bool((lp["b"] == 0).all()) for lp in tree["user"]["mlp"])


@pytest.mark.parametrize("which", ["FULL", "SMOKE"])
def test_configs_match_repro(which):
    j_cfg, cfg = getattr(j_cfgs, which), getattr(cfgs, which)
    j_fields = {f.name: getattr(j_cfg, f.name) for f in dataclasses.fields(j_cfg)}
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    assert j_fields["use_kernel"] is False and fields.pop("backend") == "auto"
    assert set(j_fields) - set(fields) == NOT_CARRIED
    assert fields == {k: v for k, v in j_fields.items() if k not in NOT_CARRIED}


@pytest.mark.parametrize("j_cfg", [j_cfgs.SMOKE, FULL_WIDTH], ids=["smoke", "full_width"])
def test_loss_and_grads_match_repro(j_cfg):
    """In-batch sampled softmax with a logQ correction, at batch 16.  No
    bag is empty: an example whose every bag is empty embeds to 0, where
    ``repro``'s L2 norm has a NaN gradient."""
    params, model = _models(j_cfg, 5)
    rng = np.random.default_rng(6)
    k, b = j_cfg.bag_size, 16
    batch = {"user_bags": _bags(rng, b, j_cfg.n_user_fields, k, j_cfg.n_users, min_len=1),
             "item_bags": _bags(rng, b, j_cfg.n_item_fields, k, j_cfg.n_items, min_len=1),
             "item_logq": rng.uniform(-2, 0, b).astype(np.float32)}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: j_tt.loss_fn(p, {n: jnp.asarray(v) for n, v in batch.items()}, j_cfg),
        has_aux=True))(params)
    p = model.tree()
    got, _ = tt.loss_fn(p, {n: torch.from_numpy(v) for n, v in batch.items()}, model.cfg)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-4)
    g = dict(zip([k for k, _ in tree.paths(p)], torch.autograd.grad(got, tree.leaves(p))))
    want = dict(tree.paths(jax.tree.map(np.asarray, grads)))
    assert sorted(g) == sorted(want)
    for k, e in want.items():
        np.testing.assert_allclose(g[k].numpy(), e, rtol=1e-4, atol=1e-6 * np.abs(e).max(),
                                   err_msg=k)
    assert all(float(g[f"{t}/table"].abs().max()) > 0 for t in ("user", "item"))


def test_shard_axes_are_noops_without_a_mesh():
    """``shard_axes`` is carried: without a mesh the towers' constraints are
    no-ops, bit for bit."""
    cfg = dataclasses.replace(cfgs.SMOKE, shard_axes=("data",))
    params = tt.init_params(cfgs.SMOKE, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    bags = torch.from_numpy(np.random.default_rng(3).integers(
        -1, cfgs.SMOKE.n_users, (4, cfgs.SMOKE.n_user_fields, cfgs.SMOKE.bag_size)
    ).astype(np.int32))
    got = tt.tower_forward(params["user"], bags, cfg)
    assert torch.equal(got, tt.tower_forward(params["user"], bags, cfgs.SMOKE))


def test_recsys_shapes_match_repro():
    assert base.RECSYS_SHAPES == j_base.RECSYS_SHAPES
