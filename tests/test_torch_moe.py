"""The port's MoE layer against ``repro``'s (``models/transformer/moe.py``).

The same numpy inputs go through both ``moe_ffn``s (``repro`` eagerly, so
its intermediate dispatch arrays can be read).  The integer dispatch state
— each assignment's slot, its keep flag and the slot→token buffer — must
equal ``repro``'s bit for bit on inputs without tied probabilities; the
output and the aux loss agree within rtol 1e-5 and 1e-6 of max|out| (the
same float32 products, summed in other orders).  Cases are
``tests/test_models.py``'s two (every token kept; capacity 1, most
dropped: its router made tie-free) and one with a few drops at top-2.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import moe as j_moe
from repro_torch.models.transformer import moe

OUT_RTOL, OUT_ATOL = 1e-5, 1e-6


def _case(name):
    rng = np.random.default_rng({"routes": 4, "drops": 5, "some_drops": 6}[name])
    if name == "drops":
        # everyone wants expert 0; the small noise breaks the other ties
        t, d, e, k, cap, f = 32, 8, 4, 1, 1, 8
        router = np.zeros((d, e), np.float32)
        router[0, 0] = 10.0
        router += rng.standard_normal((d, e)).astype(np.float32) * 1e-2
        ws = [np.full((e, d, f), 0.1, np.float32), np.full((e, d, f), 0.1, np.float32),
              np.full((e, f, d), 0.1, np.float32)]
    else:
        t, d, e, k, f = 64, 16, 8, 2, 24
        cap = 32 if name == "routes" else 16
        router = rng.standard_normal((d, e)).astype(np.float32)
        ws = [(rng.standard_normal((e, d, f)) / 4).astype(np.float32),
              (rng.standard_normal((e, d, f)) / 4).astype(np.float32),
              (rng.standard_normal((e, f, d)) / 5).astype(np.float32)]
    x = rng.standard_normal((t, d)).astype(np.float32)
    return x, router, ws, k, cap


def _repro_dispatch(monkeypatch, x, router, ws, k, cap):
    """``repro``'s outputs and its dispatch state, read off its first
    ``jnp.where`` (keep -> slot) and first ``jnp.minimum`` (the slot→token
    buffer) calls."""
    seen = {}

    def where(*args):
        out = jnp.where(*args)
        seen.setdefault("where", (args[0], out))
        return out

    def minimum(a, b):
        seen.setdefault("idx_buf", a)
        return jnp.minimum(a, b)

    spy = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp) if not n.startswith("__")})
    spy.where, spy.minimum = where, minimum
    monkeypatch.setattr(j_moe, "jnp", spy)
    out, aux = j_moe.moe_ffn(jnp.asarray(x), jnp.asarray(router), *map(jnp.asarray, ws),
                             top_k=k, capacity=cap, compute_dtype=jnp.float32)
    keep, slot = seen["where"]
    return (np.asarray(out), float(aux),
            {"keep": np.asarray(keep), "slot": np.asarray(slot),
             "idx_buf": np.asarray(seen["idx_buf"])})


@pytest.mark.parametrize("name", ["routes", "drops", "some_drops"])
def test_moe_matches_repro(monkeypatch, name):
    x, router, ws, k, cap = _case(name)
    exp_out, exp_aux, exp_state = _repro_dispatch(monkeypatch, x, router, ws, k, cap)
    tx, tr = torch.from_numpy(x), torch.from_numpy(router)
    r = moe.dispatch(tx, tr, top_k=k, capacity=cap)
    for key in ("keep", "slot", "idx_buf"):
        np.testing.assert_array_equal(getattr(r, key).numpy(), exp_state[key], err_msg=key)
    dropped = int(r.dropped)
    assert dropped == int((~exp_state["keep"]).sum())
    assert (dropped == 0) == (name == "routes")
    out, aux = moe.moe_ffn(tx, tr, *map(torch.from_numpy, ws), top_k=k, capacity=cap,
                           compute_dtype=torch.float32)
    assert out.shape == exp_out.shape and out.dtype == torch.float32
    scale = float(np.abs(exp_out).max())
    np.testing.assert_allclose(out.numpy(), exp_out, rtol=OUT_RTOL, atol=OUT_ATOL * scale)
    np.testing.assert_allclose(float(aux), exp_aux, rtol=OUT_RTOL)
    if name == "routes":  # no token dropped: every output row is live
        assert (out.abs().sum(-1) > 0).all()


def test_moe_grads_match_repro():
    """d(sum(out * c) + aux) / d(x, router, w1, w3, w2) within rtol 1e-4."""
    import jax

    x, router, ws, k, cap = _case("some_drops")
    c = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def j_loss(*args):
        out, aux = j_moe.moe_ffn(*args, top_k=k, capacity=cap, compute_dtype=jnp.float32)
        return jnp.sum(out * c) + aux

    exp = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, [x, router, *ws]))
    leaves = [torch.tensor(a, requires_grad=True) for a in [x, router, *ws]]
    out, aux = moe.moe_ffn(*leaves, top_k=k, capacity=cap, compute_dtype=torch.float32)
    got = torch.autograd.grad((out * torch.from_numpy(c)).sum() + aux, leaves)
    for name, g, e in zip(["x", "router", "w1", "w3", "w2"], got, exp):
        e = np.asarray(e)
        np.testing.assert_allclose(g.numpy(), e, rtol=1e-4, atol=1e-6 * np.abs(e).max(),
                                   err_msg=name)


def test_expert_capacity_matches_repro():
    for args in [(4096, 128, 8, 1.25), (32768, 128, 2, 1.25), (128, 128, 8, 2.0),
                 (64, 8, 2, 1.25), (1, 4, 1, 1.0)]:
        assert moe.expert_capacity(*args) == j_moe.expert_capacity(*args)


def test_expert_parallel_axes_are_noops_without_a_mesh():
    """``ep_axis`` / ``token_axes`` are carried: on plain tensors (no mesh)
    they change nothing, bit for bit."""
    x, router, ws, k, cap = _case("routes")
    args = (torch.from_numpy(x), torch.from_numpy(router), *map(torch.from_numpy, ws))
    out, aux = moe.moe_ffn(*args, top_k=k, capacity=cap, ep_axis="data",
                           token_axes=("data",), tp_axis="model")
    want, want_aux = moe.moe_ffn(*args, top_k=k, capacity=cap)
    assert torch.equal(out, want) and torch.equal(aux, want_aux)
