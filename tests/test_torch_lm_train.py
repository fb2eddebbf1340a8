"""LM training parity: the port's transformer loss, gradients and train
steps against ``repro``'s (``models/transformer/model.py``, ``train``).

SMOKE-sized configs in float32 compute — dense with a sliding window
through the blocked attention, qkv-bias through the dense reference, MoE
with arctic's dense residual — each with float32 and bfloat16 parameters.
``repro``'s ``init_params`` is carried across (a bfloat16 leaf bit for
bit) and the same numpy tokens go through both; ``repro`` runs jitted.
The loss and every gradient agree within rtol 1e-4, atol 1e-6 (a bfloat16
leaf within one bfloat16 rounding, rtol 2^-7); three train steps' params
within rtol 1e-5, atol 1e-6 (bfloat16 params: rtol 2^-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as j_ckpt
from repro.models.transformer import attention as j_attn
from repro.models.transformer import config as j_cfg
from repro.models.transformer import model as j_model
from repro.train import loop as j_loop
from repro.train import optimizer as j_opt
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import tree
from repro_torch.launch import train as train_cli
from repro_torch.models import param_tree
from repro_torch.models.transformer import attention as attn
from repro_torch.models.transformer import config as cfg_mod
from repro_torch.models.transformer import model as tm
from repro_torch.train import loop, optimizer as opt

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
BF16_RTOL = 2.0**-7
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
KINDS = {
    "dense": dict(sliding_window=16, attn_impl="blocked", attn_block=8),
    "bias": dict(qkv_bias=True, n_kv_heads=2, attn_impl="ref", rope_theta=1e4),
    "moe": dict(d_ff=0, attn_impl="ref",
                moe=dict(n_experts=8, top_k=2, d_ff_expert=32, dense_residual_ff=48)),
}
#: the train steps' optimizer: the reduced LM cell's (launch/steps.py
#: OPT_CFG) for float32 params; for bfloat16 params a rate large enough
#: that they move at all (bfloat16 moments, OPT_CFG_BF16's state dtype)
STEP_OPT = {jnp.float32: dict(lr=1e-4, warmup_steps=10, total_steps=1000),
            jnp.bfloat16: dict(lr=1e-2, warmup_steps=0, total_steps=100)}


def _cfgs(kind, dtype):
    kw = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
              d_ff=96, vocab=101, compute_dtype=jnp.float32, param_dtype=dtype) | KINDS[kind]
    moe = kw.pop("moe", None)
    jc = j_cfg.TransformerConfig(**kw, moe=moe and j_cfg.MoEConfig(**moe))
    kw["compute_dtype"], kw["param_dtype"] = torch.float32, DTYPES[dtype]
    return jc, cfg_mod.TransformerConfig(**kw, moe=moe and cfg_mod.MoEConfig(**moe))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == ml_dtypes.bfloat16 else x


def _close(got, want, rtol, atol, what, bf16):
    gp, wp = dict(tree.paths(got)), dict(tree.paths(want))
    assert sorted(gp) == sorted(wp), what
    for k in wp:
        w = _np(wp[k])
        if bf16:
            np.testing.assert_allclose(_np(gp[k]), w, rtol=BF16_RTOL,
                                       atol=BF16_RTOL * float(np.abs(w).max(initial=0.0)),
                                       err_msg=f"{what}: {k}")
        else:
            np.testing.assert_allclose(_np(gp[k]), w, rtol=rtol, atol=atol,
                                       err_msg=f"{what}: {k}")


def _port_params(params, tc):
    return tree.tree_map(lambda p: p.requires_grad_(), param_tree.tensors_from_numpy(
        jax.tree.map(np.asarray, params), tc.param_dtype, device="cpu"))


def _opt_cfgs(dtype):
    j = j_opt.OptimizerConfig(**STEP_OPT[dtype], state_dtype=dtype)
    return j, opt.OptimizerConfig(**STEP_OPT[dtype], state_dtype=DTYPES[dtype])


@pytest.fixture(scope="module", params=[(k, d) for k in KINDS for d in ("f32", "bf16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    kind, dname = request.param
    dtype = jnp.float32 if dname == "f32" else jnp.bfloat16
    jc, tc = _cfgs(kind, dtype)
    params = j_model.init_params(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab, (2, 2, 32)).astype(np.int32)
    labels = rng.integers(0, jc.vocab, (2, 2, 32)).astype(np.int32)
    batch = {"tokens": toks[0], "labels": labels[0]}

    @jax.jit
    def ref(p):
        return jax.value_and_grad(lambda q: j_model.loss_fn(q, batch, jc), has_aux=True)(p)

    (loss, aux), grads = ref(params)
    jopt, topt = _opt_cfgs(dtype)
    step = jax.jit(j_loop.make_train_step(lambda p, b: j_model.loss_fn(p, b, jc), jopt,
                                          grad_accum=2))
    state = j_loop.init_state(params, jopt)
    losses = []
    for _ in range(3):
        state, m = step(state, {"tokens": toks, "labels": labels})
        losses.append(float(m["loss"]))
    return dict(kind=kind, jc=jc, tc=tc, params=params, toks=toks, labels=labels,
                batch=batch, loss=float(loss), aux=float(aux["aux"]), grads=grads,
                step_losses=losses, step_params=state["params"], topt=topt,
                bf16=dtype == jnp.bfloat16)


def test_loss_and_grads_match_repro(case):
    tc = case["tc"]
    params = _port_params(case["params"], tc)
    assert all(p.dtype == tc.param_dtype for p in tree.leaves(params))
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    loss, metrics = tm.loss_fn(params, batch, tc)
    np.testing.assert_allclose(float(loss.detach()), case["loss"], rtol=GRAD_RTOL)
    np.testing.assert_allclose(float(metrics["aux"]), case["aux"], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    assert (float(metrics["aux"]) > 0) == (case["kind"] == "moe")
    grads = tree.unflatten(params, torch.autograd.grad(loss, tree.leaves(params)))
    assert all(g.dtype == tc.param_dtype for g in tree.leaves(grads))
    _close(grads, case["grads"], GRAD_RTOL, GRAD_ATOL, "grads", case["bf16"])


def test_train_steps_match_repro(case):
    """Three AdamW steps over two microbatches (grads accumulated in
    float32; bfloat16 moments for bfloat16 params)."""
    tc = case["tc"]
    state = loop.init_state(_port_params(case["params"], tc), case["topt"])
    step = loop.make_train_step(lambda p, b: tm.loss_fn(p, b, tc), case["topt"], grad_accum=2)
    batch = {"tokens": torch.from_numpy(case["toks"]), "labels": torch.from_numpy(case["labels"])}
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, case["step_losses"], rtol=GRAD_RTOL)
    assert all(m.dtype == case["topt"].state_dtype for m in tree.leaves(state["opt_state"]["m"]))
    _close(state["params"], case["step_params"], STEP_RTOL, STEP_ATOL, "params after 3 steps",
           case["bf16"])
    assert not np.array_equal(_np(state["params"]["layers"]["wq"]),
                              _np(case["params"]["layers"]["wq"]))


def test_remat_equals_no_remat_bit_for_bit(case):
    tc = case["tc"]
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    out = []
    for remat in (True, False):
        c = dataclasses.replace(tc, remat=remat)
        params = _port_params(case["params"], c)
        loss, _ = tm.loss_fn(params, batch, c)
        out.append((loss, torch.autograd.grad(loss, tree.leaves(params))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_blocked_attention_grads_match_repro(causal, window):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 4, 64, 16)).astype(np.float32)
    k, v, c = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 2, 64, 16), (2, 2, 64, 16), (2, 4, 64, 16)))
    exp = jax.grad(lambda *a: jnp.sum(j_attn.blocked_attention(
        *a, causal=causal, window=window, block=16) * c), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = attn.blocked_attention(*leaves, causal=causal, window=window, block=16)
    got = torch.autograd.grad((out * torch.from_numpy(c)).sum(), leaves)
    for name, g, e in zip("qkv", got, exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-6 * np.abs(np.asarray(e)).max(), err_msg=name)


def test_flash_refuses_to_record_grads():
    _, tc = _cfgs("dense", jnp.float32)
    tc = dataclasses.replace(tc, attn_impl="flash")
    params = tree.tree_map(lambda p: p.requires_grad_(), tm.init_params(
        tc, generator=torch.Generator().manual_seed(0), device="cpu"))
    toks = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="no backward"):
        tm.loss_fn(params, {"tokens": toks, "labels": toks}, tc)
    with torch.no_grad():  # serving through the flash op is fine
        assert tm.forward(params, toks, tc)[0].shape == (1, 16, tc.vocab)


def test_moe_decode_matches_repro():
    """Six decode steps of the MoE config (capacity factor 2.0) against
    repro's jitted decode_step, logits and cache."""
    jc, tc = _cfgs("moe", jnp.float32)
    params = j_model.init_params(jax.random.PRNGKey(2), jc)
    model = tm.from_jax_params(jax.tree.map(np.asarray, params), tc, device="cpu")
    toks = np.random.default_rng(5).integers(0, jc.vocab, (3, 6)).astype(np.int32)
    jcache, cache = j_model.init_cache(jc, 3, 8), tm.init_cache(tc, 3, 8, device="cpu")
    step = jax.jit(lambda p, c, t: j_model.decode_step(p, c, t, jc))
    for i in range(6):
        exp, jcache = step(params, jcache, jnp.asarray(toks[:, i:i + 1]))
        got, cache = model.decode_step(cache, torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].float().numpy(),
                                   np.asarray(jcache[name], np.float32), rtol=2**-7, atol=0)


def test_bf16_state_checkpoint_round_trip(tmp_path):
    """A bfloat16 LM train state saved by the port restores in the port bit
    for bit; its leaves are repro's raw 16-bit words (npz descr <V2), which
    repro's own restore cannot read back (ROADMAP.md §3)."""
    jc, tc = _cfgs("moe", jnp.bfloat16)
    jopt, topt = _opt_cfgs(jnp.bfloat16)
    params = j_model.init_params(jax.random.PRNGKey(0), jc)
    state = loop.init_state(_port_params(params, tc), topt)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, 101, (2, 16)).astype(np.int32))
    state, _ = loop.make_train_step(lambda p, b: tm.loss_fn(p, b, tc), topt)(
        state, {"tokens": toks, "labels": toks})
    ck = str(tmp_path / "ck")
    train_cli.save(ck, 1, state)
    with np.load(str(tmp_path / "ck" / "step_0000000001" / "shard_0.npz")) as data:
        assert data["params/embed"].dtype == np.dtype("V2")
    assert ckpt.restore_arrays(ck)[0]["opt_state/m/layers/w1"].dtype == np.dtype("V2")
    fresh = loop.init_state(_port_params(params, tc), topt)
    assert train_cli.restore(ck, fresh) == 1
    for (k, a), (_, b) in zip(tree.paths(fresh), tree.paths(state)):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach()), k
    # repro's restore into its own bf16 state raises on the same npz
    with pytest.raises(ValueError, match="cast"):
        j_ckpt.restore(ck, j_loop.init_state(params, jopt))
