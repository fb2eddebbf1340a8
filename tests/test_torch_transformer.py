"""Transformer serving parity: the port's LM against ``repro``'s.

``repro``'s ``init_params`` is carried across with ``from_jax_params``;
the same numpy tokens go through both.  ``repro``'s ``attn_impl="flash"``
runs its Pallas kernel in interpret mode (``ops.attention`` patched with
``interpret=True``, as ``tests/test_kernels.py`` calls it); the port's CPU
tensors take the kernel's plain version.  float32 logits agree within
1e-4 (f32 sums in other orders); bfloat16 ones within ``repro``'s own
bfloat16 tolerance, 5e-2 (``tests/test_kernels.py:163``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.kernels.flash_attention import ops as j_fa
from repro.models.transformer import attention as j_attn
from repro.models.transformer import config as j_cfg
from repro.models.transformer import model as j_model
from repro_torch.configs import base
from repro_torch.configs import h2o_danube_1_8b as danube
from repro_torch.models.transformer import attention as attn
from repro_torch.models.transformer import config as cfg_mod
from repro_torch.models.transformer import model as tm

j_base.all_archs()  # the whole registry, before any single config module loads

F32 = dict(rtol=1e-4, atol=1e-4)
#: ``repro``'s config fields the port leaves out: the layer scan (a Python
#: loop in the port)
NOT_CARRIED = {"scan_layers"}
LARGE_LM_ARCHS = ["qwen2-72b", "mistral-large-123b", "qwen3-moe-235b-a22b", "arctic-480b"]
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _cfgs(**kw):
    """The same config in both packages (f32 compute unless given)."""
    kw = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
              d_ff=96, vocab=101, attn_block=16, compute_dtype=jnp.float32) | kw
    jc = j_cfg.TransformerConfig(**kw)
    kw["compute_dtype"] = DTYPES[kw["compute_dtype"]]
    return jc, cfg_mod.TransformerConfig(**kw)


def _models(jc, tc, seed=0):
    params = j_model.init_params(jax.random.PRNGKey(seed), jc)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    return params, tm.from_jax_params(params_np, tc, device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.fixture
def interpreted_flash(monkeypatch):
    """``repro``'s flash op with its Pallas kernel in interpret mode."""
    monkeypatch.setattr(j_fa, "attention",
                        functools.partial(j_fa.attention, interpret=True))


@pytest.mark.parametrize("kw", [
    dict(sliding_window=24),                       # GQA 4:1, S > window > block
    dict(n_kv_heads=2, qkv_bias=True, sliding_window=0, rope_theta=1e4),
], ids=["gqa4_window", "gqa2_bias"])
def test_forward_matches_repro(interpreted_flash, kw):
    jc, tc = _cfgs(attn_impl="flash", **kw)
    params, model = _models(jc, tc)
    toks = _tokens(1, 2, 64, jc.vocab)
    got, aux = model(torch.from_numpy(toks))
    assert got.shape == (2, 64, jc.vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    for impl in ("flash", "ref"):
        exp, _ = j_model.forward(params, jnp.asarray(toks), dataclasses.replace(jc, attn_impl=impl))
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), **F32)


def test_bf16_forward_matches_repro(interpreted_flash):
    jc, tc = _cfgs(attn_impl="flash", sliding_window=24, compute_dtype=jnp.bfloat16)
    params, model = _models(jc, tc, seed=1)
    toks = _tokens(2, 1, 64, jc.vocab)
    exp, _ = j_model.forward(params, jnp.asarray(toks), jc)
    got, _ = model(torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(exp, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_blocked_attention_matches_repro(causal, window):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 4, 64, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 64, 16)).astype(np.float32) for _ in range(2))
    exp = j_attn.blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, window=window, block=16)
    got = attn.blocked_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=causal, window=window, block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        attn.blocked_attention(*(torch.from_numpy(x) for x in (q, k, v)), block=24)


def test_rope_matches_repro():
    x = np.random.default_rng(4).standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32) * 811, (2, 40))
    exp = j_attn.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = attn.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5, atol=2e-5)


def test_decode_steps_match_repro():
    """12 steps against a ring of 8 slots (it wraps), logits and cache.

    The cache is bfloat16 on both sides: an f32 K/V value a few f32 ulps
    apart may round to neighbouring bfloat16 numbers, so the cache agrees
    within one bfloat16 spacing (2^-7 relative)."""
    jc, tc = _cfgs(attn_impl="ref", sliding_window=8)
    params, model = _models(jc, tc, seed=2)
    toks = _tokens(5, 2, 12, jc.vocab)
    jcache, cache = j_model.init_cache(jc, 2, 64), tm.init_cache(tc, 2, 64, device="cpu")
    assert tuple(cache["k"].shape) == jcache["k"].shape == (2, 2, 1, 8, 16)
    step = jax.jit(lambda p, c, t: j_model.decode_step(p, c, t, jc))
    for i in range(12):
        exp, jcache = step(params, jcache, jnp.asarray(toks[:, i:i + 1]))
        got, cache = model.decode_step(cache, torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), **F32)
    assert cache["pos"] == int(jcache["pos"]) == 12
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].float().numpy(),
                                   np.asarray(jcache[name], np.float32), rtol=2**-7, atol=0)


def test_decode_matches_forward_last_token():
    """As ``tests/test_models.py:46``: 8 decode steps end on the logits of
    the prompt's last position, within 2e-2 (the bfloat16 cache)."""
    _, tc = _cfgs(n_layers=3, n_kv_heads=2, d_ff=128, sliding_window=16,
                  attn_impl="flash", attn_block=4)
    model = tm.init_model(tc, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_tokens(6, 2, 8, tc.vocab))
    full, _ = model(toks)
    cache = tm.init_cache(tc, 2, 16, device="cpu")
    for i in range(8):
        logits, cache = model.decode_step(cache, toks[:, i:i + 1])
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(), rtol=2e-2, atol=2e-2)


def test_with_backend_shares_weights_and_agrees():
    _, tc = _cfgs(attn_impl="flash", sliding_window=24)
    model = tm.init_model(tc, generator=torch.Generator().manual_seed(1), device="cpu")
    plain = model.with_backend("torch")
    assert plain.cfg.backend == "torch" and model.cfg.backend == "auto"
    assert plain.embed.data_ptr() == model.embed.data_ptr()
    assert plain.layers.w2[1].data_ptr() == model.layers.w2[1].data_ptr()
    toks = torch.from_numpy(_tokens(7, 1, 32, tc.vocab))
    assert torch.equal(plain(toks)[0], model(toks)[0])


def test_init_model_shapes_and_scale():
    cfg = danube.SMOKE
    m = tm.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert sum(p.numel() for p in m.parameters()) == cfg.n_params()
    assert tuple(m.layers.wq.shape) == (2, 64, 64) and tuple(m.layers.wk.shape) == (2, 64, 32)
    assert tuple(m.unembed.shape) == (64, 256)
    assert 0.8 < float(m.layers.w1[0].std() * 64 ** 0.5) < 1.2
    assert bool((m.layers.ln2[1] == 1).all()) and bool((m.ln_f == 1).all())
    shapes = tm.cache_shapes(danube.FULL, 128, 32768)
    assert tuple(shapes["k"].shape) == (24, 128, 8, 4096, 80)
    assert shapes["k"].dtype == torch.bfloat16 and shapes["k"].is_meta


def _check_config(arch, which):
    j_c, c = getattr(j_base.get(arch), which.lower()), getattr(base.get(arch), which.lower())
    j_fields = {f.name: getattr(j_c, f.name) for f in dataclasses.fields(j_c)}
    fields = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
    assert fields.pop("backend") == "auto"
    for name in ("param_dtype", "compute_dtype"):
        j_fields[name] = DTYPES[j_fields[name]]
    for f in (fields, j_fields):
        f["moe"] = f["moe"] and dataclasses.asdict(f["moe"])
    assert set(j_fields) - set(fields) == NOT_CARRIED
    assert fields == {k: v for k, v in j_fields.items() if k not in NOT_CARRIED}
    assert (c.n_params(), c.n_active_params()) == (j_c.n_params(), j_c.n_active_params())
    assert (c.head_dim, c.is_subquadratic) == (j_c.head_dim, j_c.is_subquadratic)
    assert base.get(arch).skip_shapes == j_base.get(arch).skip_shapes


@pytest.mark.parametrize("which", ["FULL", "SMOKE"])
def test_configs_match_repro(which):
    _check_config("h2o-danube-1.8b", which)


@pytest.mark.parametrize("which", ["FULL", "SMOKE"])
@pytest.mark.parametrize("arch", LARGE_LM_ARCHS)
def test_large_lm_configs_match_repro(arch, which):
    """qwen2-72b, mistral-large-123b and the two MoE configs, field for
    field (``MoEConfig`` too), with their counts and skipped shapes."""
    _check_config(arch, which)


def test_lm_shapes_match_repro():
    assert base.LM_SHAPES == j_base.LM_SHAPES

