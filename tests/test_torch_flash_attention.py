"""Flash attention parity: the port's plain kernel version and ops against
``repro``'s.

The same numpy inputs go through ``repro``'s Pallas kernel in interpret
mode (as ``tests/test_kernels.py`` runs it) and the port's
``flash_attention_torch`` (what a CPU tensor takes; the CUDA kernel is
held against it on the card in ``tests/test_torch_kernels_gpu.py``).
float32 cases agree within ``repro``'s own rtol = atol = 2e-4
(``tests/test_kernels.py:154``); bfloat16 outputs within one bfloat16 ulp
(each side rounds an f32 result once; the f32 sums differ in order only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_fa
from repro_torch.kernels import KERNELS
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops

TOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(seed, b, hq, hkv, sq, skv, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(dtype)
                 for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,d,causal,window",
    [
        # the shapes of tests/test_kernels.py:137-146
        (2, 4, 2, 256, 256, 64, True, 0),
        (1, 4, 4, 128, 128, 32, False, 0),
        (1, 8, 2, 256, 256, 64, True, 96),
        (1, 2, 1, 512, 512, 128, True, 128),
        (1, 1, 1, 128, 128, 64, True, 32),
        # the model's head width (80), GQA 4:1 and a window
        (1, 8, 2, 256, 256, 80, True, 40),
        # Sq != Skv: rows from 80 on see no key and give 0
        (1, 4, 1, 256, 64, 32, True, 16),
    ],
)
def test_plain_matches_repro_kernel(b, hq, hkv, sq, skv, d, causal, window):
    q, k, v = _qkv(sq + d, b, hq, hkv, sq, skv, d)
    blk = min(128, skv)
    exp = np.asarray(j_fa.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, window=window, interpret=True,
                                    block_q=blk, block_k=blk))
    got = fa_kernel.flash_attention_torch(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), exp, **TOL)
    if sq > skv:
        assert not got[:, :, skv + window:].any()
    # the wrapper takes the plain version for CPU tensors, launching nothing
    launches = KERNELS["flash_attention"].launches
    assert torch.equal(fa_kernel.flash_attention(*_t(q, k, v), causal=causal, window=window),
                       got)
    assert KERNELS["flash_attention"].launches == launches


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def test_bf16_within_one_ulp_of_repro():
    q, k, v = _qkv(1, 1, 4, 2, 256, 256, 80)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    exp = np.asarray(j_fa.attention(jq, jk, jv, causal=True, window=64, interpret=True),
                     np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (jq, jk, jv))
    got = fa_kernel.flash_attention_torch(tq, tk, tv, causal=True, window=64)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - exp) <= _bf16_ulp(exp)).all()


def test_reference_matches_repro():
    q, k, v = _qkv(2, 2, 4, 2, 96, 64, 16)
    for causal, window in ((True, 0), (True, 8), (False, 0), (False, 24)):
        exp = np.asarray(j_fa.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v), causal=causal,
                                                  window=window))
        got = fa_ops.attention_reference(*_t(q, k, v), causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kv_len,window", [(40, 0), (64, 0), (64, 16)])
def test_decode_attention_matches_repro(kv_len, window):
    q, k, v = _qkv(kv_len, 3, 8, 2, 1, 64, 32)
    exp = np.asarray(j_fa.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           kv_len, window=window))
    got = fa_ops.decode_attention(*_t(q, k, v), kv_len, window=window)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-6)


def test_op_preconditions_and_backends():
    q, k, v = _t(*_qkv(3, 1, 2, 1, 96, 96, 16))
    with pytest.raises(ValueError, match="multiples"):
        fa_ops.attention(q, k, v, block_q=64, block_k=64)  # 96 % 64
    with pytest.raises(ValueError):
        fa_ops.attention(q, k, v, backend="cuda")  # a CPU tensor has no kernel
    exp = fa_ops.attention_reference(q, k, v, causal=True, window=20)
    for backend in ("auto", "torch"):
        got = fa_ops.attention(q, k, v, window=20, backend=backend, block_q=32, block_k=32)
        np.testing.assert_allclose(got.numpy(), exp.numpy(), **TOL)
