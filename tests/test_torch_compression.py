"""Gradient compression: the port's ``runtime/compression.py`` against
``repro``'s, on the same numpy grads.

int8: codes, scales, decompressed grads and error-feedback residuals bit
for bit (the same float32 operations; both round half to even).  top-k on
distinct magnitudes (so the kept set is unique): bit for bit.  The wire
byte counts are equal.  Each compressor also runs as ``make_train_step``'s
``compress_fn`` hook.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import compression as j_comp
from repro_torch.core import tree
from repro_torch.runtime import compression as comp
from repro_torch.train import loop, optimizer as opt


def _grads(seed, halves=False):
    """A grads tree; ``halves`` plants values that sit exactly on .5 codes."""
    rng = np.random.default_rng(seed)
    g = {"w": rng.standard_normal((16, 8)).astype(np.float32) * 3,
         "b": rng.standard_normal(8).astype(np.float32),
         "layers": [{"k": rng.standard_normal((3, 4, 5)).astype(np.float32) * 1e-3}]}
    if halves:
        g["w"][0, :6] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -3.5], np.float32) * (
            float(np.abs(g["w"]).max()) / 127.0)
    return g


def _same(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_array_equal(a, np.asarray(b), err_msg=what)
    assert a.dtype == np.asarray(b).dtype, what


@pytest.mark.parametrize("halves", [False, True])
def test_int8_codes_and_scale_bit_for_bit(halves):
    for k, g in tree.paths(_grads(0, halves)):
        jq, js = j_comp.int8_compress(jnp.asarray(g))
        q, s = comp.int8_compress(torch.from_numpy(g))
        _same(q, jq, f"{k} codes")
        _same(s, js, f"{k} scale")
        _same(comp.int8_decompress(q, s), j_comp.int8_decompress(jq, js), f"{k} decompressed")


def test_int8_error_feedback_bit_for_bit():
    jc, tc = j_comp.make_int8_ef_compressor(), comp.make_int8_ef_compressor()
    for seed in range(4):
        g = _grads(seed, halves=seed == 2)
        jout = jc(jax.tree.map(jnp.asarray, g))
        tout = tc(tree.tree_map(torch.from_numpy, g))
        for (k, a), (_, b) in zip(tree.paths(tout), tree.paths(jout)):
            _same(a, b, f"step {seed}: {k}")
    # the residuals are carried in the closures: a fifth call sees them
    zero = jax.tree.map(np.zeros_like, _grads(0))
    for (k, a), (_, b) in zip(tree.paths(tc(tree.tree_map(torch.from_numpy, zero))),
                              tree.paths(jc(jax.tree.map(jnp.asarray, zero)))):
        _same(a, b, f"residual only: {k}")
        assert np.abs(a.numpy()).max() > 0, k


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_bit_for_bit(frac):
    """Distinct magnitudes: the kept set (and its order) is unique."""
    rng = np.random.default_rng(3)
    g = (rng.permutation(240).astype(np.float32) + 1) * np.where(
        rng.random(240) < 0.5, -1, 1).astype(np.float32) / 7
    g = g.reshape(12, 20)
    jo, jr = j_comp.topk_compress(jnp.asarray(g), frac)
    o, r = comp.topk_compress(torch.from_numpy(g), frac)
    _same(o, jo, "kept")
    _same(r, jr, "residual")
    assert int((o != 0).sum()) == max(int(240 * frac), 1)


def test_topk_error_feedback_bit_for_bit():
    jc, tc = j_comp.make_topk_ef_compressor(0.1), comp.make_topk_ef_compressor(0.1)
    rng = np.random.default_rng(4)
    for step in range(3):
        # each step 2^10 times the last: the residual carried in (at most
        # 300 of the last step's units) keeps every magnitude distinct
        scale = np.float32(2.0 ** (10 * step))
        g = {"a": (rng.permutation(300).astype(np.float32) + 1).reshape(15, 20) * scale,
             "b": (rng.permutation(40).astype(np.float32) + 1) * scale}
        for (k, a), (_, b) in zip(tree.paths(tc(tree.tree_map(torch.from_numpy, g))),
                                  tree.paths(jc(jax.tree.map(jnp.asarray, g)))):
            _same(a, b, f"step {step}: {k}")


@pytest.mark.parametrize("scheme", ["int8", "topk", "none"])
def test_compressed_psum_bytes_match_repro(scheme):
    for n in (1, 1000, 1_831_201_280, 235_093_610_496):
        assert comp.compressed_psum_bytes(n, scheme) == j_comp.compressed_psum_bytes(n, scheme)
        assert (comp.compressed_psum_bytes(n, scheme, frac=0.05)
                == j_comp.compressed_psum_bytes(n, scheme, frac=0.05))


@pytest.mark.parametrize("make", ["int8", "topk"])
def test_compressor_as_train_step_hook(make):
    """The hook's output reaches the optimizer: with SGD at lr 1 the update
    is the decompressed grad, and the residual is what it left out."""
    cfg = opt.OptimizerConfig(name="sgd", lr=1.0, warmup_steps=0, total_steps=10,
                              clip_norm=0.0, min_lr_ratio=1.0)
    hook = comp.make_int8_ef_compressor() if make == "int8" else comp.make_topk_ef_compressor(0.25)
    target = torch.from_numpy(np.random.default_rng(5).standard_normal(16).astype(np.float32))
    state = loop.init_state({"x": torch.zeros(16, requires_grad=True)}, cfg)
    step = loop.make_train_step(lambda p, b: (torch.sum((p["x"] - b["t"]) ** 2) / 2, {}),
                                cfg, compress_fn=hook)
    state, _ = step(state, {"t": target})
    x = state["params"]["x"].detach()
    if make == "int8":
        q, s = comp.int8_compress(-target)
        assert torch.equal(x, -comp.int8_decompress(q, s))
    else:
        assert int((x != 0).sum()) == 4
        kept = x != 0
        assert torch.equal(x[kept], target[kept])
