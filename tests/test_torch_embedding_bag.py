"""embedding_bag parity: the port's op and plain version against ``repro``'s.

``repro``'s Pallas kernel runs in interpret mode, adding ``row * w`` slot by
slot.  ``max`` picks existing values and must match bit for bit.  ``sum``
and ``mean`` add the same K terms in other roundings (a separate product
and sum here, an FMA on the card), so they are held to the bound of two
summation orders, 2·K·2^-24·Σ|row·w| per element; the mean divides both
sums by the same count, and the bound, left undivided, covers the
division's rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import kernel as j_kernel
from repro.kernels.embedding_bag import ops as j_ops
from repro_torch.kernels.embedding_bag import kernel as bag_kernel
from repro_torch.kernels.embedding_bag import ops as bag_ops

U = 2.0**-24


def _case(seed, v, d, b, k):
    """Bags with padding, an all-padding bag and ids >= V."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(-1, v, (b, k)).astype(np.int32)
    idx[0] = -1                # an empty bag
    idx[1, 0] = v + 7          # reads row v-1
    w = rng.uniform(0.5, 1.5, (b, k)).astype(np.float32)
    return table, idx, w


def _bound(table, idx, w):
    """2·K·2^-24·Σ|row·w| over each bag's valid slots, per element."""
    valid = idx >= 0
    rows = np.abs(table[np.clip(idx, 0, table.shape[0] - 1)].astype(np.float64))
    absum = (rows * np.where(valid, np.abs(w), 0.0)[..., None]).sum(axis=1)
    return 2 * idx.shape[1] * U * absum


@pytest.mark.parametrize("combine", ["sum", "mean", "max"])
@pytest.mark.parametrize("v,d,b,k", [(50, 16, 8, 5), (200, 128, 4, 16), (30, 8, 6, 3),
                                     (40, 256, 5, 16), (20, 6, 4, 7)])
def test_embedding_bag_matches_repro(combine, v, d, b, k):
    table, idx, w = _case(v + k, v, d, b, k)
    exp = np.asarray(j_ops.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), combine=combine,
        interpret=True))
    got = bag_ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                                torch.from_numpy(w), combine=combine).numpy()
    assert got.shape == (b, d)
    np.testing.assert_array_equal(got[0], 0.0)  # the empty bag
    if combine == "max":
        np.testing.assert_array_equal(got, exp)
    else:
        assert (np.abs(got - exp) <= _bound(table, idx, w)).all()


@pytest.mark.parametrize("combine", ["sum", "mean", "max"])
def test_embedding_bag_plain_matches_pallas_interpret(combine):
    """The plain version at the kernel's own operands (K a power of two)."""
    table, idx, w = _case(3, 64, 32, 6, 8)
    exp = np.asarray(j_kernel.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), combine=combine,
        interpret=True))
    args = (torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w), combine)
    for got in (bag_kernel.embedding_bag_torch(*args), bag_kernel.embedding_bag(*args)):
        if combine == "max":
            np.testing.assert_array_equal(got.numpy(), exp)
        else:
            assert (np.abs(got.numpy() - exp) <= _bound(table, idx, w)).all()


def test_embedding_bag_defaults_and_1d():
    """Weights default to 1; 1-D indices are one bag; K pads with -1."""
    table, idx, _ = _case(5, 30, 8, 3, 5)
    exp = np.asarray(j_ops.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                         combine="mean", interpret=True))
    got = bag_ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                                combine="mean").numpy()
    ones = np.ones(idx.shape, np.float32)
    assert (np.abs(got - exp) <= _bound(table, idx, ones)).all()
    one = bag_ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx[2]),
                                combine="mean")
    assert one.shape == (1, 8)
    np.testing.assert_array_equal(one.numpy()[0], got[2])  # same arithmetic


def test_embedding_bag_reference_matches_repro():
    table, idx, w = _case(9, 50, 16, 8, 8)
    for combine in ("sum", "mean", "max"):
        exp = np.asarray(j_ops.embedding_bag_reference(
            jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), combine=combine))
        got = bag_ops.embedding_bag_reference(
            torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w),
            combine=combine).numpy()
        assert (np.abs(got - exp) <= _bound(table, idx, w)).all()


def test_embedding_bag_rejects_unknown_combine():
    table, idx, w = _case(1, 10, 4, 2, 4)
    with pytest.raises(ValueError, match="combine"):
        bag_kernel.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                                 torch.from_numpy(w), "min")


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("v,d,b,k", [(50, 16, 8, 5), (200, 128, 4, 16), (20, 6, 40, 8)])
def test_embedding_bag_grad_matches_autograd_of_plain_bag(combine, v, d, b, k):
    """The op's table grad (its plain backward) equals autograd through the
    plain gather-and-sum bag bit for bit: the same products, added into each
    row in the same order.  Repeated ids, padding, ids >= V and an empty bag
    included; the forward equals the undifferentiated op's."""
    table, idx, w = _case(v + d, v, d, b, k)
    idx[2, :] = idx[3, 0]  # one row many times in a bag
    cot = torch.from_numpy(np.random.default_rng(d).standard_normal((b, d)).astype(np.float32))
    t = torch.tensor(table, requires_grad=True)
    out = bag_ops.embedding_bag(t, torch.from_numpy(idx), torch.from_numpy(w), combine=combine)
    with torch.no_grad():
        plain = bag_ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                                      torch.from_numpy(w), combine=combine)
    assert torch.equal(out.detach(), plain)
    (got,) = torch.autograd.grad((out * cot).sum(), t)
    k_pad = int(2 ** np.ceil(np.log2(k)))
    pidx = np.pad(idx, ((0, 0), (0, k_pad - k)), constant_values=-1)
    pw = np.pad(w, ((0, 0), (0, k_pad - k)))
    t2 = torch.tensor(table, requires_grad=True)
    ref = bag_ops.embedding_bag_reference(t2, torch.from_numpy(pidx), torch.from_numpy(pw),
                                          combine=combine)
    (want,) = torch.autograd.grad((ref * cot).sum(), t2)
    assert torch.equal(got, want)
    assert float(got.abs().max()) > 0


def test_embedding_bag_max_has_no_backward():
    table, idx, w = _case(2, 10, 4, 2, 4)
    t = torch.tensor(table, requires_grad=True)
    with pytest.raises(NotImplementedError, match="max"):
        bag_ops.embedding_bag(t, torch.from_numpy(idx), torch.from_numpy(w), combine="max")
    with torch.no_grad():  # serving through max is fine
        bag_ops.embedding_bag(t, torch.from_numpy(idx), torch.from_numpy(w), combine="max")
