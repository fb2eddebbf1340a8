"""The port's (arch, shape) cells against ``repro``'s (``launch/steps.py``),
and the train CLI on the LM and recsys archs.

Every non-skipped SMOKE cell is built with ``reduced=True`` and stepped on
the CPU.  One cell of each (family, kind) — LM train / prefill / decode,
recsys train / serve / retrieval — is held against ``repro``'s jitted step
on ``repro``'s own initial weights and inputs (copied into the port's
state): train steps' losses at rtol 1e-5, params at rtol 1e-5, atol 1e-6;
logits at rtol = atol = 1e-4 (float32 sums in other orders, as in
``tests/test_torch_transformer.py``); scores at rtol 1e-5, atol 1e-6.  The
GNN cells are held in ``tests/test_torch_gnn.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as j_ckpt
from repro.configs import base as j_base
from repro.launch import steps as j_steps
from repro_torch.configs import base
from repro_torch.core import tree
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli

j_base.all_archs()  # the whole registry, before any single config module loads

CELLS = [(a, s) for a, s, skip in j_base.all_cells() if skip is None]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@torch.no_grad()
def _load(dst, src):
    """``repro``'s arrays into the port's tensors of the same tree, in place."""
    tree.tree_map(lambda t, v: t.copy_(torch.from_numpy(np.array(v, dtype=np.float32))),
                  dst, src)


def _torch(x):
    return tree.tree_map(lambda v: torch.from_numpy(np.array(v)), jax.tree.map(np.asarray, x))


def test_all_cells_match_repro():
    assert base.all_cells() == sorted(j_base.all_cells(), key=lambda c: c[0])
    assert len(base.all_cells()) == 40
    assert [c[:2] for c in base.all_cells() if c[2]] == [
        (a, "long_500k") for a in ("arctic-480b", "mistral-large-123b", "qwen2-72b",
                                   "qwen3-moe-235b-a22b")]
    for name, e in base.all_archs().items():
        je = j_base.get(name)
        assert (e.family, e.model, e.skip_shapes) == (je.family, je.model, je.skip_shapes)


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}/{s}" for a, s in CELLS])
def test_smoke_cell_steps_on_cpu(arch, shape):
    cell = steps.build_cell(arch, shape, reduced=True, device="cpu")
    kind = base.FAMILY_SHAPES[base.get(arch).family][shape]["kind"]
    if kind in ("train", "full", "batched", "sampled"):
        state = cell.args[0]
        before = {k: v.detach().clone() for k, v in tree.paths(state["params"])}
        state, metrics = cell.step_fn(*cell.args)
        assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
        after = dict(tree.paths(state["params"]))
        assert any(not torch.equal(before[k], after[k]) for k in before)
        if "embed" in before:  # an LM train step moves the embedding
            assert not torch.equal(before["embed"], after["embed"].detach())
        return
    out = cell.step_fn(*cell.args)
    logits = out[0] if isinstance(out, tuple) else out
    assert bool(torch.isfinite(logits).all())
    if kind == "decode":
        assert out[1]["pos"] == 1 and logits.shape[:2] == (2, 1)


@pytest.mark.parametrize("arch", ["qwen2-72b", "arctic-480b"])
def test_lm_train_cell_matches_repro(arch):
    """Two AdamW steps of the reduced train cell (two microbatches each)."""
    jcell = j_steps.build_cell(arch, "train_4k", reduced=True)
    jstate, jbatch = jcell.args
    cell = steps.build_cell(arch, "train_4k", reduced=True, device="cpu")
    state, _ = cell.args
    assert cell.meta["accum"] == 2 and cell.meta["opt_cfg"].state_dtype == torch.float32
    _load(state["params"], jstate["params"])
    batch = _torch(jbatch)
    assert tuple(batch["tokens"].shape) == (2, 2, 32)
    jstep = jax.jit(jcell.step_fn)
    for _ in range(2):
        jstate, jm = jstep(jstate, jbatch)
        state, m = cell.step_fn(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    for (k, a), (_, b) in zip(tree.paths(state["params"]), tree.paths(jstate["params"])):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch,shape", [("mistral-large-123b", "prefill_32k"),
                                        ("qwen3-moe-235b-a22b", "decode_32k")])
def test_lm_serving_cell_matches_repro(arch, shape):
    jcell = j_steps.build_cell(arch, shape, reduced=True)
    cell = steps.build_cell(arch, shape, reduced=True, device="cpu")
    _load(cell.args[0], jcell.args[0])
    # repro's tokens; the decode cache is zeros at position 0 in both
    args = cell.args[:-1] + (_torch(jcell.args[-1]),)
    exp = jax.jit(jcell.step_fn)(*jcell.args)
    got = cell.step_fn(*args)
    if shape == "decode_32k":
        exp, got = exp[0], got[0]
    np.testing.assert_allclose(_np(got), np.asarray(exp), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", ["train_batch", "serve_p99", "retrieval_cand"])
def test_recsys_cell_matches_repro(shape):
    jcell = j_steps.build_cell("two-tower-retrieval", shape, reduced=True)
    cell = steps.build_cell("two-tower-retrieval", shape, reduced=True, device="cpu")
    jparams = jcell.args[0]["params"] if shape == "train_batch" else jcell.args[0]
    params = cell.args[0]["params"] if shape == "train_batch" else cell.args[0]
    _load(params, jparams)
    for k, v in jcell.args[1].items():  # repro's numpy draws, bit for bit
        np.testing.assert_array_equal(cell.args[1][k].numpy(), np.asarray(v), err_msg=k)
    exp = jax.jit(jcell.step_fn)(*jcell.args)
    got = cell.step_fn(*cell.args)
    if shape != "train_batch":
        np.testing.assert_allclose(_np(got), np.asarray(exp), rtol=1e-5, atol=1e-6)
        return
    np.testing.assert_allclose(float(got[1]["loss"]), float(exp[1]["loss"]), rtol=1e-5)
    for (k, a), (_, b) in zip(tree.paths(got[0]["params"]), tree.paths(exp[0]["params"])):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=k)


def test_variants_and_opt_cell(monkeypatch):
    """``cost1``/``cost2`` cut the depth and drop the accumulation; the GNN
    ``chunkN`` variants build MACE with ``edge_chunks=N`` and record it as
    ``repro`` does (other models build as ``full``); the optimizer-only cell
    updates a bfloat16-moment state (its FULL config swapped for SMOKE's, so
    it fits the CPU)."""
    chunked = steps.build_cell("mace", "molecule", reduced=True, variant="chunk4",
                               device="cpu")
    assert chunked.meta["cfg"].edge_chunks == 4
    assert chunked.loop_correction == {"kind": "gnn_chunked", "chunks": 4,
                                       "layers": chunked.meta["cfg"].n_layers}
    gcn4 = steps.build_cell("gcn-cora", "full_graph_sm", reduced=True, variant="chunk4",
                            device="cpu")
    assert gcn4.loop_correction == {"kind": "gnn"}
    entry = base.get("qwen3-moe-235b-a22b")
    small = dataclasses.replace(entry, full=dataclasses.replace(entry.smoke, n_layers=3))
    monkeypatch.setattr(steps.cfgbase, "get", lambda name: small)
    for v, n in (("cost1", 1), ("cost2", 2)):
        cell = steps.build_cell("x", "train_4k", variant=v, device="cpu")
        assert cell.meta["cfg"].n_layers == n and cell.meta["accum"] == 1
        assert tuple(cell.args[1]["tokens"].shape) == (16, 4096)
        assert cell.meta["opt_cfg"].state_dtype == torch.bfloat16
    full = steps.build_cell("x", "prefill_32k", device="cpu")
    assert full.meta["cfg"].n_layers == 3 and tuple(full.args[1].shape) == (32, 32768)
    opt_cell = steps.build_opt_cell("x", variant="opt1", device="cpu")
    state, grads = opt_cell.args
    before = state["params"]["layers"]["w1"].detach().clone()
    new = opt_cell.step_fn(state, grads)
    assert new["opt_state"]["m"]["layers"]["w1"].dtype == torch.bfloat16
    assert int(new["opt_state"]["step"]) == 1
    assert not torch.equal(new["params"]["layers"]["w1"].detach(), before)


def test_lm_param_counts_match_names():
    """``tests/test_smoke_archs.py``'s targets, on the port's configs."""
    targets = {"mistral-large-123b": 123e9, "h2o-danube-1.8b": 1.8e9, "qwen2-72b": 72e9,
               "qwen3-moe-235b-a22b": 235e9, "arctic-480b": 480e9}
    for name, want in targets.items():
        got = base.get(name).full.n_params()
        assert abs(got - want) / want < 0.05, f"{name}: {got / 1e9:.1f}B vs {want / 1e9}B"
        assert got == j_base.get(name).full.n_params()
        assert base.get(name).full.n_active_params() == j_base.get(name).full.n_active_params()
    assert abs(base.get("qwen3-moe-235b-a22b").full.n_active_params() - 22e9) / 22e9 < 0.05


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "two-tower-retrieval"])
def test_train_cli_trains_and_resumes(tmp_path, arch):
    """The loss falls; a run resumed from the last checkpoint (step 12)
    takes the 13th step of an uninterrupted run."""
    ck = str(tmp_path / "ck")
    losses = train_cli.main(["--arch", arch, "--steps", "12", "--ckpt-dir", ck,
                             "--ckpt-every", "5", "--log-every", "5", "--device", "cpu"])
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert j_ckpt.all_steps(ck) == [5, 10, 12]
    resumed = train_cli.main(["--arch", arch, "--steps", "2", "--ckpt-dir", ck, "--resume",
                              "--device", "cpu"])
    straight = train_cli.main(["--arch", arch, "--steps", "13", "--device", "cpu"])
    np.testing.assert_allclose(resumed[0], straight[12], rtol=1e-6)
