"""Rank programs of ``tests/test_torch_sharding.py`` (imported by the
spawned ranks, so it imports neither ``jax`` nor ``repro``)."""
import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import sharding_utils as su
from repro_torch.models.transformer import model

#: the real mesh of the 4 CPU ranks
MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")
#: the decode cells' positions, one step each in turn: the SMOKE caches
#: hold 8 slots a model rank (h2o's 16-slot ring, qwen3-moe's 64-slot
#: linear cache 32), so the live prefix ends in rank 0's slice, then spans
#: both, then wraps the ring (h2o) or fills the cache (qwen3-moe)
DECODE_POSITIONS = {"h2o-danube-1.8b": (5, 12, 21), "qwen3-moe-235b-a22b": (5, 40, 70)}


def row_parallel_inputs():
    """A bfloat16 [4, 8, 64] activation and [64, 32] weight from seed 0."""
    g = torch.Generator().manual_seed(0)
    return (torch.randn(4, 8, 64, generator=g).to(torch.bfloat16),
            torch.randn(64, 32, generator=g).to(torch.bfloat16))


def rank_runs(rank_mesh, cells, decode_cells=(), sampled=()):
    """This rank's records: ``rank_cells``, ``rank_row_parallel``,
    ``rank_decode`` and ``rank_sampled``."""
    dm = mesh_mod.make_mesh_like(MESH_SHAPE, MESH_AXES, device_type="cpu")
    return {"cells": rank_cells(dm, cells), "row_parallel": rank_row_parallel(dm),
            "decode": [rank_decode(dm, a, s) for a, s in decode_cells],
            "sampled": [rank_sampled(dm, a, d) for a, d in sampled]}


def decode_cell(arch, shape, data_axes=()):
    """The reduced decode cell with its bfloat16 cache filled N(0, 1) from
    seed 3 (so every slot, live or not, holds keys and values)."""
    cell = steps.build_cell(arch, shape, reduced=True, device="cpu", data_axes=data_axes)
    g = torch.Generator().manual_seed(3)
    for key in ("k", "v"):
        buf = cell.args[1][key]
        buf.copy_(torch.randn(buf.shape, generator=g).to(buf.dtype))
    return cell


def decode_steps(step, params, cache, tokens, positions, full=lambda t: t):
    """One step at each position in turn: ``[(logits, k, v), ...]`` as numpy
    (``full`` gathers a DTensor)."""
    out = []
    for pos in positions:
        logits, cache = step(params, {**cache, "pos": pos}, tokens)
        out.append(tuple(full(t).float().numpy() for t in (logits, cache["k"], cache["v"])))
    return out


def rank_decode(dm, arch, shape):
    """The decode cell sharded over ``dm``: ``decode_steps`` at the arch's
    ``DECODE_POSITIONS``, gathered, and the counters of the last step."""
    cell = decode_cell(arch, shape, mesh_mod.data_axes(dm))
    sharded = steps.shard_cell(cell, steps.attach_shardings(cell, dm, arch, shape), dm)
    params, cache, tokens = sharded.args
    pos = DECODE_POSITIONS[arch]
    out = decode_steps(sharded.step_fn, params, cache, tokens, pos[:-1],
                       full=lambda t: t.full_tensor())
    with dryrun.LocalCounter() as counter:
        logits, cache = sharded.step_fn(params, {**cache, "pos": pos[-1]}, tokens)
    out.append(tuple(t.full_tensor().float().numpy() for t in (logits, cache["k"], cache["v"])))
    return {"steps": out, "argument_bytes": dryrun.arg_bytes(sharded.args),
            "collectives": counter.collectives(), "flops": counter.flops,
            "cache_placements": str(tuple(cache["k"].placements))}


def sampled_cell(arch, draws, data_axes=()):
    """The reduced minibatch_lg cell with ``draws`` (one [frontier, fanout]
    float32 array a hop) in its batch."""
    cell = steps.build_cell(arch, "minibatch_lg", reduced=True, device="cpu",
                            data_axes=data_axes)
    cell.args[1]["draws"] = [torch.from_numpy(np.array(d)) for d in draws]
    return cell


def rank_sampled(dm, arch, draws):
    """One step of the sampled cell sharded over ``dm``: the subgraph
    (gathered), the loss, the parameters after the step, the argument
    bytes (the cell's own, without the uniforms) and the counters."""
    cell = sampled_cell(arch, draws, mesh_mod.data_axes(dm))
    sharded = steps.shard_cell(cell, steps.attach_shardings(cell, dm, arch, "minibatch_lg"), dm)
    state, batch = sharded.args
    g = cell.meta["graph"]
    with su.use_mesh(dm):
        sub = {k: (v.full_tensor().numpy() if hasattr(v, "full_tensor") else v)
               for k, v in g(batch).items()}
    assert all(not isinstance(v, torch.Tensor) for v in sub.values()), "a plain subgraph tensor"
    with dryrun.LocalCounter() as counter:
        state, metrics = sharded.step_fn(state, batch)
    return {"subgraph": sub, "loss": float(metrics["loss"]),
            "params": {k: v.full_tensor().detach().numpy()
                       for k, v in tree.paths(state["params"])},
            "argument_bytes": dryrun.arg_bytes(
                (sharded.args[0], {k: v for k, v in batch.items() if k != "draws"})),
            "collectives": counter.collectives(), "flops": counter.flops}


def rank_row_parallel(dm):
    """``model._row_parallel`` of ``row_parallel_inputs`` with the
    activation's batch over ``"data"`` and its columns over ``"model"``, the
    weight FSDP-sharded over ``"data"`` and its rows over ``"model"``: the
    gathered output and the grads of sum(out²)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    a, w = row_parallel_inputs()
    ad = distribute_tensor(a, dm, (Shard(0), Shard(2)), src_data_rank=None).requires_grad_()
    wd = distribute_tensor(w, dm, (Shard(1), Shard(0)), src_data_rank=None).requires_grad_()
    out = model._row_parallel(ad, wd, torch.bfloat16)
    (out.float() ** 2).sum().backward()
    return {"out": out.full_tensor(), "a_grad": ad.grad.full_tensor(),
            "w_grad": wd.grad.full_tensor(), "placements": str(tuple(out.placements))}


def rank_cells(dm, cells):
    """One step of each reduced (arch, shape) cell sharded over ``dm``, a
    (2, 2) ``("data", "model")`` DeviceMesh of the 4 ranks: its loss, its
    gathered parameters (``full_tensor()``), its argument bytes and its
    counters."""
    out = []
    for arch, shape in cells:
        cell = steps.build_cell(arch, shape, reduced=True, device="cpu",
                                data_axes=mesh_mod.data_axes(dm))
        sharded = steps.shard_cell(cell, steps.attach_shardings(cell, dm, arch, shape), dm)
        with dryrun.LocalCounter() as counter:
            state, metrics = sharded.step_fn(*sharded.args)
        out.append({
            "loss": float(metrics["loss"]),
            "params": {k: v.full_tensor().detach().numpy()
                       for k, v in tree.paths(state["params"])},
            "argument_bytes": dryrun.arg_bytes(sharded.args),
            "collectives": counter.collectives(),
            "flops": counter.flops,
        })
    return out
