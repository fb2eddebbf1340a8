"""Rank programs of ``tests/test_torch_sharding.py`` (imported by the
spawned ranks, so it imports neither ``jax`` nor ``repro``)."""
import torch

from repro_torch.core import tree
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.transformer import model

#: the real mesh of the 4 CPU ranks
MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")


def row_parallel_inputs():
    """A bfloat16 [4, 8, 64] activation and [64, 32] weight from seed 0."""
    g = torch.Generator().manual_seed(0)
    return (torch.randn(4, 8, 64, generator=g).to(torch.bfloat16),
            torch.randn(64, 32, generator=g).to(torch.bfloat16))


def rank_runs(rank_mesh, cells):
    """This rank's records: ``rank_cells`` and ``rank_row_parallel``."""
    dm = mesh_mod.make_mesh_like(MESH_SHAPE, MESH_AXES, device_type="cpu")
    return {"cells": rank_cells(dm, cells), "row_parallel": rank_row_parallel(dm)}


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
