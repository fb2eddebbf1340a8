"""Partition-spec rules per architecture family (DESIGN.md §5).

The counterpart of ``repro.launch.shardings``, rule for rule.

LM: FSDP(ZeRO-3) over 'data' + TP over 'model'; pod axis = pure DP
(params replicated across pods, gradients all-reduced).  MoE: experts over
'data' (EP=DP groups), expert d_ff over 'model'.  Decode: batch over (pod,
data), KV-cache sequence over 'model' (context-parallel decode).  GNN:
vertex/edge block-sharding over every axis.  recsys: embedding-table rows
over 'model', batch over (pod, data).

The rules are ``repro``'s ``PartitionSpec``s written as tuples of parts
(``models.sharding_utils``), so they can be held against ``repro``'s spec
by spec.  :func:`tree_spec` maps a rule over a tree (``core.tree``; a leaf's
path joins its keys with ``/``, as ``repro``'s do) to one placement tuple a
leaf, through ``sharding_utils.spec_to_placements`` and its divisibility
guard.  ``repro``'s ``_MOE_HINT`` module global is an explicit ``is_moe``
argument here.  ``mesh`` is a ``DeviceMesh`` or a ``MeshShape``: the rules
read only its axis names and sizes.
"""
from __future__ import annotations

from ..core import tree as tree_mod
from ..models import sharding_utils as su
from . import mesh as mesh_mod


# ---------------------------------------------------------------------------
# LM params
# ---------------------------------------------------------------------------
def lm_param_spec(path: str, mesh, *, is_moe: bool = False) -> tuple:
    fs = "data"  # FSDP axis (within-pod only; pod = pure DP)
    if path.endswith("unembed"):
        return (fs, "model")
    if path.endswith("embed"):
        return ("model", fs)
    leaf = path.split("/")[-1]
    if leaf in ("wq", "wk", "wv"):
        return (None, fs, "model")
    if leaf == "wo":
        return (None, "model", fs)
    if leaf in ("bq", "bk", "bv"):
        return (None, "model")
    if leaf in ("ln1", "ln2"):
        return (None, None)
    if leaf == "ln_f":
        return (None,)
    if leaf == "router":
        return (None, fs, None)
    if leaf in ("w1", "w3"):
        # dense: [L, D, F]; moe: [L, E, D, F]
        return (None, fs, None, "model") if is_moe else (None, fs, "model")
    if leaf == "w2":
        return (None, fs, "model", None) if is_moe else (None, "model", fs)
    if leaf in ("dw1", "dw3"):
        return (None, fs, "model")
    if leaf == "dw2":
        return (None, "model", fs)
    return ()


def tree_spec(tree, rule, mesh):
    """``rule(path, mesh)`` over ``tree``'s leaves: a tree of the same
    structure holding each leaf's placements (one a mesh dim).

    Specs are trimmed to the leaf's rank and any mesh axis that does not
    divide its dim is dropped (that leaf replicates on that axis): the
    divisibility guard that keeps odd sizes (offsets arrays, batch=1
    decode, graph-level labels, host ints) placeable.
    """
    out = [su.spec_to_placements(rule(path, mesh), tuple(getattr(leaf, "shape", ())), mesh)
           for path, leaf in tree_mod.paths(tree)]
    return tree_mod.unflatten(tree, out)


def lm_state_sharding(state, mesh, *, is_moe: bool):
    """Params + optimizer state (m/v follow params; scalars replicated)."""

    def rule(path, mesh):
        if path.endswith("step"):
            return ()
        # strip opt-state prefixes so m/v reuse the param rule
        p = path
        for pre in ("opt_state/m/", "opt_state/v/", "opt_state/f/", "params/"):
            if p.startswith(pre):
                p = p[len(pre):]
        return lm_param_spec(p, mesh, is_moe=is_moe)

    return tree_spec(state, rule, mesh)


def lm_params_sharding(params, mesh, *, is_moe: bool):
    """Bare params (prefill / decode cells)."""
    return tree_spec(params, lambda p, m: lm_param_spec(p, m, is_moe=is_moe), mesh)


def lm_batch_sharding(batch, mesh):
    d = mesh_mod.data_axes(mesh)
    rank = len(tree_mod.leaves(batch)[0].shape)

    def rule(path, mesh):
        # [accum, ubatch, seq] with grad accumulation, else [ubatch, seq]
        return (None, d) if rank == 3 else (d,)

    return tree_spec(batch, rule, mesh)


def lm_infer_batch_sharding(batch, mesh):
    d = mesh_mod.data_axes(mesh)
    return tree_spec(batch, lambda p, m: (d,), mesh)


def lm_cache_sharding(cache, mesh, *, batch: int):
    d = mesh_mod.data_axes(mesh)
    sizes = su.axis_sizes(mesh)
    n_data = 1
    for a in d:
        n_data *= sizes[a]

    def rule(path, mesh):
        if path.endswith("pos"):
            return ()
        # [L, B, Hkv, S, Dh]: batch over data axes when divisible, cache
        # sequence over 'model' (context-parallel decode)
        bspec = d if batch % n_data == 0 else None
        return (None, bspec, None, "model", None)

    return tree_spec(cache, rule, mesh)


# ---------------------------------------------------------------------------
# GNN / recsys
# ---------------------------------------------------------------------------
def gnn_batch_sharding(batch, mesh):
    # node/edge dim over ALL axes (data AND model): GNN params are
    # replicated, so the model axis would otherwise idle (repro's §Perf
    # iteration, graphcast × ogb_products)
    d = mesh_mod.data_axes(mesh) + ("model",)

    def rule(path, mesh):
        leaf = path.split("/")[-1]
        if leaf in ("n_graphs",):
            return ()
        return (d,)  # leading node/edge dim block-sharded

    return tree_spec(batch, rule, mesh)


def gnn_state_sharding(state, mesh):
    # GNN params are small: replicate (grads all-reduce over data axes)
    return tree_spec(state, lambda p, m: (), mesh)


def recsys_state_sharding(state, mesh):
    def rule(path, mesh):
        if path.endswith("table"):
            return ("model", None)  # rows over model axis
        return ()

    return tree_spec(state, rule, mesh)


def recsys_batch_sharding(batch, mesh):
    d = mesh_mod.data_axes(mesh)
    return tree_spec(batch, lambda p, m: (d,), mesh)
