"""Activation sharding constraints over a ``torch.distributed`` DeviceMesh.

The counterpart of ``repro.models.sharding_utils``.  Models carry optional
mesh axis names in their configs (``shard_axes``, ``batch_axes`` /
``tp_axis``, ``ep_axis`` / ``token_axes``) and pin activations at
``repro``'s call sites with :func:`constrain`.  Where ``repro`` adds a
``with_sharding_constraint`` for GSPMD to propagate, the port redistributes
a ``DTensor`` to the placements the spec names (``x.redistribute``).

A spec is ``repro``'s ``PartitionSpec`` as a tuple of parts, one a tensor
dim: ``None`` (replicated), an axis name, or a tuple of names that shard one
dim over several mesh axes, major to minor (``("pod", "data")``).
:func:`spec_to_placements` maps a spec to one placement a mesh dim (``Shard(d)``
where that mesh axis is in dim ``d``'s part, ``Replicate()`` elsewhere),
after ``repro``'s divisibility guard; ``launch/shardings.py`` maps its
rules with the same function.  A multi-axis part must list its axes in the
mesh's order: DTensor splits a dim over several mesh dims outer to inner,
which is JAX's major-to-minor order only then.

The ambient mesh is :func:`use_mesh` (the counterpart of ``jax.set_mesh``),
a context variable.  With no ambient mesh, or on a tensor that is not a
``DTensor``, :func:`constrain` is a no-op, so model code runs un-meshed.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator

import torch

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices: what the placement
    rules read (a ``DeviceMesh`` offers the same two attributes)."""

    shape: tuple
    mesh_dim_names: tuple


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Make ``mesh`` (a ``DeviceMesh``) the ambient mesh of the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The ambient mesh, or None."""
    return _MESH.get()


def remat_context():
    """``torch.utils.checkpoint``'s ``context_fn``: the recomputation in the
    backward runs under the ambient mesh of the forward (the autograd
    engine may run it on another thread, where the context variable is
    unset)."""
    return contextlib.nullcontext(), use_mesh(_MESH.get())


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or :class:`MeshShape`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def fit_spec(spec, shape, sizes: dict) -> tuple:
    """``spec`` right-padded with None (or trimmed) to ``len(shape)``; a
    falsy part is None, and a part whose axes' product does not divide its
    dim is dropped (the divisibility guard)."""
    nd = len(shape)
    parts = [p if p else None for p in spec]
    parts = (parts + [None] * nd)[:nd]
    fixed = []
    for dim, part in enumerate(parts):
        if part is None:
            fixed.append(None)
            continue
        axes = part if isinstance(part, tuple) else (part,)
        total = 1
        for a in axes:
            total *= sizes[a]
        fixed.append(part if shape[dim] % total == 0 else None)
    return tuple(fixed)


def spec_to_placements(spec, shape, mesh) -> tuple:
    """One placement a mesh dim for a tensor of ``shape`` under ``spec``
    (after :func:`fit_spec`)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, part in enumerate(fit_spec(spec, shape, axis_sizes(mesh))):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"spec part {part!r} must list distinct axes in the mesh's "
                             f"order {names}")
        for i in idx:
            if not out[i].is_replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims in {spec!r}")
            out[i] = Shard(dim)
    return tuple(out)


def placements_to_spec(placements, mesh, ndim: int) -> tuple:
    """The spec a placement tuple stands for: ``ndim`` parts, each None, an
    axis name, or a tuple of names in the mesh's order."""
    parts: list = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, placements):
        if p.is_shard():
            parts[p.dim].append(name)
        elif not p.is_replicate():
            raise ValueError(f"placement {p} on {name!r} has no spec")
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a) for a in parts)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x, *spec_parts):
    """``x`` redistributed to ``spec_parts`` (see :func:`fit_spec`) under
    the ambient mesh; ``x`` itself without one, or when it is not a
    ``DTensor``."""
    mesh = _MESH.get()
    if mesh is None or not is_dtensor(x):
        return x
    placements = spec_to_placements(spec_parts, x.shape, x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def maybe_constrain(x, axes, *rest):
    """Constrain dim 0 to ``axes`` (a tuple of mesh axis names) when given."""
    if not axes:
        return x
    return constrain(x, tuple(axes), *rest)


def local_offset(x, dim: int) -> int:
    """The global index of this rank's first element of ``x`` (a DTensor)
    along tensor dim ``dim``: the rank's coordinate on each mesh dim that
    shards ``dim``, outer to inner, times the local size."""
    mesh = x.device_mesh
    coord = 0
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            coord = coord * mesh.size(i) + mesh.get_local_rank(i)
    return coord * x.to_local().shape[dim]


def requires_even(x, dim: int, what: str) -> None:
    """Raise unless every mesh dim that shards ``x`` along ``dim`` divides it
    (an uneven shard breaks the site's local offsets)."""
    total = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            total *= x.device_mesh.size(i)
    if x.shape[dim] % total:
        raise ValueError(f"{what}: dim {dim} of {tuple(x.shape)} does not split evenly "
                         f"over {total} ranks")


def no_grad_local(x) -> torch.Tensor:
    """This rank's shard of a DTensor that records no grad (integer ids),
    the same tensor object on every call, so caches keyed on it hold."""
    with torch.no_grad():
        return x.to_local()
