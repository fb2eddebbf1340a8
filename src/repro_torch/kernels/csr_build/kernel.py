"""The ingest degree count (paper Alg 5): two CUDA kernels.

Both replace the TPU kernel
``repro/kernels/csr_build/kernel.py::count_degrees_pallas`` (vertex-tile
x edge-tile compares); the TPU's pad-to-128 contract is not carried over.

* ``degree_offsets`` reads the build's sorted sources and writes the CSR
  offsets ``[n + 1]`` directly, one write per offset at the run boundaries
  (``csrc/count_degrees.cu``).  ``diff`` of its offsets over ``[0, n)`` is
  the TPU kernel's histogram.  The device CSR build runs it.
* ``count_degrees`` is the histogram of raw, unsorted sources (one atomic
  add per in-range source), for callers that hold such sources.
  Out-of-range sources are dropped.

Each wrapper launches its kernel for CUDA tensors and uses its plain
PyTorch version (``*_torch``) only for CPU tensors; its ``launches``
attribute counts kernel launches.  ``degree_offsets_op`` is
``degree_offsets`` as a ``torch.library`` custom op, the form the GNN
segment counts call.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build


def count_degrees_torch(src: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version: scatter-add of ones, in-range sources only."""
    ok = (src >= 0) & (src < n)
    idx = torch.where(ok, src, n).to(torch.int64)
    deg = torch.zeros(n + 1, dtype=torch.int32, device=src.device)
    deg.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return deg[:n]


def count_degrees(src: torch.Tensor, n: int) -> torch.Tensor:
    """Per-vertex histogram of ``src`` [M] int32 over ``n`` vertices."""
    n = int(n)
    if src.device.type == "cpu":
        return count_degrees_torch(src, n)
    _build.require(src, "src", torch.int32, 1)
    if not 0 <= n < 2**31:
        raise ValueError(f"n must fit int32, got {n}")
    deg = torch.empty(n, dtype=torch.int32, device=src.device)
    lib = _build.library()
    _build.check(
        lib.repro_count_degrees(
            src.data_ptr(), src.shape[0], n, deg.data_ptr(), _build.stream(src)
        ),
        "count_degrees",
    )
    count_degrees.launches += 1
    return deg


count_degrees.launches = 0


def degree_offsets_torch(src_s: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version: ``offsets[v]`` = #sources < v, one binary search per
    vertex (``np.searchsorted(src_s, arange(n + 1))`` of the host build)."""
    v = torch.arange(int(n) + 1, dtype=src_s.dtype, device=src_s.device)
    return torch.searchsorted(src_s, v, out_int32=True)


def degree_offsets(src_s: torch.Tensor, n: int) -> torch.Tensor:
    """CSR offsets [n + 1] int32 of sources ``src_s`` [M] int32 sorted
    ascending: ``offsets[v]`` is the number of sources less than ``v``.

    Sources outside ``[0, n)`` make ``offsets[0] != 0`` or
    ``offsets[n] != M``, which the build's range check reads.  The input
    must be sorted; unsorted sources give undefined offsets.
    """
    n = int(n)
    if src_s.device.type == "cpu":
        return degree_offsets_torch(src_s, n)
    _build.require(src_s, "src_s", torch.int32, 1)
    if not 0 <= n < 2**31 - 1:
        raise ValueError(f"n + 1 must fit int32, got n = {n}")
    if src_s.shape[0] >= 2**31:
        raise ValueError(f"M must fit int32, got {src_s.shape[0]}")
    offsets = torch.empty(n + 1, dtype=torch.int32, device=src_s.device)
    lib = _build.library()
    _build.check(
        lib.repro_degree_offsets(
            src_s.data_ptr(), src_s.shape[0], n, offsets.data_ptr(),
            _build.stream(src_s),
        ),
        "degree_offsets",
    )
    degree_offsets.launches += 1
    return offsets


degree_offsets.launches = 0


@torch.library.custom_op("repro_torch::degree_offsets", mutates_args=())
def degree_offsets_op(src_s: torch.Tensor, n: int) -> torch.Tensor:
    """``degree_offsets`` as a custom op (see ``edge_segment_runs_op``):
    its fake body gives [n + 1] int32, its flop formula one step a source."""
    return degree_offsets(src_s, n)


@degree_offsets_op.register_fake
def _(src_s, n):
    return src_s.new_empty((n + 1,), dtype=torch.int32)


@register_flop_formula(torch.ops.repro_torch.degree_offsets)
def _(src_shape, n, out_shape=None, **kwargs) -> int:
    return src_shape[0]
