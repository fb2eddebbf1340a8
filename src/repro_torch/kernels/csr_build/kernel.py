"""count_degrees: the ingest degree histogram (paper Alg 5).

``count_degrees`` launches the hand-written CUDA kernel
(``csrc/count_degrees.cu``) for CUDA tensors and uses its plain PyTorch
version, ``count_degrees_torch``, only for CPU tensors.  It replaces the
TPU kernel ``repro/kernels/csr_build/kernel.py::count_degrees_pallas``
(vertex-tile x edge-tile compares); the TPU's pad-to-128 contract is not
carried over.  Out-of-range sources are dropped.
``count_degrees.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

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
