"""Build, load and call the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source (which may include a ``csrc/*.cuh`` header) is
compiled by ``nvcc`` for ``sm_90a`` (one process per source, all started
together) and linked into one shared library with a plain C interface,
loaded through ``ctypes``.  The build runs at the first CUDA launch of the
process, goes into ``build/`` at the root of the checkout, and is keyed by
a hash of the sources, headers and flags, so a fresh checkout builds once
and an edited source rebuilds.

Each C entry point launches on the caller's stream, allocates nothing, and
returns ``cudaGetLastError()``; ``check`` turns a non-zero status into an
exception.  Nothing here falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: ``<checkout>/build`` (this file is ``<checkout>/src/repro_torch/kernels/``)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
LIB_NAME = "librepro_torch_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: C entry points and their argument types (pointers and the stream as
#: c_void_p, sizes as c_int / c_longlong, scales as c_float; every entry
#: returns an int status)
SIGNATURES = {
    "repro_tile_cumsum": (_P, _P, _L, _P),
    "repro_count_degrees": (_P, _L, _I, _P, _P),
    "repro_merge_rows": (_P, _P, _P, _P, _P, _P, _L, _I, _I,
                         _P, _P, _P, _P, _I, _P),
    "repro_slot_walk_partials": (_P, _P, _L, _L, _I, _P, _P, _P),
    "repro_bsr_spmm": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "repro_edge_segment_partials": (_P, _P, _L, _I, _I, _P, _P, _P),
    "repro_embedding_bag": (_P, _P, _P, _L, _I, _L, _I, _I, _P, _P),
    "repro_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                              _I, _P),
    "repro_flash_attention_path": (_P, _P, _P, _P, _I, _I, _I),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources, lib_path: Path) -> None:
    nvcc = _nvcc()
    tmp = lib_path.parent.with_name(f"{lib_path.parent.name}.tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        objs = [tmp / f"{s.stem}.o" for s in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
            for s, o in zip(sources, objs)
        ]
        errors = []
        for s, p in zip(sources, procs):
            out, _ = p.communicate()
            if p.returncode:
                errors.append(f"{s.name}:\n{out.decode(errors='replace')}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        linked = tmp / LIB_NAME
        subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(linked), *map(str, objs)],
            check=True, capture_output=True,
        )
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        os.replace(linked, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first use."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    lib_path = BUILD_DIR / f"kernels-{_digest(sources + headers)}" / LIB_NAME
    if not lib_path.exists():
        _compile(sources, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = (_I,)
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status:
        msg = library().repro_cuda_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status}: {msg}")


def stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Validate a kernel operand: CUDA, dtype, rank, contiguity."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
