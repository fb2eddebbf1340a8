"""Synthetic graph generators: RMAT (power-law, web-graph-like), uniform
(Erdős–Rényi-ish) and road-like low-degree graphs — covering the paper's
dataset families (web / social / road / k-mer).

The generators are ``repro.io.synthetic``'s numpy code: the same seed gives
the same graph in both packages.
"""
from __future__ import annotations

import numpy as np

from ..core import csr as csr_mod
from ..core import edgebatch


def rmat_edges(
    rng: np.random.Generator,
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> tuple[np.ndarray, np.ndarray]:
    """RMAT generator (Graph500 parameters by default)."""
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        r = rng.random(m)
        # quadrant probabilities a,b,c,d
        src_bit = r >= a + b
        dst_bit = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    return src, dst


def uniform_edges(
    rng: np.random.Generator, n: int, m: int
) -> tuple[np.ndarray, np.ndarray]:
    return (
        rng.integers(0, n, size=m, dtype=np.int64),
        rng.integers(0, n, size=m, dtype=np.int64),
    )


def road_like_edges(
    rng: np.random.Generator, n: int, avg_degree: float = 2.1
) -> tuple[np.ndarray, np.ndarray]:
    """Low-degree, high-diameter chain + shortcuts (asia_osm-style)."""
    chain_src = np.arange(n - 1, dtype=np.int64)
    chain_dst = chain_src + 1
    extra = int(n * max(avg_degree - 2.0, 0.05))
    esrc = rng.integers(0, n, size=extra, dtype=np.int64)
    off = rng.integers(1, 10, size=extra, dtype=np.int64)
    edst = np.minimum(esrc + off, n - 1)
    return (
        np.concatenate([chain_src, esrc]),
        np.concatenate([chain_dst, edst]),
    )


def make_coo(
    kind: str,
    *,
    scale: int = 10,
    edge_factor: int = 8,
    seed: int = 0,
    weighted: bool = True,
    symmetric: bool = True,
):
    """The raw COO behind ``make_graph``: (src, dst, wgt or None, n)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    if kind == "web":
        src, dst = rmat_edges(rng, scale, edge_factor, 0.57, 0.19, 0.19)
    elif kind == "social":
        src, dst = rmat_edges(rng, scale, edge_factor, 0.45, 0.25, 0.15)
    elif kind == "road":
        src, dst = road_like_edges(rng, n)
    elif kind == "uniform":
        src, dst = uniform_edges(rng, n, n * edge_factor)
    else:
        raise ValueError(f"unknown graph kind {kind!r}")
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    wgt = rng.uniform(0.5, 1.5, size=src.shape[0]).astype(np.float32) if weighted else None
    return src, dst, wgt, n


def make_graph(kind: str, *, scale: int = 10, edge_factor: int = 8,
               seed: int = 0, weighted: bool = True, symmetric: bool = True,
               device="cuda") -> csr_mod.CSR:
    """Named dataset families as a deduplicated CSR on ``device``."""
    src, dst, wgt, n = make_coo(
        kind, scale=scale, edge_factor=edge_factor, seed=seed,
        weighted=weighted, symmetric=symmetric,
    )
    return csr_mod.from_coo(src, dst, wgt, n=n, device=device)


def update_batches(
    csr: csr_mod.CSR,
    *,
    fractions=(1e-4, 1e-3, 1e-2, 1e-1),
    seed: int = 1,
    kind: str = "insert",
):
    """Paper §4.2.3/4: random batches sized as fractions of |E|."""
    rng = np.random.default_rng(seed)
    out = []
    for f in fractions:
        count = max(int(round(csr.m * f)), 1)
        if kind == "insert":
            out.append((f, edgebatch.random_insertions(rng, csr.n, count)))
        else:
            out.append((f, edgebatch.random_deletions(rng, csr, count)))
    return out
