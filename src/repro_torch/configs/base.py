"""Architecture registry and shape sets (the counterpart of
``repro.configs.base``).

Each arch module defines FULL (exact assigned config) and SMOKE (reduced,
CPU one-step testable) and registers itself here.  Shapes are per family
and carried over verbatim.  The port registers all of ``repro``'s ten
archs (the four GNNs, the five LMs and two-tower-retrieval), so
``all_cells`` lists ``repro``'s 40 cells.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

GNN_SHAPES = {
    "full_graph_sm": dict(kind="full", n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": dict(
        kind="sampled",
        n_nodes=232_965,
        n_edges=114_615_892,
        batch_nodes=1024,
        fanout=(15, 10),
    ),
    "ogb_products": dict(
        kind="full", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100
    ),
    "molecule": dict(kind="batched", n_nodes=30, n_edges=64, batch=128),
}

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

FAMILY_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    name: str
    family: str                  # lm | gnn | recsys
    full: Any                    # exact assigned config
    smoke: Any                   # reduced config
    model: str                   # model module key
    skip_shapes: dict = dataclasses.field(default_factory=dict)  # shape -> reason


_REGISTRY: dict[str, ArchEntry] = {}


def register(entry: ArchEntry) -> ArchEntry:
    _REGISTRY[entry.name] = entry
    return entry


def get(name: str) -> ArchEntry:
    _ensure_loaded()
    return _REGISTRY[name]


def all_archs() -> dict[str, ArchEntry]:
    """The registered archs, by name (``repro``'s order)."""
    _ensure_loaded()
    return {name: _REGISTRY[name] for name in sorted(_REGISTRY)}


def all_cells() -> list[tuple[str, str, Optional[str]]]:
    """Every (arch, shape, skip_reason) cell of the registered archs."""
    out = []
    for name, e in all_archs().items():
        for shape in FAMILY_SHAPES[e.family]:
            out.append((name, shape, e.skip_shapes.get(shape)))
    return out


def _ensure_loaded() -> None:
    # every time, not only while the registry is empty: importing one
    # config module first must not hide the others
    from . import (  # noqa: F401
        arctic_480b,
        gcn_cora,
        graphcast,
        h2o_danube_1_8b,
        mace,
        mistral_large_123b,
        qwen2_72b,
        qwen3_moe_235b_a22b,
        schnet,
        two_tower_retrieval,
    )
