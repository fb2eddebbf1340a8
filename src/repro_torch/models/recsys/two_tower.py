"""Two-tower retrieval (Yi et al., RecSys'19): the serving path.

The counterpart of ``repro.models.recsys.two_tower``.  Each tower pools its
sparse feature fields with EmbeddingBag (``combine="mean"``, the
``embedding_bag`` CUDA kernel on the card), runs the MLP and
L2-normalises.  Serving scores user-item pairs (``serve_step``) or one
query against many candidates with one matrix product
(``score_candidates``).

Dynamic-graph tie-in (DESIGN.md §4): the user→item interaction graph is a
DiGraph and the per-user history bags are its adjacency rows.

The MLP products are ``torch.matmul`` in float32 (``repro`` leaves them to
XLA, outside any Pallas kernel); callers that compare against a reference
keep TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``, the
default).  The bag kernel has no backward: the loss and training are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ...core import util
from ...kernels.embedding_bag import ops as bag_ops


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    """``repro``'s ``TwoTowerConfig`` less what serving never reads: the
    softmax ``temperature`` (training), ``shard_axes`` (the mesh) and
    ``interaction`` (always a dot product); ``use_kernel`` is ``backend``."""
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: Sequence[int] = (1024, 512, 256)
    n_users: int = 10_000_000
    n_items: int = 10_000_000
    n_user_fields: int = 4       # multi-hot history bags per user example
    n_item_fields: int = 2
    bag_size: int = 16           # indices per field (pow-2)
    backend: str = "auto"        # bag kernel: "auto" | "cuda" | "torch"


def _tower_shapes(cfg: TwoTowerConfig, vocab: int, n_fields: int):
    sizes = [n_fields * cfg.embed_dim, *cfg.tower_mlp]
    return {
        "table": (vocab, cfg.embed_dim),
        "mlp": [(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)],
    }


class Tower(nn.Module):
    """One tower: a [vocab, embed_dim] table and an MLP whose weights are
    stored [in, out], as ``repro`` stores them (``x @ w + b``)."""

    def __init__(self, table: torch.Tensor, mlp, cfg: TwoTowerConfig):
        super().__init__()
        self.cfg = cfg
        self.table = nn.Parameter(table, requires_grad=False)
        self.w = nn.ParameterList([nn.Parameter(w, requires_grad=False) for w, _ in mlp])
        self.b = nn.ParameterList([nn.Parameter(b, requires_grad=False) for _, b in mlp])

    def forward(self, bags: torch.Tensor) -> torch.Tensor:
        return tower_forward(self, bags, self.cfg)


def pool_fields(tower: Tower, bags: torch.Tensor, cfg: TwoTowerConfig) -> torch.Tensor:
    """bags [B, n_fields, K] int32 (-1 pad) -> [B, n_fields * embed_dim]:
    each field's bag mean-pooled through the ``embedding_bag`` op."""
    b, nf, k = bags.shape
    pooled = bag_ops.embedding_bag(tower.table, bags.reshape(b * nf, k),
                                   combine="mean", backend=cfg.backend)
    return pooled.reshape(b, nf * cfg.embed_dim)


def mlp_head(tower: Tower, x: torch.Tensor) -> torch.Tensor:
    """The tower's MLP (ReLU between layers), then L2 normalisation."""
    n = len(tower.w)
    for i, (w, bias) in enumerate(zip(tower.w, tower.b)):
        x = x @ w + bias
        if i < n - 1:
            x = torch.relu(x)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)


def tower_forward(tower: Tower, bags: torch.Tensor, cfg: TwoTowerConfig) -> torch.Tensor:
    """bags [B, n_fields, K] int32 (-1 pad) -> [B, embed_dim] normalised."""
    return mlp_head(tower, pool_fields(tower, bags, cfg))


class TwoTower(nn.Module):
    def __init__(self, user: Tower, item: Tower, cfg: TwoTowerConfig):
        super().__init__()
        self.cfg = cfg
        self.user = user
        self.item = item

    def with_backend(self, backend: str) -> "TwoTower":
        """A model on the same weights (shared, not copied) whose bags go
        through ``backend`` ("torch" is the plain reference on the card)."""
        cfg = dataclasses.replace(self.cfg, backend=backend)

        def tower(t: Tower) -> Tower:
            return Tower(t.table, list(zip(t.w, t.b)), cfg)

        return TwoTower(tower(self.user), tower(self.item), cfg)

    @torch.no_grad()
    def serve_step(self, batch) -> torch.Tensor:
        """Online/bulk inference: {user_bags [B,nf_u,K], item_bags [B,nf_i,K]}
        -> [B] pair scores."""
        u = self.user(batch["user_bags"])
        v = self.item(batch["item_bags"])
        return (u * v).sum(dim=-1)

    @torch.no_grad()
    def score_candidates(self, user_bags: torch.Tensor,
                         cand_bags: torch.Tensor) -> torch.Tensor:
        """One query [1,nf_u,K] against C candidates [C,nf_i,K] -> [C]
        scores, one matrix product."""
        u = self.user(user_bags)  # [1, D]
        v = self.item(cand_bags)  # [C, D]
        return (u @ v.T)[0]


def init_model(cfg: TwoTowerConfig, *, generator: torch.Generator,
               device="cuda") -> TwoTower:
    """Random weights as ``repro``'s ``init_params`` draws them (tables
    N(0,1)·0.01, weights N(0,1)/sqrt(fan_in), zero biases), from
    ``generator`` (on ``device``), on ``device``."""
    dev = util.resolve_device(device)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev).mul_(scale)

    def tower(vocab, n_fields):
        sh = _tower_shapes(cfg, vocab, n_fields)
        table = normal(sh["table"], 0.01)
        mlp = [(normal(s, 1.0 / s[0] ** 0.5),
                torch.zeros(s[1], dtype=torch.float32, device=dev)) for s in sh["mlp"]]
        return Tower(table, mlp, cfg)

    return TwoTower(tower(cfg.n_users, cfg.n_user_fields),
                    tower(cfg.n_items, cfg.n_item_fields), cfg)


def from_jax_params(params_np, cfg: TwoTowerConfig, *, device="cuda") -> TwoTower:
    """A model holding ``repro``'s ``init_params`` pytree, given as numpy
    arrays ({"user"|"item": {"table", "mlp": [{"w", "b"}]}})."""
    dev = util.resolve_device(device)

    def t(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)

    def tower(tp):
        return Tower(t(tp["table"]), [(t(lp["w"]), t(lp["b"])) for lp in tp["mlp"]], cfg)

    return TwoTower(tower(params_np["user"]), tower(params_np["item"]), cfg)
