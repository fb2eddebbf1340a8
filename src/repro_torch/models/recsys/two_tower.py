"""Two-tower retrieval (Yi et al., RecSys'19): sampled-softmax retrieval.

The counterpart of ``repro.models.recsys.two_tower``.  Each tower pools its
sparse feature fields with EmbeddingBag (``combine="mean"``, the
``embedding_bag`` CUDA kernel on the card), runs the MLP and
L2-normalises.  Training: in-batch sampled softmax with logQ correction
(``loss_fn``; the bag's backward is plain PyTorch).  Serving scores
user-item pairs (``serve_step``) or one query against many candidates
with one matrix product (``score_candidates``).

The model is functions over ``repro``'s parameter tree (``{"user"|"item":
{"table", "mlp": [{"w", "b"}]}}``, weights [in, out], ``x @ w + b``), so a
train state's keys are ``repro``'s; ``TwoTower`` holds one as an
``nn.Module`` for serving and runs the same functions.

Dynamic-graph tie-in (DESIGN.md §4): the user→item interaction graph is a
DiGraph and the per-user history bags are its adjacency rows.

The MLP products are ``torch.matmul`` in float32 (``repro`` leaves them to
XLA, outside any Pallas kernel); callers that compare against a reference
keep TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``, the
default).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ...core import util
from ...kernels.embedding_bag import ops as bag_ops
from ..param_tree import ParamTree, tensors_from_numpy


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    """``repro``'s ``TwoTowerConfig``; ``use_kernel`` is ``backend``.
    ``shard_axes`` (batch sharding constraints) comes with the mesh and
    must stay empty."""
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: Sequence[int] = (1024, 512, 256)
    interaction: str = "dot"
    shard_axes: tuple = ()       # mesh axes for the batch dim (not ported)
    n_users: int = 10_000_000
    n_items: int = 10_000_000
    n_user_fields: int = 4       # multi-hot history bags per user example
    n_item_fields: int = 2
    bag_size: int = 16           # indices per field (pow-2)
    temperature: float = 0.05
    backend: str = "auto"        # bag kernel: "auto" | "cuda" | "torch"

    def __post_init__(self):
        if self.shard_axes:
            raise NotImplementedError(
                "shard_axes: sharding constraints come with model sharding over a "
                "DeviceMesh (ROADMAP.md §1 item 6)")


def _tower_shapes(cfg: TwoTowerConfig, vocab: int, n_fields: int):
    sizes = [n_fields * cfg.embed_dim, *cfg.tower_mlp]
    return {
        "table": (vocab, cfg.embed_dim),
        "mlp": [(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)],
    }


def init_params(cfg: TwoTowerConfig, *, generator: torch.Generator, device) -> dict:
    """Random weights as ``repro``'s ``init_params`` draws them (tables
    N(0,1)·0.01, weights N(0,1)/sqrt(fan_in), zero biases), from
    ``generator`` (on ``device``), on ``device``."""
    dev = util.resolve_device(device)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev).mul_(scale)

    def tower(vocab, n_fields):
        sh = _tower_shapes(cfg, vocab, n_fields)
        return {"table": normal(sh["table"], 0.01),
                "mlp": [{"w": normal(s, 1.0 / s[0] ** 0.5),
                         "b": torch.zeros(s[1], dtype=torch.float32, device=dev)}
                        for s in sh["mlp"]]}

    return {"user": tower(cfg.n_users, cfg.n_user_fields),
            "item": tower(cfg.n_items, cfg.n_item_fields)}


def pool_fields(tp: dict, bags: torch.Tensor, cfg: TwoTowerConfig) -> torch.Tensor:
    """bags [B, n_fields, K] int32 (-1 pad) -> [B, n_fields * embed_dim]:
    each field's bag mean-pooled through the ``embedding_bag`` op."""
    b, nf, k = bags.shape
    pooled = bag_ops.embedding_bag(tp["table"], bags.reshape(b * nf, k),
                                   combine="mean", backend=cfg.backend)
    return pooled.reshape(b, nf * cfg.embed_dim)


def mlp_head(tp: dict, x: torch.Tensor) -> torch.Tensor:
    """The tower's MLP (ReLU between layers), then L2 normalisation."""
    n = len(tp["mlp"])
    for i, lp in enumerate(tp["mlp"]):
        x = x @ lp["w"] + lp["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)


def tower_forward(tp: dict, bags: torch.Tensor, cfg: TwoTowerConfig) -> torch.Tensor:
    """bags [B, n_fields, K] int32 (-1 pad) -> [B, embed_dim] normalised."""
    return mlp_head(tp, pool_fields(tp, bags, cfg))


def loss_fn(params: dict, batch, cfg: TwoTowerConfig):
    """In-batch sampled softmax with logQ correction.

    batch: {user_bags [B,nf,K], item_bags [B,nf,K], item_logq [B]}.
    """
    u = tower_forward(params["user"], batch["user_bags"], cfg)
    v = tower_forward(params["item"], batch["item_bags"], cfg)
    logits = (u @ v.T) / cfg.temperature                  # [B, B]
    logits = logits - batch["item_logq"][None, :]          # logQ correction
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.diagonal(logits)
    ce = (lse - gold).mean()
    return ce, {"ce": ce}


def score_candidates(params: dict, user_bags, cand_bags, cfg: TwoTowerConfig):
    """retrieval_cand shape: 1 query × n_candidates — one matrix product."""
    u = tower_forward(params["user"], user_bags, cfg)        # [1, D]
    v = tower_forward(params["item"], cand_bags, cfg)        # [C, D]
    return (u @ v.T)[0]                                      # [C]


def serve_step(params: dict, batch, cfg: TwoTowerConfig):
    """Online/bulk inference: score user-item pairs."""
    u = tower_forward(params["user"], batch["user_bags"], cfg)
    v = tower_forward(params["item"], batch["item_bags"], cfg)
    return torch.sum(u * v, dim=-1)


class TwoTower(ParamTree):
    """A parameter tree and its config, served under ``torch.no_grad``."""

    def __init__(self, params: dict, cfg: TwoTowerConfig):
        super().__init__(params)
        self.cfg = cfg

    def with_backend(self, backend: str) -> "TwoTower":
        """A model on the same weights (shared, not copied) whose bags go
        through ``backend`` ("torch" is the plain reference on the card)."""
        return TwoTower(self.tree(), dataclasses.replace(self.cfg, backend=backend))

    @torch.no_grad()
    def serve_step(self, batch) -> torch.Tensor:
        """{user_bags [B,nf_u,K], item_bags [B,nf_i,K]} -> [B] pair scores."""
        return serve_step(self.tree(), batch, self.cfg)

    @torch.no_grad()
    def score_candidates(self, user_bags: torch.Tensor,
                         cand_bags: torch.Tensor) -> torch.Tensor:
        """One query [1,nf_u,K] against C candidates [C,nf_i,K] -> [C]."""
        return score_candidates(self.tree(), user_bags, cand_bags, self.cfg)


def init_model(cfg: TwoTowerConfig, *, generator: torch.Generator,
               device="cuda") -> TwoTower:
    """A model of ``init_params``' weights."""
    return TwoTower(init_params(cfg, generator=generator, device=device), cfg)


def from_jax_params(params_np, cfg: TwoTowerConfig, *, device="cuda") -> TwoTower:
    """A model holding ``repro``'s ``init_params`` tree, given as numpy
    arrays ({"user"|"item": {"table", "mlp": [{"w", "b"}]}})."""
    return TwoTower(tensors_from_numpy(params_np, torch.float32, device=device), cfg)
