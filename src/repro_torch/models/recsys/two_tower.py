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
from .. import sharding_utils as su
from ..param_tree import ParamTree, tensors_from_numpy


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    """``repro``'s ``TwoTowerConfig``; ``use_kernel`` is ``backend``."""
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: Sequence[int] = (1024, 512, 256)
    interaction: str = "dot"
    shard_axes: tuple = ()       # mesh axes for the batch dim
    n_users: int = 10_000_000
    n_items: int = 10_000_000
    n_user_fields: int = 4       # multi-hot history bags per user example
    n_item_fields: int = 2
    bag_size: int = 16           # indices per field (pow-2)
    temperature: float = 0.05
    backend: str = "auto"        # bag kernel: "auto" | "cuda" | "torch"


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
    ids = bags.reshape(b * nf, k)
    if su.is_dtensor(tp["table"]):
        pooled = _sharded_mean_bag(tp["table"], ids, cfg.backend)
    else:
        pooled = bag_ops.embedding_bag(tp["table"], ids, combine="mean", backend=cfg.backend)
    return pooled.reshape(b, nf * cfg.embed_dim)


def _sharded_mean_bag(table, ids, backend: str):
    """The mean bag on each rank's own table rows (``local_map``).

    Placement rule: the table's rows are sharded over a set of mesh dims
    (``launch.shardings.recsys_state_sharding``: ``"model"``) and the bags
    over others (the data axes), disjoint; everything else replicated.
    Each rank sums the ids that fall in its rows (the ``embedding_bag``
    kernel, ``combine="sum"``, the others masked to -1) and divides by the
    bag's global count of valid ids, so the output is ``Partial(sum)`` on
    the table's dims and sharded as the bags elsewhere; the table's grad is
    ``Partial(sum)`` on the bags' dims (each rank's bags add to it).  An id >= V reads
    row V-1, as the unsharded bag does.  Any other placement raises.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    if not su.is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    out_pl, grad_pl = [], []
    for i, (tp_, ip_) in enumerate(zip(table.placements, ids.placements)):
        if tp_.is_shard(0) and ip_.is_replicate():
            out_pl.append(Partial())
            grad_pl.append(tp_)
        elif tp_.is_replicate() and (ip_.is_replicate() or ip_.is_shard(0)):
            out_pl.append(ip_ if ip_.is_replicate() else Shard(0))
            # the table's grad from this rank's bags only
            grad_pl.append(ip_ if ip_.is_replicate() else Partial())
        else:
            raise ValueError(f"embedding_bag: table {table.placements} and bags "
                             f"{ids.placements} do not fit the row/bag rule on mesh dim {i}")
    su.requires_even(table, 0, "embedding_bag table")
    lo, vocab = su.local_offset(table, 0), table.shape[0]

    def site(table_l, ids_l):
        valid = ids_l >= 0
        gid = torch.clamp(ids_l, max=vocab - 1) - lo
        mine = valid & (gid >= 0) & (gid < table_l.shape[0])
        local = torch.where(mine, gid, -1).to(torch.int32)
        s = bag_ops.embedding_bag(table_l, local, combine="sum", backend=backend)
        return s / torch.clamp(valid.sum(dim=1, keepdim=True), min=1)

    return local_map(site, out_placements=list(out_pl),
                     in_placements=(tuple(table.placements), tuple(ids.placements)),
                     in_grad_placements=(tuple(grad_pl), tuple(ids.placements)),
                     device_mesh=mesh)(table, ids)


def mlp_head(tp: dict, x: torch.Tensor, shard_axes: tuple = ()) -> torch.Tensor:
    """The tower's MLP (ReLU between layers), then L2 normalisation; the
    input and the output constrained to ``shard_axes`` under a mesh."""
    x = su.maybe_constrain(x, shard_axes)
    n = len(tp["mlp"])
    for i, lp in enumerate(tp["mlp"]):
        x = x @ lp["w"] + lp["b"]
        if i < n - 1:
            x = torch.relu(x)
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)
    return su.maybe_constrain(x, shard_axes)


def tower_forward(tp: dict, bags: torch.Tensor, cfg: TwoTowerConfig) -> torch.Tensor:
    """bags [B, n_fields, K] int32 (-1 pad) -> [B, embed_dim] normalised."""
    return mlp_head(tp, pool_fields(tp, bags, cfg), cfg.shard_axes)


def loss_fn(params: dict, batch, cfg: TwoTowerConfig):
    """In-batch sampled softmax with logQ correction.

    batch: {user_bags [B,nf,K], item_bags [B,nf,K], item_logq [B]}.
    """
    u = tower_forward(params["user"], batch["user_bags"], cfg)
    v = tower_forward(params["item"], batch["item_bags"], cfg)
    logits = (u @ v.T) / cfg.temperature                  # [B, B]
    logits = logits - batch["item_logq"][None, :]          # logQ correction
    lse = torch.logsumexp(logits, dim=-1)
    gold = _sharded_diagonal(logits) if su.is_dtensor(logits) else torch.diagonal(logits)
    ce = (lse - gold).mean()
    return ce, {"ce": ce}


def _sharded_diagonal(logits):
    """The diagonal of [B, B] logits (a DTensor) on each rank's rows
    (``local_map``; DTensor has no rule for the diagonal's backward).

    Placement rule: rows sharded (``Shard(0)``) or replicated on each mesh
    dim, the columns whole (a redistribute where they are sharded); each
    rank takes the diagonal of its row block, so the output is placed as
    the rows.
    """
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    pl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in logits.placements)
    if tuple(logits.placements) != pl:
        logits = logits.redistribute(mesh, pl)
    su.requires_even(logits, 0, "diagonal")
    lo = su.local_offset(logits, 0)
    return local_map(lambda lg: torch.diagonal(lg[:, lo:lo + lg.shape[0]]),
                     out_placements=list(pl), in_placements=(pl,),
                     device_mesh=mesh)(logits)


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
