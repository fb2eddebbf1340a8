"""Mixture-of-Experts layer: top-k routing with sort-based dispatch (the
counterpart of ``repro.models.transformer.moe``).

Token→expert assignments are sorted by expert (a stable sort), each one's
position within its expert is its rank less the expert's first rank, and
assignments past the expert's capacity are dropped.  The kept ones fill an
``[E·C]`` slot→token index buffer; the experts' SwiGLU runs batched over
``[E, C, D]`` buffers gathered through it, and the gated outputs are added
back into a float32 ``[T, D]`` with ``index_add``.  Capacity is pow-2
bucketed (``core.alloc``), as in ``repro``.

``repro`` writes the buffers with ``.at[slot].set(..., mode="drop")``,
dropped assignments carrying the out-of-bounds slot ``E·C``.  Torch index
writes do not drop out-of-bounds indices, so the buffers here have one
slot more, which takes every dropped write and is cut off: only the kept
slots (each written once) survive, with no host round trip to select them.
The expert products are ``torch.einsum`` (``repro`` computes them outside
any Pallas kernel).  Expert parallelism (``ep_axis``, ``token_axes``) acts
under a mesh (``_sharded_moe``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ...core import alloc
from .. import sharding_utils


def expert_capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    raw = int(n_tokens * top_k * factor / n_experts) + 1
    return alloc.next_pow2(raw)


@dataclasses.dataclass
class Dispatch:
    """The routing of one ``moe_ffn`` call.  The flat assignments are
    token-major (token t's k choices at ``[t·k, t·k + k)``); ``slot``,
    ``keep`` and ``gate`` are in expert-sorted order."""

    probs: torch.Tensor         # [T, E] float32 router softmax
    flat_expert: torch.Tensor   # [T·k] chosen experts, token-major
    slot: torch.Tensor          # [T·k] expert·C + position; E·C = dropped
    keep: torch.Tensor          # [T·k] bool: within the expert's capacity
    gate: torch.Tensor          # [T·k] float32 renormalised gate values
    idx_buf: torch.Tensor       # [E·C] slot -> token; T = an empty slot

    @property
    def dropped(self) -> torch.Tensor:
        """Assignments dropped for capacity (a 0-d int64 tensor)."""
        return (~self.keep).sum()


def dispatch(x: torch.Tensor, router_w: torch.Tensor, *, top_k: int,
             capacity: int) -> Dispatch:
    """Route x [T, D] through router_w [D, E]: softmax in float32, the top
    ``top_k`` experts renormalised, the stable expert sort and the
    capacity mask."""
    t = x.shape[0]
    e = router_w.shape[-1]
    dev = x.device
    logits = x.float() @ router_w.float()                        # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)       # [T, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    flat_expert = gate_idx.reshape(-1)                           # [T*k]
    flat_token = torch.arange(t, device=dev).repeat_interleave(top_k)
    order = torch.argsort(flat_expert, stable=True)
    se, stok, sg = flat_expert[order], flat_token[order], gate_vals.reshape(-1)[order]
    # position within expert = rank - first rank of the expert
    first = torch.searchsorted(se, torch.arange(e, device=dev))
    pos = torch.arange(t * top_k, device=dev) - first[se]
    keep = pos < capacity
    slot = torch.where(keep, se * capacity + pos, e * capacity)  # drop -> the spare slot
    idx_buf = torch.full((e * capacity + 1,), t, dtype=torch.int64, device=dev)
    idx_buf = idx_buf.scatter(0, slot, stok)[:-1]
    return Dispatch(probs, flat_expert, slot, keep, sg, idx_buf)


def moe_ffn(
    x: torch.Tensor,            # [T, D] tokens (flattened batch*seq)
    router_w: torch.Tensor,     # [D, E]
    w1: torch.Tensor,           # [E, D, F]  (gate)
    w3: torch.Tensor,           # [E, D, F]  (up)
    w2: torch.Tensor,           # [E, F, D]  (down)
    *,
    top_k: int,
    capacity: int,
    compute_dtype=torch.bfloat16,
    ep_axis: str = "",          # expert-parallel mesh axis (experts dim)
    token_axes: tuple = (),     # token/batch mesh axes
    tp_axis: str = "",          # the experts' d_ff mesh axis
):
    """Returns (output [T, D] in ``compute_dtype``, aux_loss scalar).

    The mesh axes act only on ``DTensor`` inputs (see ``_sharded_moe``);
    on plain tensors they are no-ops, as ``repro``'s constraints are
    without a mesh.
    """
    if sharding_utils.is_dtensor(x):
        out, aux = _sharded_moe(x, router_w, w1, w3, w2, top_k=top_k, capacity=capacity,
                                compute_dtype=compute_dtype, ep_axis=ep_axis, tp_axis=tp_axis)
        if token_axes:
            out = sharding_utils.constrain(out, tuple(token_axes))
        return out, aux
    gate, slot, idx_buf, aux = _route(x, router_w, top_k, capacity)
    out = _experts(x, gate, slot, idx_buf, w1, w3, w2, capacity=capacity,
                   compute_dtype=compute_dtype, e_lo=0, n_experts=router_w.shape[-1])
    return out.to(compute_dtype), aux


def _route(x, router_w, top_k: int, capacity: int):
    """The dispatch and the load-balancing aux loss (Switch):
    (gate, slot, idx_buf, aux)."""
    t = x.shape[0]
    e = router_w.shape[-1]
    r = dispatch(x, router_w, top_k=top_k, capacity=capacity)
    me = r.probs.mean(dim=0)                                     # [E]
    counts = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, r.flat_expert, torch.ones(r.flat_expert.shape, dtype=torch.float32,
                                     device=x.device))
    aux = e * torch.sum(me * (counts / (t * top_k)))
    return r.gate, r.slot, r.idx_buf, aux


def _experts(x, gate, slot, idx_buf, w1, w3, w2, *, capacity: int, compute_dtype,
             e_lo: int, n_experts: int):
    """The SwiGLU of experts ``[e_lo, e_lo + w1.shape[0])`` over their
    capacity slots, gated and added into a float32 [T, D]."""
    t, d = x.shape
    e_loc = w1.shape[0]
    cd = compute_dtype
    sl = slice(e_lo * capacity, (e_lo + e_loc) * capacity)
    idx = idx_buf[sl]
    live = idx < t
    src = torch.clamp(idx, max=t - 1)
    buffers = torch.where(live[:, None], x.index_select(0, src).to(cd), 0)
    buffers = buffers.reshape(e_loc, capacity, d)

    # expert FFN (SwiGLU), batched over experts
    h1 = torch.einsum("ecd,edf->ecf", buffers, w1.to(cd))
    h3 = torch.einsum("ecd,edf->ecf", buffers, w3.to(cd))
    h = F.silu(h1) * h3
    out_buf = torch.einsum("ecf,efd->ecd", h, w2.to(cd)).reshape(e_loc * capacity, d)

    # combine: the gated slot outputs added into their tokens' rows
    gate_buf = torch.zeros((n_experts * capacity + 1,), dtype=torch.float32, device=x.device)
    gate_buf = gate_buf.scatter(0, slot, gate)[:-1][sl]
    contrib = out_buf * gate_buf[:, None].to(cd)
    return torch.zeros((t, d), dtype=torch.float32, device=x.device).index_add(
        0, src, torch.where(live[:, None], contrib, 0).float())


def _sharded_moe(x, router_w, w1, w3, w2, *, top_k, capacity, compute_dtype, ep_axis,
                 tp_axis):
    """``moe_ffn`` on a mesh: each rank runs its own experts' slice.

    Placement rule: the tokens and the router are all-gathered (repro's
    "one small all-gather of x": routing needs every token, for the
    capacity ranks) and every rank routes them the same way (replicated
    outputs, whose grads are all-reduced); the experts are sharded over
    ``ep_axis`` and their d_ff over ``tp_axis`` (``"model"`` when not
    given), each dropped where it does not divide (the weights are
    redistributed to that rule, a no-op under ``lm_state_sharding``).  Each
    rank gathers its experts' capacity slots from the tokens and adds their
    gated outputs into a float32 [T, D] that is ``Partial(sum)`` on the
    expert and d_ff mesh dims; the caller's constraint reduces it.
    """
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rep = (Replicate(),) * mesh.ndim
    x_r, r_r = x.redistribute(mesh, rep), router_w.redistribute(mesh, rep)
    gate, slot, idx_buf, aux = local_map(
        lambda x_, r_: _route(x_, r_, top_k, capacity), out_placements=(list(rep),) * 4,
        in_placements=(rep, rep), device_mesh=mesh)(x_r, r_r)

    tp = tp_axis or ("model" if "model" in mesh.mesh_dim_names else None)
    ep = ep_axis or None
    up = sharding_utils.spec_to_placements((ep, None, tp), w1.shape, mesh)
    down = sharding_utils.spec_to_placements((ep, tp, None), w2.shape, mesh)
    w1, w3 = (w.redistribute(mesh, up) if tuple(w.placements) != up else w for w in (w1, w3))
    if tuple(w2.placements) != down:
        w2 = w2.redistribute(mesh, down)
    e_lo = sharding_utils.local_offset(w1, 0)
    split = tuple(Partial() if (a.is_shard() or b.is_shard()) else Replicate()
                  for a, b in zip(up, down))
    out = local_map(
        lambda *a: _experts(*a, capacity=capacity, compute_dtype=compute_dtype, e_lo=e_lo,
                            n_experts=router_w.shape[-1]),
        out_placements=list(split), in_placements=(rep, rep, rep, rep, up, up, down),
        in_grad_placements=(split, split, rep, rep, up, up, down),
        device_mesh=mesh)(x_r, gate, slot, idx_buf, w1, w3, w2)
    return out.to(compute_dtype), aux
