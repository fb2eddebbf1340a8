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
any Pallas kernel).  Expert parallelism (``ep_axis``, ``token_axes``) comes
with the mesh.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ...core import alloc


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
    ep_axis: str = "",          # expert-parallel mesh axis (not ported)
    token_axes: tuple = (),     # token/batch mesh axes (not ported)
):
    """Returns (output [T, D] in ``compute_dtype``, aux_loss scalar)."""
    if ep_axis or token_axes:
        raise NotImplementedError(
            "moe_ffn: expert parallelism (ep_axis, token_axes) comes with model sharding "
            "over a DeviceMesh (ROADMAP.md §1 item 6)")
    t, d = x.shape
    e = router_w.shape[-1]
    cd = compute_dtype
    r = dispatch(x, router_w, top_k=top_k, capacity=capacity)
    live = r.idx_buf < t
    src = torch.clamp(r.idx_buf, max=t - 1)
    buffers = torch.where(live[:, None], x.index_select(0, src).to(cd), 0)
    buffers = buffers.reshape(e, capacity, d)

    # expert FFN (SwiGLU), batched over experts
    h1 = torch.einsum("ecd,edf->ecf", buffers, w1.to(cd))
    h3 = torch.einsum("ecd,edf->ecf", buffers, w3.to(cd))
    h = F.silu(h1) * h3
    out_buf = torch.einsum("ecf,efd->ecd", h, w2.to(cd)).reshape(e * capacity, d)

    # combine: the gated slot outputs added into their tokens' rows
    gate_buf = torch.zeros((e * capacity + 1,), dtype=torch.float32, device=x.device)
    gate_buf = gate_buf.scatter(0, r.slot, r.gate)[:-1]
    contrib = out_buf * gate_buf[:, None].to(cd)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device).index_add(
        0, src, torch.where(live[:, None], contrib, 0).float())

    # load-balancing aux loss (Switch)
    me = r.probs.mean(dim=0)                                     # [E]
    ce = torch.bincount(r.flat_expert, minlength=e).float() / (t * top_k)
    aux = e * torch.sum(me * ce)
    return out.to(cd), aux
