"""Unified decoder-only LM (the counterpart of
``repro.models.transformer.model``): GQA / SWA / QKV-bias / MoE (+dense
residual), RoPE, RMSNorm, SwiGLU; per-layer remat.

The model is functions over ``repro``'s parameter tree: ``embed``,
``layers`` (each weight stacked on a leading layer axis, ``[L, ...]``),
``ln_f`` and ``unembed``, stored [in, out] (``x @ w``) in ``param_dtype``.
So a train state's keys and shapes are ``repro``'s and its checkpoints
cross the packages.  ``forward`` (prefill: logits for every position),
``loss_fn`` (training) and ``decode_step`` (one token per sequence against
a KV cache) take the tree; ``TransformerLM`` holds one as an ``nn.Module``
for serving and runs the same functions.

Each forward unbinds the stacked weights once (one view a layer, whose
backward stacks the layers' grads in one op) and loops over the layers in
Python where ``repro`` scans.  Weights are cast to ``compute_dtype`` per
layer and per call, so no second copy of the model is held; the
embedding is cast, then gathered, as in ``repro``.  ``remat=True`` runs
each layer under ``torch.utils.checkpoint`` (non-reentrant) when grads
are recorded: only the layer inputs are kept and each layer is recomputed
in the backward, the counterpart of ``jax.checkpoint(nothing_saveable)``.
Attention goes through ``attention.attention`` with the config's
``attn_impl`` and ``backend`` (``"flash"`` is the ``flash_attention`` CUDA
kernel on the card, forward only).  Under a mesh the activations are pinned
where ``repro`` pins them (``batch_axes`` / ``tp_axis``: the layer
boundary, after attention, the logits) and attention runs on each rank's
heads (``attention.attention``).  Decode writes each new K/V slot into
the cache in place (``index_copy_``), where ``repro`` updates a donated
buffer with ``dynamic_update_slice``.  The projections and the FFN are
plain ``torch.matmul`` (``repro`` leaves them to XLA).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...core import alloc, util
from .. import sharding_utils as su
from ..param_tree import ParamTree, tensors_from_numpy
from . import attention as attn_mod
from . import moe as moe_mod
from .config import TransformerConfig

Params = dict


def rms_norm(x, w, eps):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def _layer_param_shapes(cfg: TransformerConfig) -> dict[str, tuple]:
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    shapes = {
        "wq": (d, hq * dh),
        "wk": (d, hkv * dh),
        "wv": (d, hkv * dh),
        "wo": (hq * dh, d),
        "ln1": (d,),
        "ln2": (d,),
    }
    if cfg.qkv_bias:
        shapes |= {"bq": (hq * dh,), "bk": (hkv * dh,), "bv": (hkv * dh,)}
    if cfg.moe is None:
        shapes |= {"w1": (d, cfg.d_ff), "w3": (d, cfg.d_ff), "w2": (cfg.d_ff, d)}
    else:
        m = cfg.moe
        shapes |= {
            "router": (d, m.n_experts),
            "w1": (m.n_experts, d, m.d_ff_expert),
            "w3": (m.n_experts, d, m.d_ff_expert),
            "w2": (m.n_experts, m.d_ff_expert, d),
        }
        if m.dense_residual_ff:
            shapes |= {
                "dw1": (d, m.dense_residual_ff),
                "dw3": (d, m.dense_residual_ff),
                "dw2": (m.dense_residual_ff, d),
            }
    return shapes


def param_shapes(cfg: TransformerConfig) -> Params:
    """Every parameter as a meta tensor of its shape and ``param_dtype``
    (``repro``'s tree of ShapeDtypeStructs)."""
    def meta(shape):
        return torch.empty(shape, dtype=cfg.param_dtype, device="meta")

    out = {
        "embed": meta((cfg.vocab, cfg.d_model)),
        "layers": {k: meta((cfg.n_layers, *s)) for k, s in _layer_param_shapes(cfg).items()},
        "ln_f": meta((cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = meta((cfg.d_model, cfg.vocab))
    return out


def init_params(cfg: TransformerConfig, *, generator: torch.Generator, device) -> Params:
    """Random weights as ``repro``'s ``init_params`` draws them (matrices
    N(0,1)/sqrt(fan_in) with fan_in the second-to-last dim, norms 1, biases
    0), from ``generator`` (on ``device``), on ``device``.  A stacked leaf
    is drawn one [fan_in, out] matrix at a time in float32 and cast into
    its ``param_dtype`` tensor, so no float32 copy of a bfloat16 leaf is
    held (arctic's experts: 17.8 GB).  Under a ``FakeTensorMode`` (the dry
    run) a matrix is an empty fake of its shape: nothing is drawn."""
    from torch._guards import detect_fake_mode

    dev = util.resolve_device(device)
    abstract = detect_fake_mode() is not None

    def draw(name, s):
        if name in ("ln1", "ln2", "ln_f"):
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        if name in ("bq", "bk", "bv"):
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        out = torch.empty(s.shape, dtype=s.dtype, device=dev)
        if abstract:
            return out
        mats = out.reshape(-1, *s.shape[-2:])
        for m in mats:
            w = torch.randn(m.shape, generator=generator, dtype=torch.float32, device=dev)
            m.copy_(w.div_(s.shape[-2] ** 0.5))
        return out

    shapes = param_shapes(cfg)
    out = {k: draw(k, s) for k, s in shapes.items() if k != "layers"}
    out["layers"] = {k: draw(k, s) for k, s in shapes["layers"].items()}
    return out


def _embed(table, tokens):
    """The embedding rows of ``tokens``: an index, as ``repro`` gathers."""
    if su.is_dtensor(table):
        return _vocab_parallel_embed(table, tokens)
    return table[tokens.long()]


def _vocab_parallel_embed(table, tokens):
    """The lookup on each rank's vocab rows (``local_map``; DTensor's own
    vocab-parallel lookup fails on a 2-D mesh, and its index backward on
    torch 2.11).

    Placement rule: the table's rows stay sharded where they are
    (``lm_param_spec``: over ``"model"``) and its columns are gathered (the
    FSDP all-gather over ``"data"``); the tokens are placed as they come
    and must be replicated where the rows are sharded.  Each rank looks up
    the tokens in its rows (0 for the others): the output is
    ``Partial(sum)`` where the rows are sharded and placed as the tokens
    elsewhere; the table's grad is ``Partial(sum)`` where the tokens are
    sharded.  Any other placement raises.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    if not su.is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    t_pl = tuple(p if p.is_shard(0) else Replicate() for p in table.placements)
    if tuple(table.placements) != t_pl:
        table = table.redistribute(mesh, t_pl)
    out_pl, grad_pl = [], []
    for t_, k_ in zip(t_pl, tokens.placements):
        if t_.is_shard(0) and not k_.is_replicate():
            raise ValueError(f"embedding: tokens {tokens.placements} sharded where the table's "
                             f"rows are ({t_pl})")
        out_pl.append(Partial() if t_.is_shard(0) else k_)
        grad_pl.append(t_ if t_.is_shard(0) else Partial() if k_.is_shard() else Replicate())
    su.requires_even(table, 0, "embedding")
    lo = su.local_offset(table, 0)

    def site(t_l, ids):
        idx = ids.long() - lo
        mine = (idx >= 0) & (idx < t_l.shape[0])
        rows = t_l[torch.clamp(idx, 0, t_l.shape[0] - 1)]
        return torch.where(mine[..., None], rows, 0)

    return local_map(site, out_placements=out_pl,
                     in_placements=(t_pl, tuple(tokens.placements)),
                     in_grad_placements=(tuple(grad_pl), tuple(tokens.placements)),
                     device_mesh=mesh)(table, tokens)


def _layers(params: Params) -> list[dict]:
    """One dict of views a layer: the stacked leaves unbound once."""
    stacked = params["layers"]
    names = list(stacked)
    return [dict(zip(names, vals)) for vals in zip(*(stacked[k].unbind(0) for k in names))]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _plain_proj(a, w, cd):
    return a @ w.to(cd)


def _qkv(lp, h, cfg: TransformerConfig, proj=_plain_proj):
    cd = cfg.compute_dtype
    q = proj(h, lp["wq"], cd)
    k = proj(h, lp["wk"], cd)
    v = proj(h, lp["wv"], cd)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(cd)
        k = k + lp["bk"].to(cd)
        v = v + lp["bv"].to(cd)
    return q, k, v


def _attention_block(lp, x, positions, cfg: TransformerConfig):
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # the sequence gathered inside the layer (GSPMD's gather of the
    # boundary's sequence shards; DTensor cannot flatten a batch- and
    # sequence-sharded [B, S, D] into the projections' rows)
    x = su.maybe_constrain(x, cfg.batch_axes)
    h = rms_norm(x, lp["ln1"].to(cfg.compute_dtype), cfg.norm_eps)
    q, k, v = _qkv(lp, h, cfg)
    q = attn_mod.rope(_split_heads(q, hq, dh), positions, cfg.rope_theta)
    k = attn_mod.rope(_split_heads(k, hkv, dh), positions, cfg.rope_theta)
    v = _split_heads(v, hkv, dh)
    o = attn_mod.attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        impl=cfg.attn_impl, causal=True, window=cfg.sliding_window,
        block=cfg.attn_block, backend=cfg.backend,
        batch_axes=cfg.batch_axes, tp_axis=cfg.tp_axis,
    )
    return x + _row_parallel(_merge_heads(o.transpose(1, 2)), lp["wo"], cfg.compute_dtype)


def _row_parallel(a, w, cd):
    """``a @ w.to(cd)``.  Under a mesh that shards ``a``'s last dim (the
    heads into ``wo``, the FFN's hidden units into ``w2``), each rank's
    product is a partial sum: it is kept in float32 and reduced so
    (``local_map``), then rounded to ``cd`` once, as the unsharded product
    rounds once.  Partial sums rounded to bfloat16 before the reduction put
    the sharded bfloat16 prefill 14% further from the float32 model than
    the unsharded one.

    Placement rule: ``w``'s rows are sharded as ``a``'s last dim and
    replicated elsewhere (the FSDP all-gather); the output is placed as
    ``a``'s leading dims and all-reduced over the mesh dims that shard the
    contraction; ``w``'s grad is ``Partial(sum)`` where ``a``'s leading dims
    are sharded.  Any other placement of ``a`` raises.
    """
    last = a.ndim - 1
    if not su.is_dtensor(a) or not any(p.is_shard(last) for p in a.placements):
        return a @ w.to(cd)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, a_pl = a.device_mesh, tuple(a.placements)
    if any(p.is_partial() for p in a_pl):
        raise ValueError(f"row-parallel product: partial input {a_pl}")
    w_pl = tuple(Shard(0) if p.is_shard(last) else Replicate() for p in a_pl)
    w = w.to(cd)
    if tuple(w.placements) != w_pl:
        w = w.redistribute(mesh, w_pl)
    grad_w = tuple(Shard(0) if p.is_shard(last) else Partial() if p.is_shard() else Replicate()
                   for p in a_pl)
    out = local_map(lambda a_, w_: a_.float() @ w_.float(),
                    out_placements=[Partial() if p.is_shard(last) else p for p in a_pl],
                    in_placements=(a_pl, w_pl), in_grad_placements=(a_pl, grad_w),
                    device_mesh=mesh)(a, w)
    reduced = tuple(Replicate() if p.is_partial() else p for p in out.placements)
    return out.redistribute(mesh, reduced).to(cd)


def _split_heads(x, n_heads: int, dh: int):
    """[B, S, H·Dh] -> [B, S, H, Dh].  Under a mesh each rank splits its own
    columns (``local_map``; DTensor on torch 2.11 cannot split a sharded
    dim): the columns' shards must be whole heads, else they are gathered
    first; every other placement, partial sums included, carries over."""
    b, s, _ = x.shape
    if not su.is_dtensor(x):
        return x.reshape(b, s, n_heads, dh)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    ways = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(2):
            ways *= mesh.size(i)
    pl = tuple(x.placements)
    if n_heads % ways:
        pl = tuple(Replicate() if p.is_shard(2) else p for p in pl)
        x = x.redistribute(mesh, pl)
    return local_map(lambda t: t.reshape(t.shape[0], t.shape[1], -1, dh),
                     out_placements=list(pl), in_placements=(pl,), device_mesh=mesh)(x)


def _merge_heads(o):
    """[B, S, H, Dh] -> [B, S, H·Dh].  Under a mesh each rank merges its own
    heads (``local_map``; DTensor on torch 2.11 cannot split the merged dim
    back in the backward): the head dim must be whole, else it is gathered
    first; every other placement carries over."""
    b, s, h, dh = o.shape
    if not su.is_dtensor(o):
        return o.reshape(b, s, h * dh)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(Replicate() if p.is_shard(3) else p for p in o.placements)
    if tuple(o.placements) != pl:
        o = o.redistribute(o.device_mesh, pl)
    return local_map(lambda t: t.reshape(t.shape[0], t.shape[1], -1), out_placements=list(pl),
                     in_placements=(pl,), device_mesh=o.device_mesh)(o)


def _column_parallel(a, w, cd):
    """``a @ w.to(cd)`` with no partial sums.  Under a mesh ``w``'s rows (the
    contraction) are gathered (the FSDP all-gather) and its columns stay
    sharded; each rank multiplies its rows of ``a`` by its columns
    (``local_map``), so the output is rounded to ``cd`` once, as the
    unsharded product is.  (Left to DTensor, a decode-sized ``a`` is
    resharded onto the contraction instead, and its bfloat16 partial sums
    are reduced after rounding.)

    Placement rule: ``w`` ``Shard(1)`` where it is column-sharded and
    ``Replicate()`` elsewhere; ``a`` replicated on those mesh dims and
    where it is partial or shards its last dim, else placed as it is
    (``Shard`` of a leading dim, or ``Replicate()``); the output is
    ``Shard(last)`` on the columns' mesh dims and placed as ``a`` elsewhere.
    Forward only (decode).
    """
    if not su.is_dtensor(a):
        return a @ w.to(cd)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, last = a.device_mesh, a.ndim - 1
    w = w.to(cd)
    w_pl = tuple(Shard(1) if p.is_shard(1) else Replicate() for p in w.placements)
    if tuple(w.placements) != w_pl:
        w = w.redistribute(mesh, w_pl)
    a_pl = tuple(Replicate() if wp.is_shard() or p.is_partial() or p.is_shard(last) else p
                 for p, wp in zip(a.placements, w_pl))
    if tuple(a.placements) != a_pl:
        a = a.redistribute(mesh, a_pl)
    out_pl = [Shard(last) if wp.is_shard() else p for p, wp in zip(a_pl, w_pl)]
    return local_map(lambda a_, w_: a_ @ w_, out_placements=out_pl,
                     in_placements=(a_pl, w_pl), device_mesh=mesh)(a, w)


def _swiglu(h, w1, w3, w2, cd, proj=_plain_proj):
    return _row_parallel(F.silu(proj(h, w1, cd)) * proj(h, w3, cd), w2, cd)


def _ffn(lp, h, cfg: TransformerConfig, capacity_factor=None, proj=_plain_proj):
    """The FFN of normed tokens h [B, S, D] -> (out [B, S, D], aux): dense,
    or routed experts (+ the dense residual); ``capacity_factor`` overrides
    the config's (decode: 2.0); ``proj`` is the column-parallel product of
    the dense units (decode: :func:`_column_parallel`)."""
    b, s, d = h.shape
    cd = cfg.compute_dtype
    m = cfg.moe
    if m is None:
        return _swiglu(h, lp["w1"], lp["w3"], lp["w2"], cd, proj), None
    cap = moe_mod.expert_capacity(b * s, m.n_experts, m.top_k,
                                  capacity_factor or m.capacity_factor)
    # decode routes without expert parallelism, as repro's decode does
    ep = "data" if cfg.batch_axes and capacity_factor is None else ""
    out, aux = moe_mod.moe_ffn(h.reshape(b * s, d), lp["router"], lp["w1"], lp["w3"],
                               lp["w2"], top_k=m.top_k, capacity=cap, compute_dtype=cd,
                               ep_axis=ep, token_axes=(), tp_axis=cfg.tp_axis)
    out = out.reshape(b, s, d)
    if m.dense_residual_ff:
        out = out + _swiglu(h, lp["dw1"], lp["dw3"], lp["dw2"], cd, proj)
    return out, aux


def _boundary_constraint(x, cfg: TransformerConfig):
    """Layer-boundary activation sharding: batch over the data axes AND
    sequence over the TP axis (Megatron-SP), as ``repro`` pins it; the
    sequence is gathered inside the layer where attention needs it."""
    if not cfg.batch_axes:
        return x
    return su.constrain(x, tuple(cfg.batch_axes), cfg.tp_axis or None)


def _layer(lp, x, positions, cfg: TransformerConfig):
    x = _attention_block(lp, x, positions, cfg)
    x = su.maybe_constrain(x, cfg.batch_axes)
    out, aux = _ffn(lp, rms_norm(x, lp["ln2"].to(cfg.compute_dtype), cfg.norm_eps), cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _boundary_constraint(x + out, cfg), aux


def _logits(params: Params, x, cfg: TransformerConfig, proj=_plain_proj):
    cd = cfg.compute_dtype
    x = rms_norm(x, params["ln_f"].to(cd), cfg.norm_eps)
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return proj(x, unembed, cd)


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens [B, S] -> logits [B, S, V] (compute_dtype), aux loss (f32)."""
    x = _boundary_constraint(_embed(params["embed"].to(cfg.compute_dtype), tokens), cfg)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device).expand(tokens.shape)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layers(params):
        if remat:
            x, a = checkpoint(_layer, lp, x, positions, cfg, use_reentrant=False,
                              context_fn=su.remat_context)
        else:
            x, a = _layer(lp, x, positions, cfg)
        aux = aux + a
    logits = _logits(params, su.maybe_constrain(x, cfg.batch_axes), cfg)
    if cfg.batch_axes:
        logits = su.constrain(logits, tuple(cfg.batch_axes), None, cfg.tp_axis)
    return logits, aux


def loss_fn(params: Params, batch, cfg: TransformerConfig):
    """Causal LM loss: CE + z-loss + MoE aux."""
    tokens, labels = batch["tokens"], batch["labels"]
    logits, aux = forward(params, tokens, cfg)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    if su.is_dtensor(logits):
        gold = _vocab_parallel_gold(logits, labels)
    else:
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = (lse - gold).mean()
    z_loss = 1e-4 * (lse ** 2).mean()
    return ce + z_loss + 1e-2 * aux, {"ce": ce, "aux": aux}


def _vocab_parallel_gold(logits, labels):
    """The label's logit of vocab-sharded logits [..., V] (a DTensor), on
    each rank's own vocab slice (``local_map``).

    Placement rule: the logits sharded over the batch dims (dim 0) and the
    vocab (the last dim), the labels placed as the logits' leading dims (a
    redistribute of the small int labels if not).  Each rank takes the
    labels in its vocab range (0 for the others), so the output is
    ``Partial(sum)`` on the vocab's mesh dims.  Any other placement of the
    logits raises.  (DTensor's own vocab-parallel ``gather`` fails here.)
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, last = logits.device_mesh, logits.ndim - 1
    lab_pl, out_pl = [], []
    for p in logits.placements:
        if p.is_shard(last):
            lab_pl.append(Replicate())
            out_pl.append(Partial())
        elif p.is_replicate() or (p.is_shard() and p.dim < last):
            lab_pl.append(p)
            out_pl.append(p)
        else:
            raise ValueError(f"vocab-parallel gold: logits placed {logits.placements}")
    lab_pl = tuple(lab_pl)
    if tuple(labels.placements) != lab_pl:
        labels = labels.redistribute(mesh, lab_pl)
    su.requires_even(logits, last, "vocab-parallel gold")
    lo = su.local_offset(logits, last)

    def site(lg, lb):
        idx = lb.long() - lo
        mine = (idx >= 0) & (idx < lg.shape[-1])
        g = torch.gather(lg, -1, torch.clamp(idx, 0, lg.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(mine, g, 0.0)

    return local_map(site, out_placements=out_pl,
                     in_placements=(tuple(logits.placements), lab_pl),
                     in_grad_placements=(tuple(logits.placements), lab_pl),
                     device_mesh=mesh)(logits, labels)


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------
def cache_shapes(cfg: TransformerConfig, batch: int, cache_len: int) -> dict:
    """KV cache shapes as meta tensors ([L, B, Hkv, cache_len, Dh] bfloat16)
    and ``pos`` (the decode position, a host int).  SWA archs get a ring of
    window size (pow-2 rounded)."""
    if cfg.sliding_window > 0:
        cache_len = min(cache_len, alloc.next_pow2(cfg.sliding_window))
    kv = torch.empty((cfg.n_layers, batch, cfg.n_kv_heads, cache_len, cfg.head_dim),
                     dtype=torch.bfloat16, device="meta")
    return {"k": kv, "v": kv, "pos": 0}


def init_cache(cfg: TransformerConfig, batch: int, cache_len: int, *,
               device="cuda") -> dict:
    """An empty cache (zeros, ``pos`` 0) of ``cache_shapes`` on ``device``."""
    dev = util.resolve_device(device)
    shapes = cache_shapes(cfg, batch, cache_len)
    return {"k": torch.zeros_like(shapes["k"], device=dev),
            "v": torch.zeros_like(shapes["v"], device=dev), "pos": 0}


def decode_step(params: Params, cache: dict, tokens: torch.Tensor, cfg: TransformerConfig):
    """One token per sequence: tokens [B, 1] -> (logits [B, 1, V], cache).

    The cache is a linear buffer (or a ring for SWA: slot ``pos %
    cache_len``); ``pos`` is the global decode position.  The new K/V are
    written into ``cache["k"]`` / ``cache["v"]`` in place; the returned
    cache holds the same buffers and ``pos + 1``.  MoE layers route each
    sequence's token at capacity factor 2.0.

    Under a mesh (a ``DTensor`` cache, ``launch.shardings.lm_cache_sharding``:
    batch over the data axes, sequence over ``"model"``) decode is
    context-parallel: the rank whose sequence slice holds the slot writes
    it (:func:`_write_slot`), attention merges each rank's slice
    (``attention.decode_attention``), and the column-parallel products
    gather their weights' rows (:func:`_column_parallel`).
    """
    cd = cfg.compute_dtype
    b = tokens.shape[0]
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    k_all, v_all, pos = cache["k"], cache["v"], int(cache["pos"])
    cache_len = k_all.shape[3]
    slot = pos % cache_len if cfg.sliding_window > 0 else min(pos, cache_len - 1)
    live = min(pos + 1, cache_len)

    x = su.maybe_constrain(_embed(params["embed"].to(cd), tokens), cfg.batch_axes)  # [B, 1, D]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=tokens.device)
    for lp, k_cache, v_cache in zip(_layers(params), _cache_layers(k_all),
                                    _cache_layers(v_all)):
        h = rms_norm(x, lp["ln1"].to(cd), cfg.norm_eps)
        q, k, v = _qkv(lp, h, cfg, _column_parallel)
        q = attn_mod.rope(_split_heads(q, hq, dh), positions, cfg.rope_theta)
        k = attn_mod.rope(_split_heads(k, hkv, dh), positions, cfg.rope_theta)
        v = _split_heads(v, hkv, dh)
        _write_slot(k_cache, k.transpose(1, 2), slot)
        _write_slot(v_cache, v.transpose(1, 2), slot)
        o = attn_mod.decode_attention(q.transpose(1, 2).to(cd), k_cache.to(cd),
                                      v_cache.to(cd), live)
        x = x + _row_parallel(_merge_heads(o.transpose(1, 2)), lp["wo"], cd)
        out, _ = _ffn(lp, rms_norm(x, lp["ln2"].to(cd), cfg.norm_eps), cfg,
                      capacity_factor=2.0, proj=_column_parallel)
        x = su.maybe_constrain(x + out, cfg.batch_axes)
    return _logits(params, x, cfg, _column_parallel), {"k": k_all, "v": v_all,
                                                       "pos": pos + 1}


def _cache_layers(kv) -> list:
    """The per-layer views [B, Hkv, S, Dh] of a cache buffer [L, B, Hkv, S,
    Dh]; of a ``DTensor`` buffer, ``DTensor``s over this rank's layer views
    of its shard (the layer dim must not be sharded)."""
    if not su.is_dtensor(kv):
        return list(kv.unbind(0))
    from torch.distributed.tensor import DTensor, Shard

    if any(p.is_shard(0) for p in kv.placements):
        raise ValueError(f"decode: cache placed {kv.placements}; its layer dim is sharded")
    pl = tuple(Shard(p.dim - 1) if p.is_shard() else p for p in kv.placements)
    return [DTensor.from_local(t, kv.device_mesh, pl, run_check=False)
            for t in su.no_grad_local(kv).unbind(0)]


def _write_slot(cache, new, slot: int) -> None:
    """``cache[:, :, slot] = new[:, :, 0]`` in place (cache [B, Hkv, S, Dh],
    new [B, Hkv, 1, Dh] cast to the cache's dtype).

    Under a mesh it is a ``local_map`` site on each rank's cache slice.
    Placement rule: the cache ``Shard(0)`` (batch), ``Shard(2)`` (sequence)
    or ``Replicate()`` on each mesh dim; ``new`` redistributed to the
    cache's batch shards and replicated elsewhere (its heads gathered and
    partial sums reduced before the cast).  Only the rank whose sequence
    slice holds ``slot`` writes (``sharding_utils.local_offset``); the
    others write nothing.  Any other cache placement raises.
    """
    if not su.is_dtensor(cache):
        cache.index_copy_(2, torch.tensor([slot], device=cache.device), new.to(cache.dtype))
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, c_pl = cache.device_mesh, tuple(cache.placements)
    for p in c_pl:
        if not (p.is_replicate() or p.is_shard(0) or p.is_shard(2)):
            raise ValueError(f"decode: cache placed {c_pl}; each mesh dim must shard its "
                             f"batch (0) or sequence (2), or replicate")
    n_pl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in c_pl)
    if tuple(new.placements) != n_pl:
        new = new.redistribute(mesh, n_pl)
    su.requires_even(cache, 2, "decode cache write")
    lo = su.local_offset(cache, 2)

    def site(c_, n_):
        if lo <= slot < lo + c_.shape[2]:
            c_.index_copy_(2, torch.tensor([slot - lo], device=c_.device), n_.to(c_.dtype))
        return c_

    local_map(site, out_placements=list(c_pl), in_placements=(c_pl, n_pl),
              device_mesh=mesh)(cache, new)


# ---------------------------------------------------------------------------
# the serving module
# ---------------------------------------------------------------------------
class TransformerLM(ParamTree):
    """A parameter tree and its config, served through ``forward`` and
    ``decode_step`` (under ``torch.no_grad``)."""

    def __init__(self, params: Params, cfg: TransformerConfig):
        super().__init__(params)
        self.cfg = cfg

    def with_config(self, **changes) -> "TransformerLM":
        """A model on the same weights (shared, not copied) under a config
        with ``changes`` (e.g. ``compute_dtype``)."""
        return TransformerLM(self.tree(), dataclasses.replace(self.cfg, **changes))

    def with_backend(self, backend: str) -> "TransformerLM":
        """The same weights with attention through ``backend`` ("torch" is
        the plain version on the card)."""
        return self.with_config(backend=backend)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor):
        """tokens [B, S] -> logits [B, S, V] (compute_dtype), aux loss."""
        return forward(self.tree(), tokens, self.cfg)

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """See the module's ``decode_step``."""
        return decode_step(self.tree(), cache, tokens, self.cfg)


def init_model(cfg: TransformerConfig, *, generator: torch.Generator,
               device="cuda") -> TransformerLM:
    """A model of ``init_params``' weights."""
    return TransformerLM(init_params(cfg, generator=generator, device=device), cfg)


def from_jax_params(params_np, cfg: TransformerConfig, *, device="cuda") -> TransformerLM:
    """A model holding ``repro``'s ``init_params`` tree, given as numpy
    arrays ({"embed", "layers": {name: [L, ...]}, "ln_f", "unembed"}; the
    MoE leaves ``router``, ``w1``/``w3``/``w2`` of [L, E, ...] and the
    dense residual's ``dw1``/``dw3``/``dw2`` among the layers), in
    ``param_dtype`` (a bfloat16 leaf bit for bit)."""
    return TransformerLM(tensors_from_numpy(params_np, cfg.param_dtype, device=device), cfg)

