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
kernel on the card, forward only).  Decode writes each new K/V slot into
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
    held (arctic's experts: 17.8 GB)."""
    dev = util.resolve_device(device)

    def draw(name, s):
        if name in ("ln1", "ln2", "ln_f"):
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        if name in ("bq", "bk", "bv"):
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        out = torch.empty(s.shape, dtype=s.dtype, device=dev)
        mats = out.reshape(-1, *s.shape[-2:])
        for m in mats:
            w = torch.randn(m.shape, generator=generator, dtype=torch.float32, device=dev)
            m.copy_(w.div_(s.shape[-2] ** 0.5))
        return out

    shapes = param_shapes(cfg)
    out = {k: draw(k, s) for k, s in shapes.items() if k != "layers"}
    out["layers"] = {k: draw(k, s) for k, s in shapes["layers"].items()}
    return out


def _layers(params: Params) -> list[dict]:
    """One dict of views a layer: the stacked leaves unbound once."""
    stacked = params["layers"]
    names = list(stacked)
    return [dict(zip(names, vals)) for vals in zip(*(stacked[k].unbind(0) for k in names))]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _qkv(lp, h, cfg: TransformerConfig):
    cd = cfg.compute_dtype
    q = h @ lp["wq"].to(cd)
    k = h @ lp["wk"].to(cd)
    v = h @ lp["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(cd)
        k = k + lp["bk"].to(cd)
        v = v + lp["bv"].to(cd)
    return q, k, v


def _attention_block(lp, x, positions, cfg: TransformerConfig):
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["ln1"].to(cfg.compute_dtype), cfg.norm_eps)
    q, k, v = _qkv(lp, h, cfg)
    q = attn_mod.rope(q.reshape(b, s, hq, dh), positions, cfg.rope_theta)
    k = attn_mod.rope(k.reshape(b, s, hkv, dh), positions, cfg.rope_theta)
    v = v.reshape(b, s, hkv, dh)
    o = attn_mod.attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        impl=cfg.attn_impl, causal=True, window=cfg.sliding_window,
        block=cfg.attn_block, backend=cfg.backend,
    )
    o = o.transpose(1, 2).reshape(b, s, hq * dh)
    return x + o @ lp["wo"].to(cfg.compute_dtype)


def _swiglu(h, w1, w3, w2, cd):
    return (F.silu(h @ w1.to(cd)) * (h @ w3.to(cd))) @ w2.to(cd)


def _ffn(lp, h, cfg: TransformerConfig, capacity_factor=None):
    """The FFN of normed tokens h [B, S, D] -> (out [B, S, D], aux): dense,
    or routed experts (+ the dense residual); ``capacity_factor`` overrides
    the config's (decode: 2.0)."""
    b, s, d = h.shape
    cd = cfg.compute_dtype
    m = cfg.moe
    if m is None:
        return _swiglu(h, lp["w1"], lp["w3"], lp["w2"], cd), None
    cap = moe_mod.expert_capacity(b * s, m.n_experts, m.top_k,
                                  capacity_factor or m.capacity_factor)
    out, aux = moe_mod.moe_ffn(h.reshape(b * s, d), lp["router"], lp["w1"], lp["w3"],
                               lp["w2"], top_k=m.top_k, capacity=cap, compute_dtype=cd)
    out = out.reshape(b, s, d)
    if m.dense_residual_ff:
        out = out + _swiglu(h, lp["dw1"], lp["dw3"], lp["dw2"], cd)
    return out, aux


def _layer(lp, x, positions, cfg: TransformerConfig):
    x = _attention_block(lp, x, positions, cfg)
    out, aux = _ffn(lp, rms_norm(x, lp["ln2"].to(cfg.compute_dtype), cfg.norm_eps), cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux


def _logits(params: Params, x, cfg: TransformerConfig):
    cd = cfg.compute_dtype
    x = rms_norm(x, params["ln_f"].to(cd), cfg.norm_eps)
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ unembed.to(cd)


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens [B, S] -> logits [B, S, V] (compute_dtype), aux loss (f32)."""
    x = params["embed"].to(cfg.compute_dtype)[tokens.long()]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device).expand(tokens.shape)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layers(params):
        if remat:
            x, a = checkpoint(_layer, lp, x, positions, cfg, use_reentrant=False)
        else:
            x, a = _layer(lp, x, positions, cfg)
        aux = aux + a
    return _logits(params, x, cfg), aux


def loss_fn(params: Params, batch, cfg: TransformerConfig):
    """Causal LM loss: CE + z-loss + MoE aux."""
    tokens, labels = batch["tokens"], batch["labels"]
    logits, aux = forward(params, tokens, cfg)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = (lse - gold).mean()
    z_loss = 1e-4 * (lse ** 2).mean()
    return ce + z_loss + 1e-2 * aux, {"ce": ce, "aux": aux}


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
    """
    cd = cfg.compute_dtype
    b = tokens.shape[0]
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    k_all, v_all, pos = cache["k"], cache["v"], int(cache["pos"])
    cache_len = k_all.shape[3]
    slot = pos % cache_len if cfg.sliding_window > 0 else min(pos, cache_len - 1)
    slot_idx = torch.tensor([slot], device=k_all.device)
    live = min(pos + 1, cache_len)

    x = params["embed"].to(cd)[tokens.long()]  # [B, 1, D]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=tokens.device)
    for lp, k_cache, v_cache in zip(_layers(params), k_all, v_all):
        h = rms_norm(x, lp["ln1"].to(cd), cfg.norm_eps)
        q, k, v = _qkv(lp, h, cfg)
        q = attn_mod.rope(q.reshape(b, 1, hq, dh), positions, cfg.rope_theta)
        k = attn_mod.rope(k.reshape(b, 1, hkv, dh), positions, cfg.rope_theta)
        v = v.reshape(b, 1, hkv, dh)
        k_cache.index_copy_(2, slot_idx, k.transpose(1, 2).to(torch.bfloat16))
        v_cache.index_copy_(2, slot_idx, v.transpose(1, 2).to(torch.bfloat16))
        o = attn_mod.decode_attention(q.transpose(1, 2).to(cd), k_cache.to(cd),
                                      v_cache.to(cd), live)
        x = x + o.transpose(1, 2).reshape(b, 1, hq * dh) @ lp["wo"].to(cd)
        out, _ = _ffn(lp, rms_norm(x, lp["ln2"].to(cd), cfg.norm_eps), cfg,
                      capacity_factor=2.0)
        x = x + out
    return _logits(params, x, cfg), {"k": k_all, "v": v_all, "pos": pos + 1}


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

