"""Decoder-only LM, the dense serving path (the counterpart of
``repro.models.transformer.model``): GQA / SWA / QKV-bias, RoPE, RMSNorm,
SwiGLU.

``forward`` is prefill (logits for every position) and ``decode_step``
one token per sequence against a KV cache.  Attention goes through
``attention.attention`` with the config's ``attn_impl`` and ``backend``:
``attn_impl="flash"`` is the ``flash_attention`` CUDA kernel on the card.

Weights are stored per layer, [in, out] as ``repro`` stores them (``x @
w``), in ``param_dtype``, and cast to ``compute_dtype`` per layer and per
call, so no second copy of the model is held.  The embedding rows are
gathered first, then cast.  Decode writes each new K/V slot into the cache
in place (``index_copy_``), where ``repro`` updates a donated buffer with
``dynamic_update_slice``.  The projections and the FFN are plain
``torch.matmul`` (``repro`` leaves them to XLA).  MoE layers, the loss and
training are not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core import alloc, util
from . import attention as attn_mod
from .config import TransformerConfig


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
    shapes |= {"w1": (d, cfg.d_ff), "w3": (d, cfg.d_ff), "w2": (cfg.d_ff, d)}
    return shapes


class DecoderLayer(nn.Module):
    """One layer's weights, by ``repro``'s names (``wq`` ... ``w2``)."""

    def __init__(self, weights: dict[str, torch.Tensor]):
        super().__init__()
        for name, w in weights.items():
            self.register_parameter(name, nn.Parameter(w, requires_grad=False))


def _qkv(lp: DecoderLayer, h, cfg: TransformerConfig):
    cd = cfg.compute_dtype
    q = h @ lp.wq.to(cd)
    k = h @ lp.wk.to(cd)
    v = h @ lp.wv.to(cd)
    if cfg.qkv_bias:
        q = q + lp.bq.to(cd)
        k = k + lp.bk.to(cd)
        v = v + lp.bv.to(cd)
    return q, k, v


def _ffn(lp: DecoderLayer, x, cfg: TransformerConfig):
    cd = cfg.compute_dtype
    h = rms_norm(x, lp.ln2.to(cd), cfg.norm_eps)
    g = F.silu(h @ lp.w1.to(cd)) * (h @ lp.w3.to(cd))
    return x + g @ lp.w2.to(cd)


def _attention_block(lp: DecoderLayer, x, positions, cfg: TransformerConfig):
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp.ln1.to(cfg.compute_dtype), cfg.norm_eps)
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
    return x + o @ lp.wo.to(cfg.compute_dtype)


class TransformerLM(nn.Module):
    def __init__(self, embed: torch.Tensor, layers, ln_f: torch.Tensor, unembed,
                 cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.ln_f = nn.Parameter(ln_f, requires_grad=False)
        self.unembed = None if unembed is None else nn.Parameter(unembed, requires_grad=False)

    def with_config(self, **changes) -> "TransformerLM":
        """A model on the same weights (shared, not copied) under a config
        with ``changes`` (e.g. ``compute_dtype``)."""
        return TransformerLM(self.embed, self.layers, self.ln_f, self.unembed,
                             dataclasses.replace(self.cfg, **changes))

    def with_backend(self, backend: str) -> "TransformerLM":
        """The same weights with attention through ``backend`` ("torch" is
        the plain version on the card)."""
        return self.with_config(backend=backend)

    def _logits(self, x):
        cd = self.cfg.compute_dtype
        x = rms_norm(x, self.ln_f.to(cd), self.cfg.norm_eps)
        unembed = self.embed.T if self.unembed is None else self.unembed
        return x @ unembed.to(cd)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor):
        """tokens [B, S] -> logits [B, S, V] (compute_dtype), aux (0: no MoE)."""
        cfg = self.cfg
        x = self.embed[tokens.long()].to(cfg.compute_dtype)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device).expand(tokens.shape)
        for lp in self.layers:
            x = _attention_block(lp, x, positions, cfg)
            x = _ffn(lp, x, cfg)
        return self._logits(x), torch.zeros((), dtype=torch.float32, device=x.device)

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """One token per sequence: tokens [B, 1] -> (logits [B, 1, V], cache).

        The cache is a linear buffer (or a ring for SWA: slot ``pos %
        cache_len``); ``pos`` is the global decode position.  The new K/V
        are written into ``cache["k"]`` / ``cache["v"]`` in place; the
        returned cache holds the same buffers and ``pos + 1``.
        """
        cfg = self.cfg
        cd = cfg.compute_dtype
        b = tokens.shape[0]
        dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        k_all, v_all, pos = cache["k"], cache["v"], int(cache["pos"])
        cache_len = k_all.shape[3]
        slot = pos % cache_len if cfg.sliding_window > 0 else min(pos, cache_len - 1)
        slot_idx = torch.tensor([slot], device=k_all.device)
        live = min(pos + 1, cache_len)

        x = self.embed[tokens.long()].to(cd)  # [B, 1, D]
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=tokens.device)
        for lp, k_cache, v_cache in zip(self.layers, k_all, v_all):
            h = rms_norm(x, lp.ln1.to(cd), cfg.norm_eps)
            q, k, v = _qkv(lp, h, cfg)
            q = attn_mod.rope(q.reshape(b, 1, hq, dh), positions, cfg.rope_theta)
            k = attn_mod.rope(k.reshape(b, 1, hkv, dh), positions, cfg.rope_theta)
            v = v.reshape(b, 1, hkv, dh)
            k_cache.index_copy_(2, slot_idx, k.transpose(1, 2).to(torch.bfloat16))
            v_cache.index_copy_(2, slot_idx, v.transpose(1, 2).to(torch.bfloat16))
            o = attn_mod.decode_attention(q.transpose(1, 2).to(cd), k_cache.to(cd),
                                          v_cache.to(cd), live)
            x = x + o.transpose(1, 2).reshape(b, 1, hq * dh) @ lp.wo.to(cd)
            x = _ffn(lp, x, cfg)
        return self._logits(x), {"k": k_all, "v": v_all, "pos": pos + 1}


# ---------------------------------------------------------------------------
# KV cache
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


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def _model_shapes(cfg: TransformerConfig) -> dict[str, tuple]:
    shapes = {"embed": (cfg.vocab, cfg.d_model), "ln_f": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.d_model, cfg.vocab)
    return shapes


def init_model(cfg: TransformerConfig, *, generator: torch.Generator,
               device="cuda") -> TransformerLM:
    """Random weights as ``repro``'s ``init_params`` draws them (matrices
    N(0,1)/sqrt(fan_in) with fan_in the second-to-last dim, norms 1, biases
    0), from ``generator`` (on ``device``), on ``device``."""
    dev = util.resolve_device(device)

    def draw(name, shape):
        if len(shape) >= 2:
            w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
            return w.div_(shape[-2] ** 0.5).to(cfg.param_dtype)
        fill = 0.0 if name in ("bq", "bk", "bv") else 1.0
        return torch.full(shape, fill, dtype=cfg.param_dtype, device=dev)

    top = {name: draw(name, s) for name, s in _model_shapes(cfg).items()}
    layers = [DecoderLayer({name: draw(name, s)
                            for name, s in _layer_param_shapes(cfg).items()})
              for _ in range(cfg.n_layers)]
    return TransformerLM(top["embed"], layers, top["ln_f"], top.get("unembed"), cfg)


def from_jax_params(params_np, cfg: TransformerConfig, *, device="cuda") -> TransformerLM:
    """A model holding ``repro``'s ``init_params`` pytree, given as numpy
    arrays ({"embed", "layers": {name: [L, ...]}, "ln_f", "unembed"}): the
    layer-stacked arrays are sliced into per-layer modules."""
    dev = util.resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev, cfg.param_dtype)

    stacked = params_np["layers"]
    layers = [DecoderLayer({name: t(stacked[name][i]) for name in _layer_param_shapes(cfg)})
              for i in range(cfg.n_layers)]
    unembed = None if cfg.tie_embeddings else t(params_np["unembed"])
    return TransformerLM(t(params_np["embed"]), layers, t(params_np["ln_f"]), unembed, cfg)
