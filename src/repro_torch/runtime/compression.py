"""Gradient compression for the slow (pod) axis all-reduce (the counterpart
of ``repro.runtime.compression``).

Two standard schemes with error feedback:
  * int8 quantization (per-tensor scale): 4× fewer bytes on the wire,
  * top-k sparsification: k largest |g| entries, rest fed back next step.

Error feedback keeps both unbiased-in-the-limit (Karimireddy et al. 2019).
The compressors plug into ``train.loop.make_train_step(compress_fn=...)``
and carry their residual in the closure, as ``repro``'s do.  Neither
package wraps the pod-axis all-reduce itself: under a mesh the grads are
reduced by DTensor (``train.optimizer.follow``), and the hook compresses
and decompresses the grads it is handed, as ``repro``'s does.
``torch.round`` rounds half to even as ``jnp.round`` does, so the int8
codes are ``repro``'s.
"""
from __future__ import annotations

import torch

from ..core import tree as tree_mod


def int8_compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _split(grads, pairs):
    """Two trees shaped as ``grads`` from a tree of pairs at its leaves."""
    return (tree_mod.tree_map(lambda _, p: p[0], grads, pairs),
            tree_mod.tree_map(lambda _, p: p[1], grads, pairs))


def _zeros_like(grads):
    return tree_mod.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                   device=g.device), grads)


def make_int8_ef_compressor():
    """Stateful int8 compressor with error feedback (the residual is carried
    in the closure)."""
    state = {"residual": None}

    def compress(grads):
        res = state["residual"]
        if res is None:
            res = _zeros_like(grads)

        def one(g, r):
            x = g.to(torch.float32) + r
            q, s = int8_compress(x)
            deq = int8_decompress(q, s)
            return deq, x - deq

        out, state["residual"] = _split(grads, tree_mod.tree_map(one, grads, res))
        return out

    return compress


def topk_compress(g: torch.Tensor, frac: float = 0.01):
    flat = g.reshape(-1).to(torch.float32)
    k = max(int(flat.shape[0] * frac), 1)
    _, idx = torch.topk(torch.abs(flat), k)
    out = torch.zeros_like(flat).index_put((idx,), flat[idx])
    return out.reshape(g.shape), (g.to(torch.float32) - out.reshape(g.shape))


def make_topk_ef_compressor(frac: float = 0.01):
    state = {"residual": None}

    def compress(grads):
        res = state["residual"]
        if res is None:
            res = _zeros_like(grads)

        def one(g, r):
            return topk_compress(g.to(torch.float32) + r, frac)

        out, state["residual"] = _split(grads, tree_mod.tree_map(one, grads, res))
        return out

    return compress


def compressed_psum_bytes(n_params: int, scheme: str = "int8", frac: float = 0.01) -> int:
    """Wire bytes per pod-axis all-reduce (the roofline's collective term
    for the compressed variant)."""
    if scheme == "int8":
        return n_params * 1 + 4
    if scheme == "topk":
        return int(n_params * frac) * 8  # value + index
    return n_params * 4
