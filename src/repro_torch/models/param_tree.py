"""Parameter trees as ``nn.Module``s.

A model's parameters are a tree shaped as ``repro``'s pytree
(``core.tree``); ``ParamTree`` holds one as an ``nn.Module`` whose names
mirror the tree's paths (``params["layers"]["wq"]`` is ``layers.wq``), so
``tree()`` hands the functional model code its tree and a checkpoint of
that tree has ``repro``'s keys.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core import tree as tree_mod
from ..core import util


class ParamTree(nn.Module):
    """An ``nn.Module`` holding a tree of parameters under the tree's own
    names: a dict key or a sequence index names each child."""

    def __init__(self, tree):
        super().__init__()
        self._kind = type(tree)
        self._keys = list(tree) if isinstance(tree, dict) else list(range(len(tree)))
        for k in self._keys:
            v = tree[k]
            if isinstance(v, (dict, list, tuple)):
                self.add_module(str(k), ParamTree(v))
            else:
                self.register_parameter(
                    str(k), v if isinstance(v, nn.Parameter) else nn.Parameter(v))

    def tree(self):
        """The tree, its leaves the module's ``nn.Parameter`` objects."""
        vals = []
        for k in self._keys:
            v = getattr(self, str(k))
            vals.append(v.tree() if isinstance(v, ParamTree) else v)
        if self._kind is dict:
            return dict(zip(self._keys, vals))
        return self._kind(vals)


def tensors_from_numpy(tree_np, dtype: torch.dtype = torch.float32, *, device):
    """A tree of numpy arrays (``repro``'s pytree through ``np.asarray``)
    as tensors of ``dtype`` on ``device``; a bfloat16 array (``ml_dtypes``,
    or its raw 16-bit words as a checkpoint stores them) keeps its bits."""
    dev = util.resolve_device(device)

    def t(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
            words = torch.from_numpy(np.array(a).view(np.int16))  # a copy
            return words.view(torch.bfloat16).to(dev, dtype)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, dtype)

    return tree_mod.tree_map(t, tree_np)
