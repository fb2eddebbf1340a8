"""Plain reference of the graph's update semantics, in torch.

The edge set is a sorted, unique int64 key tensor ``src·n + dst`` with a
float32 weight per key, on whatever device the caller picks.  A batch is
``(del_src, del_dst, ins_src, ins_dst, ins_wgt)`` host or device arrays:

* a deletion removes its edge if present, and is a no-op otherwise;
* an insertion sets its edge's weight, adding the edge if absent;
* within one batch an insertion wins over a deletion of the same edge, and
  of two insertions of one edge the first given wins.

So after any sequence of batches an edge's state is that of the last batch
that touched it, which lets ``apply`` take many batches with one merge.
This file imports nothing of the program.
"""
from __future__ import annotations

import torch


def keys_of(src, dst, n: int, device) -> torch.Tensor:
    s = torch.as_tensor(src).to(device, torch.int64)
    d = torch.as_tensor(dst).to(device, torch.int64)
    return s * n + d


def _first_per_key(keys: torch.Tensor, *rest):
    """Sort by key (stable) and keep each key's first occurrence."""
    keys, order = torch.sort(keys, stable=True)
    keep = torch.ones_like(keys, dtype=torch.bool)
    keep[1:] = keys[1:] != keys[:-1]
    return (keys[keep], *(r[order][keep] for r in rest))


class RefGraph:
    """The edge set and its weights; ``apply`` replays batches in order."""

    def __init__(self, src, dst, wgt, n: int, device):
        self.n = int(n)
        self.device = torch.device(device)
        keys = keys_of(src, dst, n, device)
        w = torch.as_tensor(wgt).to(device, torch.float32)
        self.keys, self.wgt = _first_per_key(keys, w)

    @property
    def m(self) -> int:
        return int(self.keys.shape[0])

    def apply(self, batches) -> None:
        """Apply ``batches`` (an ordered list) as if one after another."""
        if not batches:
            return
        dev, n = self.device, self.n
        keys, prio, wgt, ins = [], [], [], []
        for i, (ds, dd, is_, id_, iw) in enumerate(batches):
            k_del = keys_of(ds, dd, n, dev)
            k_ins, w_ins = _first_per_key(
                keys_of(is_, id_, n, dev), torch.as_tensor(iw).to(dev, torch.float32))
            keys += [k_del, k_ins]
            prio += [torch.full_like(k_del, 2 * i), torch.full_like(k_ins, 2 * i + 1)]
            wgt += [torch.zeros(k_del.shape[0], device=dev), w_ins]
            ins += [torch.zeros_like(k_del, dtype=torch.bool),
                    torch.ones_like(k_ins, dtype=torch.bool)]
        keys, prio = torch.cat(keys), torch.cat(prio)
        wgt, ins = torch.cat(wgt), torch.cat(ins)
        # the last op on each key decides: order by (key, priority), keep the last
        order = torch.argsort(prio, stable=True)
        keys, wgt, ins = keys[order], wgt[order], ins[order]
        order = torch.argsort(keys, stable=True)
        keys, wgt, ins = keys[order], wgt[order], ins[order]
        last = torch.ones_like(keys, dtype=torch.bool)
        last[:-1] = keys[:-1] != keys[1:]
        keys, wgt, ins = keys[last], wgt[last], ins[last]

        pos = torch.searchsorted(self.keys, keys)
        at = pos.clamp(max=max(self.m - 1, 0))
        present = (pos < self.m) & (self.keys[at] == keys) if self.m else torch.zeros_like(ins)
        keep = torch.ones(self.m, dtype=torch.bool, device=dev)
        keep[pos[present & ~ins]] = False
        upd = present & ins
        self.wgt[pos[upd]] = wgt[upd]
        new = ins & ~present
        k2 = torch.cat([self.keys[keep], keys[new]])
        w2 = torch.cat([self.wgt[keep], wgt[new]])
        k2, order = torch.sort(k2)
        self.keys, self.wgt = k2, w2[order]

    def rows_cols(self):
        return self.keys // self.n, self.keys % self.n
