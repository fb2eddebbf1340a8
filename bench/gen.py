"""Graph and traffic generators of the benchmark, on the device, from a seed.

The graph families are the port's host generators (``io/synthetic.make_coo``:
R-MAT with the social quadrant probabilities, and the road-like chain with
short shortcuts), written again in torch so that a run builds its graph on
the card in a few large calls instead of ~45 s of numpy.  The parameters
come from the configuration file; the same seed on the same device gives the
same arrays.  Nothing here imports the program.
"""
from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (graph, traffic, sample) of a run seed."""
    words = [int(b) for b in tag.encode()]
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), *words])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def rmat_edges(g: torch.Generator, scale: int, edge_factor: int,
               a: float, b: float, c: float, device):
    """R-MAT: one uniform draw per edge and bit picks the quadrant."""
    m = (1 << scale) * edge_factor
    src = torch.zeros(m, dtype=torch.int32, device=device)
    dst = torch.zeros(m, dtype=torch.int32, device=device)
    for bit in range(scale):
        r = torch.rand(m, generator=g, device=device)
        src |= (r >= a + b).to(torch.int32) << bit
        dst |= (((r >= a) & (r < a + b)) | (r >= a + b + c)).to(torch.int32) << bit
    return src, dst


def road_edges(g: torch.Generator, n: int, avg_degree: float,
               max_hop: int, device):
    """A chain 0-1-...-(n-1) plus n·max(avg_degree-2, 0.05) shortcuts, each
    from a uniform vertex to one 1..max_hop-1 ahead (clipped at the end)."""
    chain = torch.arange(n - 1, dtype=torch.int32, device=device)
    extra = int(n * max(avg_degree - 2.0, 0.05))
    esrc = torch.randint(0, n, (extra,), generator=g, device=device, dtype=torch.int32)
    off = torch.randint(1, max_hop, (extra,), generator=g, device=device, dtype=torch.int32)
    edst = torch.clamp(esrc + off, max=n - 1)
    return torch.cat([chain, esrc]), torch.cat([chain + 1, edst])


def dedup(src, dst, wgt, n: int):
    """(src, dst)-sorted unique edges; of duplicates the first drawn stays."""
    keys = src.to(torch.int64) * n + dst.to(torch.int64)
    keys, order = torch.sort(keys, stable=True)
    wgt = wgt[order]
    keep = torch.ones_like(keys, dtype=torch.bool)
    keep[1:] = keys[1:] != keys[:-1]
    keys, wgt = keys[keep], wgt[keep]
    return (keys // n).to(torch.int32), (keys % n).to(torch.int32), wgt


def make_graph(cfg: dict, seed: int, device):
    """The configuration's graph: (src, dst, wgt, n), sorted and unique, on
    ``device``.  ``cfg["generator"]`` is ``rmat`` (on ``2**scale``
    vertices) or ``road`` (on ``cfg["vertices"]``)."""
    g = generator(seed, "graph", device)
    n = int(cfg["vertices"])
    if cfg["generator"] == "rmat":
        if n != 1 << int(cfg["scale"]):
            raise ValueError(f"R-MAT at scale {cfg['scale']} has {1 << int(cfg['scale'])} "
                             f"vertices, not {n}")
        src, dst = rmat_edges(g, int(cfg["scale"]), int(cfg["edge_factor"]),
                              float(cfg["a"]), float(cfg["b"]), float(cfg["c"]), device)
    elif cfg["generator"] == "road":
        src, dst = road_edges(g, n, float(cfg["avg_degree"]), int(cfg["max_hop"]), device)
    else:
        raise ValueError(f"unknown generator {cfg['generator']!r}")
    if cfg.get("symmetric", True):
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    lo, hi = cfg["weight_range"]
    wgt = torch.rand(src.shape[0], generator=g, device=device) * (hi - lo) + lo
    return (*dedup(src, dst, wgt, n), n)


def batch_size(cfg: dict, traffic: dict) -> int:
    """Operations a round: the mix's fraction of the configuration's nominal
    edge count, so every seed gets the same sizes."""
    return int(round(float(traffic["batch_fraction"]) * int(cfg["edges"])))


def host_pool(src, dst, n: int, rounds: int, n_del: int, n_ins: int,
              weight_range, g: torch.Generator):
    """Host arrays of ``rounds`` mixed batches: ``n_del`` deletions of edges
    live at set-up, drawn without replacement over the whole pool, and
    ``n_ins`` insertions of uniform random pairs with uniform weights.
    Returns a dict of numpy arrays, each [rounds, k]."""
    m = int(src.shape[0])
    if rounds * n_del > m:
        raise ValueError(f"pool of {rounds} rounds deletes {rounds * n_del} of {m} edges")
    dev = src.device
    pick = torch.randperm(m, generator=g, device=dev)[: rounds * n_del]
    ins_s = torch.randint(0, n, (rounds * n_ins,), generator=g, device=dev, dtype=torch.int32)
    ins_d = torch.randint(0, n, (rounds * n_ins,), generator=g, device=dev, dtype=torch.int32)
    lo, hi = weight_range
    ins_w = torch.rand(rounds * n_ins, generator=g, device=dev) * (hi - lo) + lo
    out = {
        "del_src": src[pick], "del_dst": dst[pick],
        "ins_src": ins_s, "ins_dst": ins_d, "ins_wgt": ins_w,
    }
    return {k: v.cpu().numpy().reshape(rounds, -1) for k, v in out.items()}


def seed_rows(g: torch.Generator, calls: int, rows: int, seeds: int, n: int) -> np.ndarray:
    """Walk seeds: [calls, rows, seeds] uniform vertex ids."""
    return torch.randint(0, n, (calls, rows, seeds), generator=g,
                         device=g.device, dtype=torch.int64).cpu().numpy()


def seed_visits(seeds, n: int, device) -> torch.Tensor:
    """[B, S] seed ids -> [B, n] float32 initial visits, repeated seeds
    adding up (the walks' input, handed to the program and the reference)."""
    seeds = torch.as_tensor(seeds, dtype=torch.int64).to(device)
    v = torch.zeros((seeds.shape[0], n), dtype=torch.float32, device=device)
    return v.scatter_add_(1, seeds, torch.ones(seeds.shape, dtype=torch.float32, device=device))
