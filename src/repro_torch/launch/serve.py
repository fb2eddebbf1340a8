"""Graph walk serving launcher (DESIGN.md §16) — the serving front-end CLI.

The port of ``repro.launch.serve``: drives the ``runtime.serve`` WalkServer
against a synthetic graph under mixed update/walk traffic, printing latency
percentiles and the zero-lost / torn-read proof fields.

  PYTHONPATH=src python -m repro_torch.launch.serve --rep digraph --scale 10 \\
      --requests 400 --update-every 10 --verify 0.25             # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu ...  # host

Besides ``main``, this module hosts the traffic machinery the serve tests
and ``chip_smoke.py`` reuse:

* :func:`build_rep` — synthetic graph → representation instance;
* :func:`run_traffic` — the mixed walk/update submission loop;
* :class:`GenerationOracle` — the edge set replayed one sealed generation
  at a time and walked with ``index_add_`` in float64; the torn-read check
  (:func:`count_torn_reads`) proves every served walk matches the oracle
  *for its own generation* — the snapshot-isolation contract.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import REPRESENTATIONS, edgebatch, updates, util
from ..io import synthetic
from ..runtime import serve as serve_mod


def build_rep(rep: str = "digraph", *, kind: str = "web", scale: int = 10,
              edge_factor: int = 8, seed: int = 7, device="cuda"):
    """Synthetic graph on ``device`` → (representation, base CSR)."""
    csr = synthetic.make_graph(
        kind, scale=scale, edge_factor=edge_factor, seed=seed, weighted=True,
        device=device,
    )
    return REPRESENTATIONS[rep].from_csr(csr, device=device), csr


def seed_visits_row(nv: int, seeds, weights=None, *, device="cuda") -> torch.Tensor:
    """The [nv] float32 initial visit vector a seed list denotes, on
    ``device`` (repeated seeds add up, as the server materializes them)."""
    dev = util.resolve_device(device)
    seeds = np.atleast_1d(np.asarray(seeds, np.int64))
    w = (
        np.ones(seeds.shape[0], np.float32)
        if weights is None
        else np.asarray(weights, np.float32).reshape(-1)
    )
    row = torch.zeros(nv, dtype=torch.float32, device=dev)
    return row.index_put_((torch.from_numpy(seeds).to(dev),),
                          torch.from_numpy(w).to(dev), accumulate=True)


class GenerationOracle:
    """Plain replica of the served graph, one sealed generation at a time.

    The edge set is a sorted, unique int64 key tensor ``src·n + dst`` on
    the CSR's device, independent of the arena, the walk image and the
    kernels.  Updates are recorded against the generation
    that first exposed them (the ack's ``ticket.generation``);
    ``walk(gen, row, steps)`` advances the edge set to exactly that
    generation — each recorded plan in order, deletes by ``torch.isin``,
    inserts by concatenation and ``unique`` — and walks it with
    ``index_add_`` in float64 (visits1[u] = Σ_{(u,v)∈E} visits0[v]; weights
    don't enter the count walk).  Verification must proceed in
    nondecreasing generation order — the torn-read check sorts served
    tickets by generation.
    """

    def __init__(self, csr):
        self.device = csr.offsets.device
        self.nv = int(csr.n)
        m = int(csr.m)
        rows = util.expand_rows(csr.offsets, m).to(self.device, torch.int64)
        d = csr.dst[:m].to(self.device, torch.int64)
        self._keys = torch.unique(rows * self.nv + d)
        self._gen = 0
        self._plans: dict = {}
        self._arrays = None

    def record(self, gen: int, plan) -> None:
        """Register ``plan`` as first visible at sealed generation ``gen``."""
        self._plans.setdefault(int(gen), []).append(plan)

    def _advance(self, gen: int) -> None:
        if gen < self._gen:
            raise ValueError(
                f"oracle at generation {self._gen}, asked to rewind to {gen}"
            )
        while self._gen < gen:
            self._gen += 1
            for plan in self._plans.pop(self._gen, ()):
                # canonical op stream: each (src, dst) appears once, so
                # deletes and inserts of one plan commute
                key = torch.from_numpy(
                    plan.q_src.astype(np.int64) * self.nv + plan.q_dst.astype(np.int64)
                ).to(self.device)
                rm = torch.from_numpy(np.asarray(plan.q_del, bool)).to(self.device)
                if bool(rm.any()):
                    self._keys = self._keys[~torch.isin(self._keys, key[rm])]
                if not bool(rm.all()):
                    self._keys = torch.unique(torch.cat([self._keys, key[~rm]]))
                self._arrays = None

    def walk(self, gen: int, visits_row, steps: int, *, drop_rows=None) -> torch.Tensor:
        """Oracle walk at ``gen`` -> float64 [nv] on the oracle's device.

        ``drop_rows`` models degraded coverage: a quarantined shard's rows
        read zero at every step (``nxt[drop_rows] = 0``, §17); None or
        empty is the full-coverage walk.
        """
        self._advance(int(gen))
        if self._arrays is None:
            self._arrays = (self._keys // self.nv, self._keys % self.nv)
        s, d = self._arrays
        drop = (
            None if drop_rows is None or len(drop_rows) == 0
            else torch.as_tensor(np.asarray(drop_rows, np.int64), device=self.device)
        )
        v = torch.as_tensor(visits_row).to(self.device, torch.float64).reshape(-1)
        for _ in range(steps):
            nxt = torch.zeros(self.nv, dtype=torch.float64, device=self.device)
            nxt.index_add_(0, s, v[d])
            if drop is not None:
                nxt[drop] = 0.0
            v = nxt
        return v


def run_traffic(
    server: "serve_mod.WalkServer",
    nv: int,
    *,
    requests: int = 200,
    steps: int = 4,
    seeds_per_request: int = 4,
    update_every: int = 10,
    update_size: int = 256,
    delete_every: int = 4,
    seed: int = 0,
    submit_gap_s: float = 0.0,
    timeout=None,
):
    """Drive a mixed update/walk stream through a running server.

    Every ``update_every``-th request is preceded by an update batch
    (every ``delete_every``-th of those deletes random pairs instead of
    inserting).  Returns ``(walk_tickets, update_tickets)`` where each
    update ticket is paired with its plan for oracle replay.  Tickets
    are NOT waited on here — callers decide how long to block.
    """
    rng = np.random.default_rng(seed)
    walk_tickets, update_tickets = [], []
    n_updates = 0
    for i in range(int(requests)):
        if update_every and i % update_every == 0:
            if delete_every and n_updates % delete_every == delete_every - 1:
                eb = edgebatch.from_arrays(
                    rng.integers(0, nv, update_size),
                    rng.integers(0, nv, update_size),
                )
                plan = updates.plan_update(deletes=eb)
            else:
                eb = edgebatch.random_insertions(rng, nv, update_size)
                plan = updates.plan_update(inserts=eb)
            update_tickets.append((server.submit_update(plan), plan))
            n_updates += 1
        seeds = rng.integers(0, nv, size=seeds_per_request)
        walk_tickets.append(
            server.submit_walk(seeds, steps=steps, timeout=timeout)
        )
        if submit_gap_s:
            time.sleep(submit_gap_s)
    return walk_tickets, update_tickets


def count_torn_reads(
    oracle: GenerationOracle,
    walk_tickets,
    update_tickets,
    *,
    sample: float = 1.0,
    seed: int = 0,
    rtol: float = 1e-4,
    atol: float = 1e-2,
    down_rows_of=None,
):
    """Verify served walks against the per-generation oracle.

    Returns ``(torn, checked)``: ``torn`` counts served walks whose
    visits do NOT match the oracle at their own generation — any torn
    read (a walk that saw a half-applied plan) fails the allclose, since
    no sealed edge set produces its numbers.  ``sample`` < 1 checks a
    random subset.  ``down_rows_of`` (ticket → row-id array or None) maps
    a degraded response's ``down_shards`` to the masked rows (§17).
    """
    rng = np.random.default_rng(seed)
    for t, plan in update_tickets:
        if t.status == serve_mod.SERVED:
            oracle.record(t.generation, plan)
    served = sorted(
        (t for t in walk_tickets if t.status == serve_mod.SERVED),
        key=lambda t: t.generation,
    )
    torn = checked = 0
    for t in served:
        if sample < 1.0 and rng.random() > sample:
            continue
        row = (
            torch.as_tensor(util.host(t.visits_row), dtype=torch.float32)
            if t.visits_row is not None
            else seed_visits_row(oracle.nv, t.seeds, t.weights, device=oracle.device)
        )
        drop = None if down_rows_of is None else down_rows_of(t)
        expect = oracle.walk(t.generation, row, t.steps, drop_rows=drop)
        checked += 1
        got = t.visits.to(expect.device, torch.float64)
        if not torch.allclose(got, expect, rtol=rtol, atol=atol):
            torn += 1
    return torn, checked


def percentiles(latencies_s, qs=(50, 95, 99)) -> dict:
    """{"p50_ms": ..., ...} from a list of per-request latencies."""
    if not latencies_s:
        return {f"p{q}_ms": float("nan") for q in qs}
    arr = np.asarray(latencies_s, np.float64) * 1e3
    return {f"p{q}_ms": float(np.percentile(arr, q)) for q in qs}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serve mixed walk/update traffic from a WalkServer"
    )
    ap.add_argument("--rep", default="digraph", choices=sorted(REPRESENTATIONS))
    ap.add_argument("--kind", default="web")
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--update-every", type=int, default=10)
    ap.add_argument("--update-size", type=int, default=256)
    ap.add_argument("--batch-max", type=int, default=32)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-request deadline in seconds")
    ap.add_argument("--backend", default="auto", choices=("auto", "cuda", "torch"),
                    help="walk backend: the CUDA kernel, its plain version, or "
                         "by device")
    ap.add_argument("--device", default="cuda",
                    help="where the graph and the walks live (cuda or cpu)")
    ap.add_argument("--verify", type=float, default=0.25,
                    help="fraction of served walks checked against the "
                         "per-generation oracle (0 disables)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    rep, csr = build_rep(
        args.rep, kind=args.kind, scale=args.scale,
        edge_factor=args.edge_factor, device=args.device,
    )
    nv = int(csr.n)
    print(f"[serve] {args.rep} kind={args.kind} |V|={nv} |E|={int(csr.m)} "
          f"device={csr.offsets.device}")
    server = serve_mod.WalkServer(
        rep, max_queue=args.max_queue, batch_max=args.batch_max,
        default_timeout=args.timeout, walk_backend=args.backend,
    ).start()
    try:
        t0 = time.monotonic()
        walks, upds = run_traffic(
            server, nv, requests=args.requests, steps=args.steps,
            update_every=args.update_every, update_size=args.update_size,
            seed=args.seed, timeout=args.timeout,
        )
        for t in walks:
            t.wait(60.0)
    finally:
        stats = server.stop()
    dt = time.monotonic() - t0
    server.assert_no_lost()

    lat = [t.latency_s for t in walks if t.status == serve_mod.SERVED]
    pct = percentiles(lat)
    torn = checked = 0
    if args.verify > 0:
        torn, checked = count_torn_reads(
            GenerationOracle(csr), walks, upds, sample=args.verify
        )
    print(
        f"[serve] {stats['served']}/{stats['submitted']} served in {dt:.2f}s "
        f"({stats['served'] / max(dt, 1e-9):.1f} req/s), "
        f"shed={stats['shed_expired']} "
        f"rejected={stats['rejected_backpressure'] + stats['rejected_other']} "
        f"failed={stats['failed']}"
    )
    print(
        f"[serve] latency p50={pct['p50_ms']:.2f}ms p95={pct['p95_ms']:.2f}ms "
        f"p99={pct['p99_ms']:.2f}ms | generations={stats['generation'] + 1} "
        f"updates={stats['updates_applied']} "
        f"retries={stats['dispatch_retries']}"
    )
    if checked:
        print(f"[serve] torn_reads={torn}/{checked} checked")
        if torn:
            raise AssertionError("snapshot isolation violated")
    return stats


if __name__ == "__main__":
    main()
