"""Back-to-back batched walks over a graph that has taken updates.

Set-up applies the mix's ``setup_rounds`` rounds of mixed batches (sized as
in the stream mix), so the walk image has patched rows; then each call of
the window walks ``rows`` walks together, each from ``seeds_per_row``
uniform seeds, for ``walk_steps`` normalised steps, and waits for them.
``correct`` compares the graph and the checked calls' walks with the plain
reference.
"""
from __future__ import annotations

import math

import torch

from .. import gen, system
from ..harness import Outcome
from ..reference import walk as ref_walk
from ..reference.graph import RefGraph
from .stream import checked_offset, checks_of, pool_for

#: the tests' rehearsal (bench/tests/tiny.py): traffic overrides at 256
#: vertices, batches big enough to touch many rows; no chip run reads it
TINY = {"batch_fraction": 0.02, "max_calls_per_s": 5000, "trace_seconds": 10,
        "check_stride": 2}


def run(ctx) -> Outcome:
    tr = ctx.traffic
    ctx.note("program imported")
    g, (src, dst, wgt), n = system.build_graph(ctx.config, ctx.seed, ctx.device)
    ctx.note(f"graph built: n={n} m={g.m}")
    setup_rounds = int(tr["setup_rounds"])
    pool = pool_for(ctx, src, dst, n, setup_rounds)
    base = (src.cpu(), dst.cpu(), wgt.cpu())
    del src, dst, wgt
    for r in range(setup_rounds):
        g.apply(system.plan_round(pool, r))
    steps, rows = int(tr["walk_steps"]), int(tr["rows"])
    warm = int(tr["warmup_calls"])
    cap = warm + math.ceil(ctx.seconds * float(tr["max_calls_per_s"]))
    seeds = gen.seed_rows(gen.generator(ctx.seed, "walks", ctx.device), cap, rows,
                          int(tr["seeds_per_row"]), n)
    for c in range(warm):
        system.walk(g, steps, gen.seed_visits(seeds[c], n, ctx.device))
    stride, offset = int(tr["check_stride"]), checked_offset(ctx)
    bufs = [ctx.keep_buffer((rows, n)) for _ in range(int(tr["checked_calls"]))]
    kept: list = []
    traced_walks: list = []
    c = warm
    ctx.open_window()
    while True:
        if c >= cap:
            raise RuntimeError(f"the mix's pool of {cap} calls ran out: "
                               "raise its max_calls_per_s")
        with ctx.spans("walk"):
            out = system.walk(g, steps, gen.seed_visits(seeds[c], n, ctx.device))
            ctx.sync()
        if ctx.tracer.active:
            traced_walks.append((steps, rows, system.walk_tiles(g)))
        if (c - warm) % stride == offset and len(kept) < len(bufs):
            bufs[len(kept)].copy_(out, non_blocking=True)
            kept.append(c)
        c += 1
        if ctx.elapsed() >= ctx.seconds:
            break
        ctx.tick()
    ctx.close_window()
    calls = c - warm
    judged = dict(zip(kept, bufs))
    judged[c - 1] = out.cpu()
    final = system.graph_arrays(g)
    del g, out
    ctx.free()
    ctx.note(f"window closed: {calls} calls")

    ref = RefGraph(*base, n, ctx.device)
    ref.apply([system.round_batch(pool, r) for r in range(setup_rounds)])
    rr, cc = ref.rows_cols()
    readings = []
    for i in sorted(judged):
        v0 = gen.seed_visits(seeds[i], n, ctx.device)
        want = ref_walk.walk(rr, cc, n, v0, steps, normalize=True)
        got = (ref_walk.walk(rr, cc, n, v0, steps, normalize=True, dtype=torch.bfloat16)
               if ctx.control else judged[i])
        readings.append(ref_walk.walk_readings(got, want))
        del want, got
    if ctx.control:
        final = (rr, cc, ref.wgt.to(torch.bfloat16).to(torch.float32))
    checks = checks_of(ctx.limits, ref_walk.edges_wrong(*final, ref), readings)
    return Outcome(
        e2e={"walks_per_s": calls * rows / ctx.window_s},
        record={"calls": calls, "traced_walks": traced_walks},
        attempted=calls * rows, failed=0, checks=checks)
