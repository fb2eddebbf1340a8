"""Closed loop, one client: a round plans a fresh mixed batch, applies it,
and walks the updated graph.

The mix's file gives the batch as a fraction of the configuration's
nominal edge count (half deletions of edges live at set-up, drawn without
replacement, half insertions of uniform random pairs), the walk's steps, the
rounds applied in set-up, and which rounds' walks are checked.  The batches
are generated from the seed in set-up and handed over as host arrays.

``correct`` compares the graph after the window's last round (every edge
and weight) and the walks of the checked rounds and of the last with the
plain reference, which replays the same batches on the same generated
arrays.  ``ctx.control`` puts that reference, in bfloat16 (the weights and
the walk), in the program's place.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import gen, system
from ..harness import Check, Outcome
from ..reference import walk as ref_walk
from ..reference.graph import RefGraph

#: the tests' rehearsal (bench/tests/tiny.py): traffic overrides at 256
#: vertices, batches big enough to touch many rows; no chip run reads it
TINY = {"batch_fraction": 0.01, "max_rounds_per_s": 600, "trace_seconds": 10}


def pool_for(ctx, src, dst, n: int, rounds: int):
    """The run's batch pool on the host (set-up)."""
    k = gen.batch_size(ctx.config, ctx.traffic)
    return gen.host_pool(src, dst, n, rounds, k // 2, k - k // 2,
                         ctx.config["weight_range"], gen.generator(ctx.seed, "traffic", ctx.device))


def checked_offset(ctx) -> int:
    rng = np.random.default_rng(gen.sub_seed(ctx.seed, "sample"))
    return int(rng.integers(int(ctx.traffic["check_stride"])))


def run(ctx) -> Outcome:
    tr = ctx.traffic
    ctx.note("program imported")
    g, (src, dst, wgt), n = system.build_graph(ctx.config, ctx.seed, ctx.device)
    ctx.note(f"graph built: n={n} m={g.m}")
    warm = int(tr["warmup_rounds"])
    cap = warm + math.ceil(ctx.seconds * float(tr["max_rounds_per_s"]))
    pool = pool_for(ctx, src, dst, n, cap)
    base = (src.cpu(), dst.cpu(), wgt.cpu())
    del src, dst, wgt
    ctx.note(f"pool of {cap} rounds made")
    steps = int(tr["walk_steps"])
    for r in range(warm):
        g.apply(system.plan_round(pool, r))
        system.walk(g, steps)
    ctx.note("warmed up")
    stride, offset = int(tr["check_stride"]), checked_offset(ctx)
    bufs = [ctx.keep_buffer(n) for _ in range(int(tr["checked_rounds"]))]
    kept: list = []
    traced_walks: list = []
    ends: list = []
    r = warm
    ctx.open_window()
    while True:
        if r >= cap:
            raise RuntimeError(f"the mix's pool of {cap} rounds ran out: "
                               "raise its max_rounds_per_s")
        with ctx.spans("plan"):
            plan = system.plan_round(pool, r)
        with ctx.spans("apply"):
            g.apply(plan)
        bump = system.arena_bump(g)
        with ctx.spans("walk"):
            v = system.walk(g, steps)
            ctx.sync()
        ends.append((ctx.elapsed(), bump, system.arena_bump(g), ctx.tracer.active))
        if ctx.tracer.active:
            traced_walks.append((steps, 1, system.walk_tiles(g)))
        if (r - warm) % stride == offset and len(kept) < len(bufs):
            bufs[len(kept)].copy_(v, non_blocking=True)
            kept.append(r)
        r += 1
        if ctx.elapsed() >= ctx.seconds:
            break
        ctx.tick()
    ctx.close_window()
    rounds = r - warm
    judged = dict(zip(kept, bufs))
    judged[r - 1] = v.cpu()
    final = system.graph_arrays(g)
    del g, plan, v
    ctx.free()
    compactions = sum(after < before for _, before, after, _ in ends)
    ctx.note(f"window closed: {rounds} rounds, {compactions} compactions, "
             f"arena prefix {ends[0][1]} -> {ends[-1][2]} slots")
    ctx.note("round ms by tenth of the window: " + " ".join(
        f"{x:.1f}" for x in tenths([t for t, _, _, _ in ends])))
    for name in ("plan", "apply", "walk"):
        xs = ctx.spans.times.get(name, [])
        ctx.note(f"{name} ms by tenth of the untraced rounds: " + " ".join(
            f"{1e3 * float(np.mean(p)):.1f}" for p in np.array_split(np.array(xs), 10) if p.size))

    checks = check(ctx, base, n, pool, judged, final, steps)
    return Outcome(
        e2e={"round_ms": 1e3 * ctx.window_s / rounds},
        record={"rounds": rounds, "traced_walks": traced_walks,
                "round_s_untraced": untraced_round_s(ends)},
        attempted=rounds, failed=0, checks=checks)


def untraced_round_s(ends: list):
    """Mean seconds of the rounds run before the profiler started (their
    host work at full speed); None when every round was traced."""
    times = np.diff([0.0, *(t for t, _, _, _ in ends)])
    plain = [d for d, e in zip(times, ends) if not e[3]]
    return float(np.mean(plain)) if plain else None


def tenths(ends: list) -> list:
    """Mean ms a round over each tenth of the rounds, from their end times."""
    times = np.diff([0.0, *ends]) * 1e3
    return [float(part.mean()) for part in np.array_split(times, 10) if part.size]


def check(ctx, base, n: int, pool, judged: dict, final, steps: int) -> list:
    """The graph after the last judged round and each judged walk against
    the reference replaying the pool's rounds in order."""
    dev = ctx.device
    ref = RefGraph(*base, n, dev)
    ones = torch.ones((1, n), dtype=torch.float32)
    readings, done = [], 0
    for r in sorted(judged):
        ref.apply([system.round_batch(pool, j) for j in range(done, r + 1)])
        done = r + 1
        rows, cols = ref.rows_cols()
        want = ref_walk.walk(rows, cols, n, ones, steps, normalize=True)
        got = (ref_walk.walk(rows, cols, n, ones, steps, normalize=True, dtype=torch.bfloat16)
               if ctx.control else judged[r].reshape(1, n))
        readings.append(ref_walk.walk_readings(got, want))
        del rows, cols, want, got
    if ctx.control:
        rows, cols = ref.rows_cols()
        final = (rows, cols, ref.wgt.to(torch.bfloat16).to(torch.float32))
    return checks_of(ctx.limits, ref_walk.edges_wrong(*final, ref), readings)


def checks_of(limits: dict, edges_wrong: int, readings: list) -> list:
    """The graph's check and each walk number's, over the worst judged walk."""
    return [Check("edges_wrong", edges_wrong, limits["edges_wrong"])] + [
        Check(name, max(x[name] for x in readings), limits[name]) for name in readings[0]]
