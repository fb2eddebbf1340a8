#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/``), then runs the paper's four DiGraph tasks on an R-MAT "social"
graph at scale 21 (2,097,152 vertices, ~67M directed edges, the size of
SNAP's soc-LiveJournal1):

  load    COO -> CSR on the card (device sort + the count_degrees kernel),
          bit-identical to the host engine; CSR -> DiGraph arena
  clone   deep copy, equal buffers
  update  deletion (1e-3 |E|), insertion (1e-3 |E|) and mixed (1e-2 |E|)
          batches through the merge_rows kernel, each held bit for bit
          against a twin graph run on the plain PyTorch merge; a snapshot
          taken first must not change
  walk    the 42-step reverse walk (timed; unnormalised it overflows f32),
          and the normalised walk held against the plain tile cumsum
  walk_slotted
          the interval-less 42-step walk over the same arena through the
          slot_walk_partials kernel (timed), one walk and four batched,
          held against the plain partials and the image walk; the split
          of one step (gather, partials, seam fold)
  walk_bsr
          a road graph at scale 24 (16,777,216 vertices, ~36.9M directed
          edges, the class of SuiteSparse's asia_osm) re-blocked into
          128x128 BSR tiles on the card (~393K tiles, ~25.8 GB), and the
          42-step walk as iterated bsr_spmm launches (timed), held against
          the plain SpMM walk and the road DiGraph's walks
  segment_sum
          GNN neighbour aggregation over the social CSR (each edge's row,
          its destination's features drawn from the seed) at D = 16 and
          D = 64 through the edge_segment_partials kernel (timed: op,
          kernel, fold, and the library index_add_), held against float64
          sums, the library index_add_ and the plain op
  two_tower
          the two-tower retrieval model at its FULL width (two 10M x 256
          tables, towers 1024-512-256) serving serve_p99 (512 pairs),
          serve_bulk (262,144 pairs) and retrieval_cand (one query, 10^6
          candidates) through the embedding_bag kernel (timed, on full
          bags), held against the plain bag (on ragged bags as well), the
          tiled-query serve and the library embedding_bag; each tower's
          bag time against its MLP time
  transformer
          h2o-danube-1.8b at full width (24 layers, d_model 2560, 32/8
          heads of 80, window 4096, random weights from the seed) with
          attn_impl="flash": one 32,768-token prefill (prefill_32k, batch
          cut to 1) through 24 flash_attention launches, all on its
          tensor-core (wgmma) kernel (timed, with the kernels' share),
          held against the plain attention at 8,192 tokens (in float32;
          in bfloat16, the distance from the float32 model against that
          of the bfloat16 model with the plain attention); the kernel's
          TFLOP/s on the visible pairs beside SDPA's flash backend on plain
          causal attention at the same shape (a yardstick); decode_32k
          (batch 128 against a 4,096-slot bfloat16 ring filled from the
          seed, 8 greedy steps timed); prefill against 64 decode steps in
          float32

then holds each kernel against its plain PyTorch version at the shapes its
path gave it and times both.  The line before the last is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
Any failed check raises, so the exit code is non-zero and no result line
is printed.  Without a CUDA device it exits non-zero at once.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SCALE = 21
EDGE_FACTOR = 16
SEED = 42
WALK_STEPS = 42
#: the road graph of the BSR walk: 2^24 vertices
ROAD_SCALE = 24
#: H100 SXM device-memory rate (NVIDIA data sheet) for the byte bounds
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM non-tensor float32 rate, used for the operation bounds
VECTOR_OPS_PER_S = 67e12
#: H100 SXM dense bfloat16 tensor-core rate: flash_attention's bound (its
#: bfloat16 inputs make every product exact in float32, so the tensor
#: cores could do its work)
TENSOR_BF16_OPS_PER_S = 989e12
#: normalised walks, kernel vs plain intra-tile scan: rtol is the hub-row
#: envelope of the uncompensated intra-tile level; the visits are <= 1 and a
#: row whose exact sum is 0 keeps the rounding residue of its tile's prefix
#: (~ulp of the tile sum, added in another order), hence the small atol
WALK_RTOL, WALK_ATOL = 5e-4, 1e-6
#: unnormalised walks whose steps sum only non-negative terms, in another
#: order (the road graph's BSR walk against its plain version and against
#: the interval-less walk): no cancellation, a few ulps a step
EXACT_WALK_RTOL = 1e-4
#: slot_walk_partials: a run of n <= 128 non-negative terms summed in two
#: orders; each is within (n-1)*2^-24 of the exact sum
PARTIALS_RTOL = 2 * 127 * 2.0**-24
#: bsr_spmm: each output sums the few non-zero products of a row in
#: another order (non-negative terms)
SPMM_RTOL = 1e-5
#: the segment sum's widths: gcn-cora's and schnet's d_hidden
SEG_WIDTHS = (16, 64)
#: the width whose edge_segment_partials launch fills the kernels line
SEG_ROW_D = 16
#: float32 unit roundoff: a sum of n terms in any order is within
#: (n-1)*U*sum|terms| of the exact sum
U = 2.0**-24
#: tiles per chunk when the segment partials are held against the plain
#: version (bounds the plain version's scratch at D = 64)
SEG_CHECK_TILES = 1 << 16
#: two-tower serving scores, bag kernel against the plain bag (the same
#: MLP on pooled inputs that differ in the last bits)
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
#: host-synced serve_p99 calls whose 50th and 99th percentiles are printed
P99_CALLS = 200
#: pairs of ragged bags (empty bags included) checked against the plain bag
RAGGED_BATCH = 4096
#: prefill_32k's batch of 32 sequences cut to 1: the batch's logits alone
#: would be 67 GB
PREFILL_BATCH = 1
#: prompt length of the model-level check against the plain attention
#: (longer than the 4,096-key window)
LM_CHECK_LEN = 8192
#: the model-level check runs in float32, where the kernel and the plain
#: attention differ only in the order of their f32 sums (at worst
#: gamma_4096 = 2^-12 of max|v| a layer, ~1e-6 relative in practice); the
#: bfloat16 model's logits differ from its plain-attention twin's by
#: compounding one-ulp rounding flips (280 of 262,144,000 logits beyond
#: 2^-4 at 8,192 tokens on the FMA kernel), so that comparison is printed
LM_CHECK_TOL = 1e-3
#: the bfloat16 model is held against the float32 model with the plain
#: attention instead: the RMS distance of its logits (through the kernel)
#: may exceed that of the bfloat16 model with the plain attention by at
#: most this factor.  Both distances come from the bfloat16 roundings of
#: every projection and attention output; the kernel's own error (~2^-17
#: relative, the hi/lo split of p) is far below them
LM_BF16_RMS_RATIO = 1.10
#: greedy decode steps timed after a warm-up step
DECODE_STEPS = 8
#: prefill against decode: prompt length, batch and the tolerance of
#: repro's own check (tests/test_models.py:46; the bfloat16 cache rounds
#: K and V that forward keeps in float32)
PD_LEN, PD_BATCH, PD_TOL = 64, 2, 2e-2


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs attention computes: key j is visible to query i
    when j <= i (causal) and j > i - window (window > 0)."""
    q = np.arange(sq)
    hi = np.minimum(q + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(q - window + 1, 0) if window > 0 else 0
    return int(np.maximum(hi - lo, 0).sum())


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance of two bfloat16 tensors in units in the last place."""
    def key(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits + 32768), bits)
    return (key(a) - key(b)).abs()


def flash_sass(lib_path: str, nvcc: str) -> dict:
    """Tensor-core (HGMMA, HMMA) and TMA (UTMALDG) instructions in the
    built library's SASS, in flash_attention's tensor-core kernel at D = 80
    (``tc80``) and in its FMA kernels at every head dim (``fma``)."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    ops = ("HGMMA", "HMMA", "UTMALDG")
    counts = {"tc80": dict.fromkeys(ops, 0), "fma": dict.fromkeys(ops, 0)}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = ("tc80" if "flash_attention_tcILi80E" in line
                  else "fma" if "flash_attention_kernel" in line else None)
        elif fn:
            for op in ops:
                counts[fn][op] += f" {op}" in line
    return counts


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def sync_now() -> float:
    """Host clock once the device has finished all queued work, so a timed
    call never waits for an earlier (warm-up) call's kernels."""
    torch.cuda.synchronize()
    return time.perf_counter()


def sync_s(t0: float) -> float:
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def expect_launches(name: str, n: int, phase: str) -> None:
    """The wrapper's count, zeroed by ``counted`` on entry, is ``n``."""
    from repro_torch.kernels import KERNELS

    if KERNELS[name].launches != n:
        raise AssertionError(
            f"{phase}: {name} launched {KERNELS[name].launches} times, expected {n}")


def checksum(t: torch.Tensor) -> int:
    """Position-weighted sum of a 4-byte buffer's bit patterns."""
    bits = t.view(torch.int32).to(torch.int64)
    pos = torch.arange(bits.shape[0], device=t.device) % 65521 + 1
    return int((bits * pos).sum())


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def assert_same_state(a, b, what: str) -> None:
    ta, tb = a.state_tree(), b.state_tree()
    for key in ta:
        if not np.array_equal(ta[key], tb[key]):
            raise AssertionError(f"{what}: state_tree[{key!r}] differs")


@contextlib.contextmanager
def counted(kernels: dict, launches: dict):
    """Count the kernel launches of one main-path call: every wrapper's
    count is set to 0 on entry and added to ``launches`` on exit."""
    for k in kernels.values():
        k.launches = 0
    yield
    for name, k in kernels.items():
        launches[name] += k.launches


@contextlib.contextmanager
def largest_call(module, name: str, size):
    """Keep the arguments of the largest call (by ``size(args)``) made to
    ``module.name`` while active; the call itself goes through unchanged."""
    inner = getattr(module, name)
    seen = {}

    def spy(*args, **kwargs):
        if not seen or size(args) > size(seen["args"]):
            seen["args"] = args
        return inner(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, inner)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    start = time.perf_counter()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.configs import base as cfg_base
    from repro_torch.configs import h2o_danube_1_8b, two_tower_retrieval
    from repro_torch.core import DiGraph, csr, edgebatch, traversal, updates, util
    from repro_torch.io import synthetic
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.kernels.bsr_spmm import kernel as bsr_kernel
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops
    from repro_torch.kernels.csr_build import kernel as cb_kernel
    from repro_torch.kernels.edge_segment_sum import kernel as seg_kernel
    from repro_torch.kernels.edge_segment_sum import ops as seg_ops
    from repro_torch.kernels.embedding_bag import kernel as bag_kernel
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.slot_update import kernel as su_kernel
    from repro_torch.kernels.slot_update import ops as su_ops
    from repro_torch.kernels.slot_walk import kernel as sw_kernel
    from repro_torch.kernels.slot_walk import ops as sw_ops
    from repro_torch.models.recsys import two_tower
    from repro_torch.models.transformer import attention as tattn
    from repro_torch.models.transformer import model as tm

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. env -------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.library()
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), build_s=f"{time.perf_counter() - t0:.2f}")

    # 2. graph -------------------------------------------------------------
    t0 = sync_now()
    src, dst, wgt, n = synthetic.make_coo(
        "social", scale=SCALE, edge_factor=EDGE_FACTOR, seed=SEED
    )
    gen_s = time.perf_counter() - t0
    t0 = sync_now()
    c = csr.from_coo(src, dst, wgt, n=n, device=dev)  # make_graph's dedup CSR
    dedup_s = time.perf_counter() - t0
    say("graph", kind="social", scale=SCALE, n=n, m_raw=src.shape[0], m=c.m,
        max_degree=int(c.degrees.max()), host_gen_s=f"{gen_s:.1f}",
        host_dedup_s=f"{dedup_s:.1f}")

    # main path: its calls run inside ``counted``; the checks between them
    # (host engine, plain twin, warm-up, normalised walks) launch outside it
    launches = dict.fromkeys(KERNELS, 0)
    times = {}

    # 3. load (paper task 1) --------------------------------------------
    t0 = sync_now()
    with counted(KERNELS, launches):
        raw = csr.from_coo(src, dst, wgt, n=n, dedup=False, engine="cuda", device=dev)
    times["load_coo_ms"] = sync_s(t0) * 1e3
    host = csr.from_coo(src, dst, wgt, n=n, dedup=False, engine="host", device=dev)
    for f in ("offsets", "dst", "wgt"):
        if not torch.equal(getattr(raw, f), getattr(host, f)):
            raise AssertionError(f"load: cuda engine {f} differs from the host engine")
    del host
    t0 = sync_now()
    with counted(KERNELS, launches):
        g = DiGraph.from_csr(c, device=dev)
    times["load_arena_ms"] = sync_s(t0) * 1e3
    say("load", m_raw=raw.m, cap_e=g.cap_e, bump=g.layout.bump,
        coo_to_csr_ms=f"{times['load_coo_ms']:.1f}",
        csr_to_arena_ms=f"{times['load_arena_ms']:.1f}", host_engine="bit-identical")
    del raw

    # 4. clone (paper task 2) -------------------------------------------
    t0 = sync_now()
    with counted(KERNELS, launches):
        twin = g.clone()
    times["clone_ms"] = sync_s(t0) * 1e3
    for f in ("dst", "wgt", "slot_rows"):
        if not torch.equal(getattr(twin, f), getattr(g, f)):
            raise AssertionError(f"clone: {f} differs")
    say("clone", ms=f"{times['clone_ms']:.2f}", buffers="equal")

    # 5. update (paper task 3) ------------------------------------------
    snap = g.snapshot()
    sums = {f: checksum(getattr(snap, f)) for f in ("dst", "wgt", "slot_rows")}
    rng = np.random.default_rng(SEED + 1)
    m0 = g.m
    n_small = round(1e-3 * m0)
    n_half = round(0.5e-2 * m0)
    batches = [
        ("delete", lambda: updates.plan_update(
            deletes=edgebatch.random_deletions(rng, g.to_csr(), n_small))),
        ("insert", lambda: updates.plan_update(
            inserts=edgebatch.random_insertions(rng, n, n_small, weighted_range=(0.5, 1.5)))),
        ("mixed", lambda: updates.plan_update(
            inserts=edgebatch.random_insertions(rng, n, n_half, weighted_range=(0.5, 1.5)),
            deletes=edgebatch.random_deletions(rng, g.to_csr(), n_half))),
    ]
    merge_case = None
    for name, make in batches:
        plan = make()
        # keep the mixed batch's largest [A,W] x [A,K] merge, as dispatched
        spy = contextlib.nullcontext({}) if name != "mixed" else largest_call(
            su_ops, "merge_rows", lambda args: args[0].numel() + args[3].numel())
        t0 = sync_now()
        with counted(KERNELS, launches), spy as seen:
            _, dm = g.apply(plan)
        times[f"{name}_ms"] = sync_s(t0) * 1e3
        merge_case = seen.get("args", merge_case)
        t0 = sync_now()
        twin.apply(plan, backend="torch")
        plain_ms = sync_s(t0) * 1e3
        assert_same_state(g, twin, f"update/{name}")
        if g.m != int(g.degrees.sum()):
            raise AssertionError(f"update/{name}: m != degrees.sum()")
        say("update", batch=name, ops=plan.n_ops, rows=plan.n_rows, dm=dm, m=g.m,
            ms=f"{times[f'{name}_ms']:.1f}", plain_twin_ms=f"{plain_ms:.1f}",
            twin="state_tree identical")
    for f, s in sums.items():
        if checksum(getattr(snap, f)) != s:
            raise AssertionError(f"update: snapshot buffer {f} changed")
    say("update", snapshot="unchanged")
    del twin, snap

    # 6. walk (paper task 4) --------------------------------------------
    g.reverse_walk(1)  # warm-up: allocator and interval cache
    t0 = sync_now()
    with counted(KERNELS, launches):
        v = g.reverse_walk(WALK_STEPS)
    times["walk_ms"] = sync_s(t0) * 1e3
    nv = g.n_max_vertex() + 1
    if tuple(v.shape) != (nv,):
        raise AssertionError(f"walk: shape {tuple(v.shape)} != ({nv},)")
    img = g.to_walk_image()
    vk = img.walk(WALK_STEPS, normalize=True, backend="cuda")
    vp = img.walk(WALK_STEPS, normalize=True, backend="torch")
    if not (bool(torch.isfinite(vk).all()) and bool(torch.isfinite(vp).all())):
        raise AssertionError("walk: non-finite normalised visits")
    diff = (vk - vp).abs()
    nz = vp != 0
    rel = float((diff[nz] / vp[nz].abs()).max())
    torch.testing.assert_close(vk, vp, rtol=WALK_RTOL, atol=WALK_ATOL)
    say("walk", steps=WALK_STEPS, nv=nv, edges_hi=img.edges_hi(),
        ms=f"{times['walk_ms']:.1f}", normalized_max_abs_diff=f"{float(diff.max()):.3e}",
        normalized_max_rel_diff_nonzero=f"{rel:.3e}")

    # 7. walk_slotted (paper task 4, interval-less rank tiles) -------------
    phase_s = {}
    p0 = time.perf_counter()
    ehi = img.edges_hi()
    traversal.reverse_walk_slotted(g.dst, g.slot_rows, 1, nv, edges_hi=ehi)  # warm-up
    t0 = sync_now()
    with counted(KERNELS, launches):
        vs = traversal.reverse_walk_slotted(g.dst, g.slot_rows, WALK_STEPS, nv, edges_hi=ehi)
    times["walk_slotted_ms"] = sync_s(t0) * 1e3
    expect_launches("slot_walk_partials", WALK_STEPS, "walk_slotted")
    if tuple(vs.shape) != (nv,):
        raise AssertionError(f"walk_slotted: shape {tuple(vs.shape)} != ({nv},)")
    del vs
    vsk = traversal.reverse_walk_slotted(g.dst, g.slot_rows, WALK_STEPS, nv, edges_hi=ehi,
                                         normalize=True, backend="cuda")
    vsp = traversal.reverse_walk_slotted(g.dst, g.slot_rows, WALK_STEPS, nv, edges_hi=ehi,
                                         normalize=True, backend="torch")
    if not bool(torch.isfinite(vsk).all()):
        raise AssertionError("walk_slotted: non-finite normalised visits")
    torch.testing.assert_close(vsk, vsp, rtol=WALK_RTOL, atol=WALK_ATOL)
    torch.testing.assert_close(vsk, vk, rtol=WALK_RTOL, atol=WALK_ATOL)
    v0 = np.ones((4, nv), np.float32)
    v0[1:] = np.random.default_rng(SEED).random((3, nv), dtype=np.float32)
    v0 = torch.from_numpy(v0).to(dev)
    batched = dict.fromkeys(KERNELS, 0)
    t0 = sync_now()
    with counted(KERNELS, batched):
        vbk = traversal.reverse_walk_slotted(g.dst, g.slot_rows, WALK_STEPS, nv, edges_hi=ehi,
                                             normalize=True, visits0=v0)
    times["walk_slotted_b4_ms"] = sync_s(t0) * 1e3
    expect_launches("slot_walk_partials", WALK_STEPS, "walk_slotted/B=4")
    vbp = traversal.reverse_walk_slotted(g.dst, g.slot_rows, WALK_STEPS, nv, edges_hi=ehi,
                                         normalize=True, visits0=v0, backend="torch")
    if tuple(vbk.shape) != (4, nv):
        raise AssertionError(f"walk_slotted/B=4: shape {tuple(vbk.shape)} != (4, {nv})")
    torch.testing.assert_close(vbk, vbp, rtol=WALK_RTOL, atol=WALK_ATOL)
    torch.testing.assert_close(vbk[0], vsk, rtol=WALK_RTOL, atol=WALK_ATOL)
    del vbk, vbp, v0, vsp
    # one step's split, at the walk's shapes (normalised visits as input)
    rows_f, gidx_f = sw_ops._prep(g.dst, g.slot_rows, nv, ehi)
    sw_rows = rows_f.to(torch.int32).reshape(-1, sw_kernel.EB)
    del rows_f
    vis = torch.cat([vsk, vsk.new_zeros(1)])[None]
    gather = lambda: vis.index_select(1, gidx_f).reshape(-1, sw_kernel.EB)  # noqa: E731
    sw_vals = gather()
    part, rank = sw_kernel.slot_walk_partials(sw_rows, sw_vals, nv)
    split = dict(
        step_ms=time_ms(lambda: sw_ops._fold_live(
            *sw_kernel.slot_walk_partials(sw_rows, gather(), nv), 1, nv)),
        gather_ms=time_ms(gather),
        partials_ms=time_ms(lambda: sw_kernel.slot_walk_partials(sw_rows, sw_vals, nv)),
        fold_ms=time_ms(lambda: sw_ops._fold_live(part, rank, 1, nv)),
    )
    live = float((rank < nv).float().mean())
    del part, rank, gidx_f, vis
    say("walk_slotted", steps=WALK_STEPS, nv=nv, edges_hi=ehi, tiles=sw_rows.shape[0],
        ms=f"{times['walk_slotted_ms']:.1f}", b4_ms=f"{times['walk_slotted_b4_ms']:.1f}",
        **{k: f"{v_:.4f}" for k, v_ in split.items()},
        fold_share=f"{split['fold_ms'] / split['step_ms']:.3f}",
        live_rank_share=f"{live:.4f}",
        vs_plain="rtol 5e-4", vs_image_walk="rtol 5e-4", b4_vs_plain="rtol 5e-4")
    phase_s["walk_slotted_s"] = time.perf_counter() - p0

    # 8. walk_bsr (paper task 4 as iterated block-sparse SpMM) ------------
    p0 = t0 = sync_now()
    rsrc, rdst, _, rn = synthetic.make_coo("road", scale=ROAD_SCALE, seed=SEED,
                                           weighted=False)
    road_gen_s = time.perf_counter() - t0
    t0 = sync_now()
    road = csr.from_coo(rsrc, rdst, n=rn, device=dev)  # dedup: one entry per pair
    road_dedup_s = time.perf_counter() - t0
    del rsrc, rdst
    t0 = sync_now()
    bsr = bsr_ops.csr_to_bsr(road)
    times["bsr_build_ms"] = sync_s(t0) * 1e3
    nnzb = bsr.block_cols.shape[0]
    n_rb = bsr.row_ptr.shape[0] - 1
    say("walk_bsr", graph="road", scale=ROAD_SCALE, n=rn, m=road.m, nnzb=nnzb,
        tiles_gb=f"{bsr.blocks.numel() * 4 / 1e9:.2f}",
        blocks_per_row_block=f"{nnzb / n_rb:.4f}", max_blocks_per_row=bsr.max_blocks_per_row,
        host_gen_s=f"{road_gen_s:.1f}", host_dedup_s=f"{road_dedup_s:.1f}",
        build_ms=f"{times['bsr_build_ms']:.1f}")
    bsr_ops.reverse_walk_bsr(bsr, 1, rn)  # warm-up
    t0 = sync_now()
    with counted(KERNELS, launches):
        vb = bsr_ops.reverse_walk_bsr(bsr, WALK_STEPS, rn)
    times["walk_bsr_ms"] = sync_s(t0) * 1e3
    expect_launches("bsr_spmm", WALK_STEPS, "walk_bsr")
    if tuple(vb.shape) != (rn,) or not bool((torch.isfinite(vb) & (vb > 0)).all()):
        raise AssertionError("walk_bsr: visits not finite and positive of shape (n,)")
    vbp = bsr_ops.reverse_walk_bsr(bsr, WALK_STEPS, rn, backend="torch")
    torch.testing.assert_close(vb, vbp, rtol=EXACT_WALK_RTOL, atol=0.0)
    rel_plain = float(((vb - vbp).abs() / vbp).max())
    del vbp
    rg = DiGraph.from_csr(road, device=dev)
    rnv = rg.n_max_vertex() + 1
    vr = traversal.reverse_walk_slotted(rg.dst, rg.slot_rows, WALK_STEPS, rnv,
                                        edges_hi=rg.to_walk_image().edges_hi())
    torch.testing.assert_close(vb[:rnv], vr, rtol=EXACT_WALK_RTOL, atol=0.0)
    rel_slotted = float(((vb[:rnv] - vr).abs() / vr).max())
    # the image walk's prefix differences keep ~ulp of a tile's running sum:
    # on a road graph the visits span ~10 orders of magnitude, so small rows
    # lose their digits (repro's DiGraph walk does the same); held after
    # normalising, at the image walk's own tolerances
    vi = rg.reverse_walk(WALK_STEPS)
    rel_image = float(((vb[:rnv] - vi).abs() / vb[:rnv]).max())
    torch.testing.assert_close(vi / vi.max(), vb[:rnv] / vb.max(), rtol=WALK_RTOL,
                               atol=WALK_ATOL)
    del vr, vi, rg
    say("walk_bsr", steps=WALK_STEPS, ms=f"{times['walk_bsr_ms']:.1f}",
        max_rel_diff_plain=f"{rel_plain:.3e}", max_rel_diff_slotted=f"{rel_slotted:.3e}",
        max_rel_diff_image_walk=f"{rel_image:.3e}", vs_plain="rtol 1e-4",
        vs_slotted="rtol 1e-4", vs_image_walk="normalised, rtol 5e-4")

    # bsr_spmm against its plain version at the walk's shapes, while the
    # tiles are on the card (freed before the other kernel rows)
    x = torch.zeros((bsr.n_cols, 8), dtype=torch.float32, device=dev)
    x[:rn, 0] = vb / vb.max()
    del vb
    bargs = (bsr.row_ptr, bsr.block_cols, bsr.blocks, x)
    got, ref = bsr_kernel.bsr_spmm(*bargs, d_tile=8), bsr_kernel.bsr_spmm_torch(*bargs)
    torch.testing.assert_close(got, ref, rtol=SPMM_RTOL, atol=0.0)
    bsr_row = dict(
        name="bsr_spmm", source="src/repro_torch/csrc/bsr_spmm.cu",
        replaces="src/repro/kernels/bsr_spmm/kernel.py:53",
        shape=f"nnzb={nnzb} R={n_rb} D=8 d_tile=8", max_abs_err=float((got - ref).abs().max()),
        tolerance="rtol 1e-5",
        ms=time_ms(lambda: bsr_kernel.bsr_spmm(*bargs, d_tile=8)),
        plain_ms=time_ms(lambda: bsr_kernel.bsr_spmm_torch(*bargs), reps=5),
        library_ms=None,
        bytes=nnzb * 128 * 128 * 4 + (n_rb + 1) * 4 + nnzb * 4 + x.numel() * 4 + got.numel() * 4,
        ops=2 * nnzb * 128 * 128 * 8,
    )
    try:  # the yardstick only: PyTorch's own BSR product, if it runs on CUDA
        a_sp = torch.sparse_bsr_tensor(bsr.row_ptr, bsr.block_cols, bsr.blocks[:nnzb],
                                       size=(bsr.n_rows, bsr.n_cols), check_invariants=False)
        lib = a_sp @ x
        torch.testing.assert_close(lib, ref, rtol=SPMM_RTOL, atol=0.0)
        bsr_row["library_ms"] = time_ms(lambda: a_sp @ x, reps=5)
        lib_note = "torch.sparse_bsr_tensor @ x"
        del lib, a_sp
    except (RuntimeError, NotImplementedError, AssertionError) as e:
        lib_note = f"none: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    say("walk_bsr", library=lib_note)
    del got, ref, x, bargs, bsr, road
    torch.cuda.empty_cache()
    phase_s["walk_bsr_s"] = time.perf_counter() - p0

    # 9. segment_sum (GNN neighbour aggregation over the social CSR) -------
    p0 = time.perf_counter()
    seg_rows = util.expand_rows(c.offsets, c.m)  # each edge's CSR row, ascending
    dst_l = c.dst.long()
    deg = c.degrees.to(torch.float64)[:, None]
    gamma = deg * U / (1 - deg * U)  # a sum of deg terms: within gamma*sum|terms|
    sgen = torch.Generator(device=dev).manual_seed(SEED)
    seg_row = None
    for d in SEG_WIDTHS:
        h = torch.randn((n, d), generator=sgen, device=dev)
        vals = h.index_select(0, dst_l)  # [E, d]: the symmetrised graph's messages
        op = lambda: seg_ops.edge_segment_sum(seg_rows, vals, num_segments=n)  # noqa: E731
        op()  # warm-up
        t0 = sync_now()
        with counted(KERNELS, launches):
            out = op()
        times[f"seg_sum_d{d}_ms"] = sync_s(t0) * 1e3
        expect_launches("edge_segment_partials", 1, f"segment_sum/D={d}")
        if tuple(out.shape) != (n, d) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"segment_sum/D={d}: not finite of shape ({n}, {d})")
        op_ms = time_ms(op, reps=5)
        lib_fn = lambda: torch.zeros((n, d), device=dev).index_add_(0, seg_rows, vals)  # noqa: E731
        lib = lib_fn()
        library_ms = time_ms(lib_fn, reps=5)
        plain = seg_ops.edge_segment_sum(seg_rows, vals, num_segments=n, backend="torch")
        # float64 sums and each row's sum of |terms|, 8 columns at a time
        ref = torch.empty((n, d), dtype=torch.float64, device=dev)
        absum = torch.empty_like(ref)
        for j in range(0, d, 8):
            hj = h[:, j:j + 8].double().index_select(0, dst_l)
            w = hj.shape[1]
            ref[:, j:j + w] = torch.zeros((n, w), dtype=torch.float64,
                                          device=dev).index_add_(0, seg_rows, hj)
            absum[:, j:j + w] = torch.zeros((n, w), dtype=torch.float64,
                                            device=dev).index_add_(0, seg_rows, hj.abs_())
            del hj
        # any float32 summation of a row's deg terms is within
        # gamma*sum|terms| of the float64 sum; two of them within twice that
        bound = gamma * absum
        out64, lib64 = out.double(), lib.double()
        for what, diff, tol in (("op vs float64", out64 - ref, bound),
                                ("index_add_ vs float64", lib64 - ref, bound),
                                ("op vs index_add_", out64 - lib64, 2 * bound),
                                ("op vs plain op", out64 - plain.double(), 2 * bound)):
            if not bool((diff.abs() <= tol).all()):
                raise AssertionError(f"segment_sum/D={d}: {what} exceeds gamma(deg)*sum|terms|")
        err64 = float((out64 - ref).abs().max())
        lib_err64 = float((lib64 - ref).abs().max())
        err_lib = float((out - lib).abs().max())
        outside = float(((out - lib).abs() > 1e-5 + 1e-5 * lib.abs()).float().mean())
        del lib, plain, ref, absum, bound, out, out64, lib64, diff
        pad_ms = time_ms(lambda: seg_ops._pad(seg_rows, vals, n), reps=5)
        # the tile kernel at the op's own operands, against its plain version
        rows_t, vals_t = seg_ops._pad(seg_rows, vals, n)
        del vals, op, lib_fn
        torch.cuda.empty_cache()
        kp, kr = seg_kernel.edge_segment_partials(rows_t, vals_t, n)
        t_tiles = rows_t.shape[0]
        part_err = 0.0
        for s0 in range(0, t_tiles, SEG_CHECK_TILES):
            sl = slice(s0, s0 + SEG_CHECK_TILES)
            pp, pr = seg_kernel.edge_segment_partials_torch(rows_t[sl], vals_t[sl], n)
            if not torch.equal(kr[sl], pr):
                raise AssertionError(f"edge_segment_partials/D={d}: rank_rows differ from plain")
            ap, _ = seg_kernel.edge_segment_partials_torch(rows_t[sl], vals_t[sl].abs(), n)
            dd = (kp[sl] - pp).abs()
            if not bool((dd <= PARTIALS_RTOL * ap).all()):
                raise AssertionError(
                    f"edge_segment_partials/D={d}: partials exceed 254*2^-24*sum|terms|")
            part_err = max(part_err, float(dd.max()))
            del pp, pr, ap, dd
        live = float((kr < n).float().mean())
        fold_ms = time_ms(lambda: seg_ops._fold_live(kp, kr, n), reps=5)
        del kp, kr
        torch.cuda.empty_cache()
        kernel_ms = time_ms(lambda: seg_kernel.edge_segment_partials(rows_t, vals_t, n))
        plain_ms = time_ms(lambda: seg_kernel.edge_segment_partials_torch(rows_t, vals_t, n),
                           reps=3)
        say("segment_sum", D=d, E=c.m, tiles=t_tiles,
            ms=f"{times[f'seg_sum_d{d}_ms']:.2f}", op_ms=f"{op_ms:.4f}", pad_ms=f"{pad_ms:.4f}",
            kernel_ms=f"{kernel_ms:.4f}", fold_ms=f"{fold_ms:.4f}",
            plain_kernel_ms=f"{plain_ms:.4f}", index_add_ms=f"{library_ms:.4f}",
            live_rank_share=f"{live:.4f}", max_abs_err_vs_float64=f"{err64:.3e}",
            index_add_max_abs_err_vs_float64=f"{lib_err64:.3e}",
            max_abs_diff_vs_index_add=f"{err_lib:.3e}",
            share_outside_1e5_of_index_add=f"{outside:.3e}",
            partials_max_abs_err=f"{part_err:.3e}",
            tolerance="gamma(deg)*sum|terms| (op), 254*2^-24*sum|terms| (partials)")
        if d == SEG_ROW_D:
            e_pad = rows_t.numel()
            seg_row = dict(
                name="edge_segment_partials",
                source="src/repro_torch/csrc/edge_segment_partials.cu",
                replaces="src/repro/kernels/edge_segment_sum/kernel.py:46",
                shape=f"[{t_tiles},128] i32 rows + [{t_tiles},128,{d}] f32 vals",
                max_abs_err=part_err,
                tolerance="rank_rows bit-exact, partials 254*2^-24*sum|terms|",
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bytes=e_pad * (4 + 4 * d + 4 * d + 4), ops=e_pad * d,
            )
        del rows_t, vals_t, h
        torch.cuda.empty_cache()
    del seg_rows, dst_l, deg, gamma
    phase_s["segment_sum_s"] = time.perf_counter() - p0

    # 10. two_tower (two-tower retrieval serving at FULL width) -----------
    p0 = time.perf_counter()
    cfg = two_tower_retrieval.FULL
    tgen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = sync_now()
    model = two_tower.init_model(cfg, generator=tgen, device=dev)
    init_s = sync_s(t0)
    plain_model = model.with_backend("torch")
    kb = cfg.bag_size

    def make_bags(nb: int, nf: int, vocab: int) -> torch.Tensor:
        """Ids uniform over [-1, vocab), as the recsys cells of
        ``src/repro/launch/steps.py`` draw them: practically full bags."""
        return torch.randint(-1, vocab, (nb, nf, kb), generator=tgen, device=dev,
                             dtype=torch.int32)

    def make_ragged_bags(nb: int, nf: int, vocab: int) -> torch.Tensor:
        """Bags cut to a ragged -1 tail (lengths uniform in 0..K), so empty
        bags and the mean's count are exercised; checked, never timed."""
        lens = torch.randint(0, kb + 1, (nb, nf, 1), generator=tgen, device=dev)
        return torch.where(torch.arange(kb, device=dev) < lens, make_bags(nb, nf, vocab), -1)

    shapes = cfg_base.RECSYS_SHAPES
    serve = {}
    for name in ("serve_p99", "serve_bulk"):
        b = shapes[name]["batch"]
        batch = {"user_bags": make_bags(b, cfg.n_user_fields, cfg.n_users),
                 "item_bags": make_bags(b, cfg.n_item_fields, cfg.n_items)}
        model.serve_step(batch)  # warm-up
        t0 = sync_now()
        with counted(KERNELS, launches):
            scores = model.serve_step(batch)
        times[f"{name}_ms"] = sync_s(t0) * 1e3
        expect_launches("embedding_bag", 2, f"two_tower/{name}")
        if tuple(scores.shape) != (b,) or not bool(torch.isfinite(scores).all()):
            raise AssertionError(f"two_tower/{name}: scores not finite of shape ({b},)")
        torch.testing.assert_close(scores, plain_model.serve_step(batch),
                                   rtol=SCORE_RTOL, atol=SCORE_ATOL)
        serve[name] = dict(batch=batch, event_ms=time_ms(lambda: model.serve_step(batch),
                                                         reps=20 if b < 4096 else 5))
    # serve_p99's latency spread: host-synced calls one after another
    p99_batch = serve["serve_p99"]["batch"]
    lat = []
    for _ in range(P99_CALLS):
        t0 = sync_now()
        model.serve_step(p99_batch)
        lat.append(sync_s(t0) * 1e3)
    p99_lat = np.percentile(lat, [50, 99])
    # ragged bags: the model and the bag kernel against the plain bag
    rag = {"user_bags": make_ragged_bags(RAGGED_BATCH, cfg.n_user_fields, cfg.n_users),
           "item_bags": make_ragged_bags(RAGGED_BATCH, cfg.n_item_fields, cfg.n_items)}
    scores = model.serve_step(rag)
    if not bool(torch.isfinite(scores).all()):
        raise AssertionError("two_tower/ragged: scores not finite")
    torch.testing.assert_close(scores, plain_model.serve_step(rag),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    table = model.user.table
    # mean of <= K rows summed in two roundings (FMA, product then add):
    # within 2*K*U*sum|row| <= 2*K*K*U*max|table| of each other
    bag_atol = 2 * kb * kb * U * float(table.abs().max())
    idx = rag["user_bags"].reshape(-1, kb)
    wts = torch.ones(idx.shape, dtype=torch.float32, device=dev)
    got = bag_kernel.embedding_bag(table, idx, wts, "mean")
    torch.testing.assert_close(got, bag_kernel.embedding_bag_torch(table, idx, wts, "mean"),
                               rtol=0.0, atol=bag_atol)
    empty = (idx < 0).all(dim=1)
    n_empty = int(empty.sum())
    if n_empty == 0 or bool((got[empty] != 0).any()):
        raise AssertionError("two_tower/ragged: no empty bag, or an empty bag not pooled to 0")
    del rag, scores, idx, wts, got, empty
    ub = make_bags(1, cfg.n_user_fields, cfg.n_users)
    n_cand = shapes["retrieval_cand"]["n_candidates"]
    cb = make_bags(n_cand, cfg.n_item_fields, cfg.n_items)
    model.score_candidates(ub, cb)  # warm-up
    t0 = sync_now()
    with counted(KERNELS, launches):
        cand = model.score_candidates(ub, cb)
    times["retrieval_ms"] = sync_s(t0) * 1e3
    expect_launches("embedding_bag", 2, "two_tower/retrieval_cand")
    if tuple(cand.shape) != (n_cand,) or not bool(torch.isfinite(cand).all()):
        raise AssertionError(f"two_tower/retrieval_cand: scores not finite of shape ({n_cand},)")
    torch.testing.assert_close(cand, plain_model.score_candidates(ub, cb),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    pair = model.serve_step({"user_bags": ub.expand(n_cand, -1, -1).contiguous(),
                             "item_bags": cb})
    torch.testing.assert_close(cand, pair, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    retrieval_event_ms = time_ms(lambda: model.score_candidates(ub, cb), reps=5)
    del pair, cand, plain_model
    # each tower's bag time against its MLP time, at serve_bulk
    bulk = serve["serve_bulk"]["batch"]
    tower_split = {}
    for tname, tower in (("user", model.user), ("item", model.item)):
        bags = bulk[f"{tname}_bags"]
        pooled = two_tower.pool_fields(tower, bags, cfg)
        tower_split[f"{tname}_bag_ms"] = time_ms(lambda: two_tower.pool_fields(tower, bags, cfg),
                                           reps=5)
        tower_split[f"{tname}_mlp_ms"] = time_ms(lambda: two_tower.mlp_head(tower, pooled), reps=5)
        del pooled
    # the bag kernel at the serve_bulk user tower's operands
    idx = bulk["user_bags"].reshape(-1, kb)
    wts = torch.ones(idx.shape, dtype=torch.float32, device=dev)
    got = bag_kernel.embedding_bag(table, idx, wts, "mean")
    ref = bag_kernel.embedding_bag_torch(table, idx, wts, "mean")
    torch.testing.assert_close(got, ref, rtol=0.0, atol=bag_atol)
    valid = idx >= 0
    n_valid = int(valid.sum())
    offsets = torch.cumsum(valid.sum(dim=1), 0) - valid.sum(dim=1)
    flat_ids = idx[valid].long()
    # the bound reads each distinct row once
    n_rows = int(torch.unique(flat_ids).numel())
    lib_fn = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
        flat_ids, table, offsets, mode="mean")
    lib = lib_fn()
    torch.testing.assert_close(lib, got, rtol=0.0, atol=bag_atol)
    torch.testing.assert_close(lib, ref, rtol=0.0, atol=bag_atol)
    n_bags = idx.shape[0]
    bag_row = dict(
        name="embedding_bag", source="src/repro_torch/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/kernel.py:61",
        shape=(f"V={table.shape[0]} D={table.shape[1]} B={n_bags} K={kb} valid={n_valid} "
               f"distinct={n_rows} mean"),
        max_abs_err=float((got - ref).abs().max()), tolerance=f"atol 2*K*K*2^-24*max|table| = {bag_atol:.3e}",
        ms=time_ms(lambda: bag_kernel.embedding_bag(table, idx, wts, "mean")),
        plain_ms=time_ms(lambda: bag_kernel.embedding_bag_torch(table, idx, wts, "mean"), reps=5),
        library_ms=time_ms(lib_fn),
        bytes=n_rows * table.shape[1] * 4 + idx.numel() * 8 + n_bags * table.shape[1] * 4,
        ops=2 * n_valid * table.shape[1],
    )
    say("two_tower", config=cfg.name, users=cfg.n_users, items=cfg.n_items,
        embed_dim=cfg.embed_dim, tower_mlp="-".join(map(str, cfg.tower_mlp)),
        tables_gb=f"{(model.user.table.numel() + model.item.table.numel()) * 4 / 1e9:.2f}",
        init_s=f"{init_s:.2f}", serve_p99_ms=f"{times['serve_p99_ms']:.3f}",
        serve_bulk_ms=f"{times['serve_bulk_ms']:.2f}", retrieval_ms=f"{times['retrieval_ms']:.2f}",
        serve_p99_event_ms=f"{serve['serve_p99']['event_ms']:.4f}",
        serve_p99_host_p50_ms=f"{p99_lat[0]:.4f}", serve_p99_host_p99_ms=f"{p99_lat[1]:.4f}",
        serve_bulk_event_ms=f"{serve['serve_bulk']['event_ms']:.4f}",
        retrieval_event_ms=f"{retrieval_event_ms:.4f}",
        **{k_: f"{v_:.4f}" for k_, v_ in tower_split.items()},
        bulk_user_valid_ids=n_valid, bulk_user_distinct_rows=n_rows,
        ragged_batch=RAGGED_BATCH, ragged_empty_user_bags=n_empty,
        library_embedding_bag_ms=f"{bag_row['library_ms']:.4f}",
        vs_plain_bag=f"rtol {SCORE_RTOL}, atol {SCORE_ATOL} (timed and ragged bags)",
        retrieval_vs_tiled_serve=f"rtol {SCORE_RTOL}, atol {SCORE_ATOL}",
        library_vs_kernel_and_plain="agree")
    del got, ref, lib, lib_fn, flat_ids, offsets, valid, wts, idx, table, bulk, serve, ub, cb
    del model
    torch.cuda.empty_cache()
    phase_s["two_tower_s"] = time.perf_counter() - p0

    # 11. transformer (h2o-danube-1.8b prefill and decode, full width) ---
    p0 = time.perf_counter()
    lm_cfg = dataclasses.replace(h2o_danube_1_8b.FULL, attn_impl="flash")
    lgen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = sync_now()
    lm = tm.init_model(lm_cfg, generator=lgen, device=dev)
    lm_init_s = sync_s(t0)
    n_layers, hq, hkv = lm_cfg.n_layers, lm_cfg.n_heads, lm_cfg.n_kv_heads
    dh, win = lm_cfg.head_dim, lm_cfg.sliding_window
    s_len = cfg_base.LM_SHAPES["prefill_32k"]["seq_len"]
    toks = torch.randint(0, lm_cfg.vocab, (PREFILL_BATCH, s_len), generator=lgen, device=dev)
    lm(toks)  # warm-up
    fa_paths = dict(fa_kernel.flash_attention.path_launches)
    t0 = sync_now()
    with counted(KERNELS, launches), largest_call(
            fa_ops, "attention", lambda args: args[0].numel()) as fa_seen:
        logits, _ = lm(toks)
    times["prefill_ms"] = sync_s(t0) * 1e3
    expect_launches("flash_attention", n_layers, "transformer/prefill")
    fa_paths = {k_: n_ - fa_paths[k_] for k_, n_ in fa_kernel.flash_attention.path_launches.items()}
    if fa_paths["wgmma"] != n_layers:
        raise AssertionError(f"transformer/prefill: flash_attention kernels {fa_paths}, expected "
                             f"all {n_layers} on the tensor-core (wgmma) kernel")
    if (tuple(logits.shape) != (PREFILL_BATCH, s_len, lm_cfg.vocab)
            or logits.dtype != lm_cfg.compute_dtype or not bool(torch.isfinite(logits).all())):
        raise AssertionError("transformer/prefill: logits not finite bfloat16 of shape "
                             f"({PREFILL_BATCH}, {s_len}, {lm_cfg.vocab})")
    del logits
    # the split: CUDA events around each kernel call of one more prefill
    fa_events = []
    fa_inner = fa_kernel.flash_attention

    def fa_timed(*args, **kwargs):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = fa_inner(*args, **kwargs)
        ev[1].record()
        fa_events.append(ev)
        return out

    # the wrapper counts on the name it is bound to
    fa_timed.launches = 0
    fa_timed.path_launches = dict.fromkeys(fa_kernel.PATHS, 0)

    whole = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    fa_kernel.flash_attention = fa_timed
    try:
        whole[0].record()
        lm(toks)
        whole[1].record()
    finally:
        fa_kernel.flash_attention = fa_inner
    torch.cuda.synchronize()
    prefill_event_ms = whole[0].elapsed_time(whole[1])
    attn_event_ms = sum(a.elapsed_time(b_) for a, b_ in fa_events)
    pairs = visible_pairs(s_len, s_len, True, win)
    matmul_params = lm_cfg.n_params() - lm_cfg.vocab * lm_cfg.d_model - (2 * n_layers + 1) * lm_cfg.d_model
    proj_flop = 2 * matmul_params * PREFILL_BATCH * s_len
    attn_flop = n_layers * PREFILL_BATCH * hq * 4 * dh * pairs
    say("transformer", config=lm_cfg.name, attn_impl=lm_cfg.attn_impl, layers=n_layers,
        d_model=lm_cfg.d_model, heads=f"{hq}/{hkv}", d_head=dh, window=win,
        params=lm_cfg.n_params(), init_s=f"{lm_init_s:.2f}", prefill_tokens=s_len,
        prefill_batch=f"{PREFILL_BATCH} (prefill_32k's 32 cut to 1)",
        prefill_ms=f"{times['prefill_ms']:.2f}",
        prefill_tokens_per_s=f"{PREFILL_BATCH * s_len / times['prefill_ms'] * 1e3:.1f}",
        model_tflop=f"{proj_flop / 1e12:.2f}+{attn_flop / 1e12:.2f}",
        model_flop_share_of_989=f"{(proj_flop + attn_flop) / (times['prefill_ms'] / 1e3) / TENSOR_BF16_OPS_PER_S:.4f}",
        prefill_event_ms=f"{prefill_event_ms:.2f}", flash_calls=len(fa_events),
        flash_event_ms=f"{attn_event_ms:.2f}", rest_event_ms=f"{prefill_event_ms - attn_event_ms:.2f}",
        flash_share=f"{attn_event_ms / prefill_event_ms:.4f}",
        flash_kernels=",".join(f"{k_}:{n_}" for k_, n_ in fa_paths.items()), card=f"'{smi}'")
    # the kernel at one layer's operands, against its plain version
    fq, fk_, fv = (t.contiguous() for t in fa_seen["args"])
    got = fa_kernel.flash_attention(fq, fk_, fv, causal=True, window=win)
    ref = fa_kernel.flash_attention_torch(fq, fk_, fv, causal=True, window=win)
    fa_atol = 2.0**-12 * float(fv.float().abs().max())
    torch.testing.assert_close(got.float(), ref.float(), rtol=2.0**-7, atol=fa_atol)
    fa_row = dict(
        name="flash_attention", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:81",
        shape=(f"q {list(fq.shape)} k/v {list(fk_.shape)} bf16 causal window {win}, "
               f"{pairs} visible pairs a head"),
        max_abs_err=float((got.float() - ref.float()).abs().max()),
        tolerance=(f"rtol 2^-7 (one bfloat16 rounding), atol 2^-12*max|v| = {fa_atol:.3e} "
                   "(f32 sums of <= 4096 terms in two orders)"),
        ms=time_ms(lambda: fa_kernel.flash_attention(fq, fk_, fv, causal=True, window=win)),
        plain_ms=time_ms(lambda: fa_kernel.flash_attention_torch(fq, fk_, fv, causal=True,
                                                                 window=win), reps=3),
        library_ms=None,
        bytes=(fq.numel() * 2 + fk_.numel() * 2) * fq.element_size(),
        ops=fq.shape[0] * hq * 4 * dh * pairs,
        ops_per_s=TENSOR_BF16_OPS_PER_S, peak="bf16 tensor cores, 989 TFLOP/s",
    )
    # where the kernel and its plain version round an output to different
    # bfloat16 neighbours, against the FMA kernel (float32 on the same
    # bfloat16 values, rounded once: what it computes for bfloat16 inputs)
    fma = fa_kernel.flash_attention(fq.float(), fk_.float(), fv.float(), causal=True,
                                    window=win).bfloat16()
    # (an output near 0 may change sign inside the atol: many ulps apart)
    flips_note = []
    for name_, out_ in (("wgmma", got), ("fma", fma)):
        u = bf16_ulps(out_, ref)
        far = (u > 1) & ((out_.float() - ref.float()).abs() > fa_atol)
        flips_note.append(f"{name_} {float((u > 0).float().mean()):.4e} of outputs "
                          f"({int(far.sum())} beyond one ulp and the atol)")
    flips_note = ", ".join(flips_note)
    del got, fma, u, far
    sass = flash_sass(_build.library()._name, _build._nvcc())
    if (not sass["tc80"]["HGMMA"] or not sass["tc80"]["UTMALDG"]
            or sass["fma"]["HGMMA"] or sass["fma"]["HMMA"]):
        raise AssertionError(f"transformer: flash_attention SASS {sass}: expected HGMMA and "
                             "UTMALDG in the D = 80 bfloat16 kernel, none in the FMA kernels")
    try:  # the yardstick only: PyTorch's SDPA with the explicit mask
        from torch.nn.attention import SDPBackend, sdpa_kernel
        kr = fk_.repeat_interleave(hq // hkv, dim=1)
        vr = fv.repeat_interleave(hq // hkv, dim=1)
        ids = torch.arange(s_len, device=dev)
        mask = (ids[None, :] <= ids[:, None]) & (ids[None, :] > ids[:, None] - win)
        lib_fn = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            fq, kr, vr, attn_mask=mask)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            lib_err = float((lib_fn().float() - ref.float()).abs().max())
            fa_row["library_ms"] = time_ms(lib_fn, reps=5)
        lib_note = (f"F.scaled_dot_product_attention (EFFICIENT_ATTENTION, bool mask, K/V "
                    f"repeated; the full S^2 work, {4 * hq * dh * s_len * s_len / 1e12:.2f} "
                    f"TFLOP), max abs diff vs plain {lib_err:.3e}")
        del kr, vr, mask
    except (RuntimeError, NotImplementedError) as e:
        lib_note = f"none: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    # what a tuned library reaches at head dim 80 on this card: SDPA's flash
    # backend on plain causal attention (no window, K/V repeated, its own
    # S(S+1)/2 pairs a head); a yardstick only, never on the port's path
    causal_flop = 4 * dh * hq * s_len * (s_len + 1) // 2
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        kr = fk_.repeat_interleave(hq // hkv, dim=1)
        vr = fv.repeat_interleave(hq // hkv, dim=1)
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            causal_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                fq, kr, vr, is_causal=True), reps=5)
        causal_note = (f"sdpa_flash_causal_ms={causal_ms:.4f} "
                       f"sdpa_flash_causal_tflops={causal_flop / causal_ms / 1e9:.1f}")
        del kr, vr
    except (RuntimeError, NotImplementedError) as e:
        causal_note = f"none: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    fa_tflops = fa_row["ops"] / fa_row["ms"] / 1e9
    say("transformer", kernel_ms=f"{fa_row['ms']:.4f}", plain_ms=f"{fa_row['plain_ms']:.4f}",
        kernel_tflops_visible=f"{fa_tflops:.1f}",
        kernel_share_of_989=f"{fa_tflops * 1e12 / TENSOR_BF16_OPS_PER_S:.4f}",
        library=lib_note, causal_yardstick=causal_note, flips_vs_plain=flips_note,
        sass=" ".join(f"{fn_}:" + ",".join(f"{op}={n_}" for op, n_ in c.items())
                      for fn_, c in sass.items()))
    del ref, fq, fk_, fv, fa_seen
    torch.cuda.empty_cache()
    # the model against its plain attention, window active: held in
    # float32; in bfloat16 printed, and held against the float32 model
    # beside the bfloat16 model with the plain attention
    short = toks[:, :LM_CHECK_LEN]
    lm_check = {}
    for name, model in (("f32", lm.with_config(compute_dtype=torch.float32)), ("bf16", lm)):
        got, _ = model(short)
        ref, _ = model.with_backend("torch")(short)
        diff = (got.float() - ref.float()).abs()
        lm_check |= {f"{name}_max_abs_diff": f"{float(diff.max()):.3e}",
                     f"{name}_share_differing": f"{float((diff > 0).float().mean()):.3e}",
                     f"{name}_beyond_2^-4": int((diff > 2.0**-4 * (1 + ref.float().abs())).sum()),
                     f"{name}_argmax_agree":
                         f"{float((got.argmax(-1) == ref.argmax(-1)).float().mean()):.6f}"}
        if name == "f32":
            torch.testing.assert_close(got, ref, rtol=LM_CHECK_TOL, atol=LM_CHECK_TOL)
            exact = ref
        else:
            rms = {k_: float((x.float() - exact).square().mean().sqrt())
                   for k_, x in (("kernel", got), ("plain", ref))}
            agree = {k_: float((x.argmax(-1) == exact.argmax(-1)).float().mean())
                     for k_, x in (("kernel", got), ("plain", ref))}
            lm_check |= {
                "bf16_rms_vs_f32": f"{rms['kernel']:.4e}",
                "bf16_plain_rms_vs_f32": f"{rms['plain']:.4e}",
                "bf16_rms_ratio": f"{rms['kernel'] / rms['plain']:.4f}",
                "bf16_argmax_agree_f32": f"{agree['kernel']:.6f}",
                "bf16_plain_argmax_agree_f32": f"{agree['plain']:.6f}"}
            if rms["kernel"] > LM_BF16_RMS_RATIO * rms["plain"]:
                raise AssertionError(
                    f"transformer: the bfloat16 model's logits are {rms['kernel']:.4e} RMS from "
                    f"the float32 model's through the kernel, {rms['plain']:.4e} through the "
                    f"plain attention (limit {LM_BF16_RMS_RATIO}x)")
        del got, ref, diff
    del toks, short, exact
    # decode_32k: batch 128 against the ring, filled from the seed
    dec = cfg_base.LM_SHAPES["decode_32k"]
    db = dec["global_batch"]
    shapes = tm.cache_shapes(lm_cfg, db, dec["seq_len"])
    cache = {"k": torch.empty_like(shapes["k"], device=dev),
             "v": torch.empty_like(shapes["v"], device=dev), "pos": dec["seq_len"]}
    for buf in (cache["k"], cache["v"]):
        for layer in buf:
            layer.normal_(generator=lgen)
    cache_gb = 2 * cache["k"].numel() * cache["k"].element_size() / 1e9
    tok = torch.randint(0, lm_cfg.vocab, (db, 1), generator=lgen, device=dev)
    out, cache = lm.decode_step(cache, tok)  # warm-up
    tok = out.argmax(-1)
    t0 = sync_now()
    with counted(KERNELS, launches):
        for _ in range(DECODE_STEPS):
            out, cache = lm.decode_step(cache, tok)
            tok = out.argmax(-1)
    times["decode_step_ms"] = sync_s(t0) * 1e3 / DECODE_STEPS
    if tuple(out.shape) != (db, 1, lm_cfg.vocab) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"transformer/decode: logits not finite of shape ({db}, 1, "
                             f"{lm_cfg.vocab})")
    if cache["pos"] != dec["seq_len"] + DECODE_STEPS + 1:
        raise AssertionError(f"transformer/decode: pos {cache['pos']} after the steps")
    ring = cache["k"].shape[3]
    # the step's plain attention alone, at one layer's shapes
    dq = torch.randn((db, hq, 1, dh), generator=lgen, device=dev).to(lm_cfg.compute_dtype)
    dec_attn_ms = time_ms(lambda: tattn.decode_attention(dq, cache["k"][0], cache["v"][0], ring),
                          reps=5)
    del cache, out, tok, dq
    torch.cuda.empty_cache()
    # prefill against decode in float32 (forward through the kernel)
    f32 = lm.with_config(compute_dtype=torch.float32)
    ptoks = torch.randint(0, lm_cfg.vocab, (PD_BATCH, PD_LEN), generator=lgen, device=dev)
    full, _ = f32(ptoks)
    pc = tm.init_cache(lm_cfg, PD_BATCH, PD_LEN, device=dev)
    for i in range(PD_LEN):
        last, pc = f32.decode_step(pc, ptoks[:, i:i + 1])
    torch.testing.assert_close(last[:, 0], full[:, -1], rtol=PD_TOL, atol=PD_TOL)
    pd_diff = float((last[:, 0] - full[:, -1]).abs().max())
    del f32, full, pc, last, lm
    torch.cuda.empty_cache()
    say("transformer", decode_batch=db, ring_slots=ring, pos=dec["seq_len"],
        cache_gb=f"{cache_gb:.2f}", decode_steps=DECODE_STEPS,
        decode_step_ms=f"{times['decode_step_ms']:.2f}",
        decode_tokens_per_s=f"{db / times['decode_step_ms'] * 1e3:.1f}",
        decode_attention_ms_a_layer=f"{dec_attn_ms:.4f}",
        decode_attention_share=f"{n_layers * dec_attn_ms / times['decode_step_ms']:.4f}",
        **{f"vs_plain_{k_}": v_ for k_, v_ in lm_check.items()},
        vs_plain_tolerance=(f"float32: rtol=atol={LM_CHECK_TOL} at {LM_CHECK_LEN} tokens; "
                            f"bfloat16: RMS from float32 <= {LM_BF16_RMS_RATIO}x the plain's"),
        prefill_vs_decode_max_abs_diff=f"{pd_diff:.3e}",
        prefill_vs_decode=f"float32, {PD_LEN} tokens x {PD_BATCH}, rtol=atol={PD_TOL}")
    phase_s["transformer_s"] = time.perf_counter() - p0

    say("main_path", **{f"{k}_launches": v_ for k, v_ in launches.items()})
    missing = [k for k, v_ in launches.items() if v_ == 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")

    # small input against the dense oracle, through the same entry points
    small = synthetic.make_graph("social", scale=10, edge_factor=8, seed=7, device=dev)
    sg = DiGraph.from_csr(small, device=dev)
    srng = np.random.default_rng(7)
    sg.apply(updates.plan_update(
        inserts=edgebatch.random_insertions(srng, small.n, 300),
        deletes=edgebatch.random_deletions(srng, small, 300),
    ))
    exp = traversal.reverse_walk_dense_oracle(sg.to_csr().to_dense(), 6)
    got = util.host(sg.reverse_walk(6))
    np.testing.assert_allclose(got, exp[: got.shape[0]], rtol=WALK_RTOL)
    snv = sg.n_max_vertex() + 1
    got = util.host(traversal.reverse_walk_slotted(sg.dst, sg.slot_rows, 6, snv))
    np.testing.assert_allclose(got, exp[:snv], rtol=1e-4)
    rs, rd, _, rsn = synthetic.make_coo("road", scale=10, seed=7, weighted=False)
    rc = csr.from_coo(rs, rd, n=rsn, device=dev)
    got = util.host(bsr_ops.reverse_walk_bsr(bsr_ops.csr_to_bsr(rc), 6, rsn))
    np.testing.assert_allclose(
        got, traversal.reverse_walk_dense_oracle(rc.to_dense(), 6), rtol=1e-5)
    rows_s = util.expand_rows(small.offsets, small.m)
    h_s = np.random.default_rng(7).standard_normal((small.n, 5)).astype(np.float32)
    exp_s = np.zeros((small.n, 5))
    np.add.at(exp_s, util.host(rows_s), h_s[util.host(small.dst)].astype(np.float64))
    got_s = seg_ops.edge_segment_sum(rows_s, torch.from_numpy(h_s).to(dev)[small.dst.long()],
                                     num_segments=small.n)
    np.testing.assert_allclose(util.host(got_s), exp_s, rtol=1e-5, atol=1e-5)
    smoke_cfg = two_tower_retrieval.SMOKE
    sm = two_tower.init_model(smoke_cfg, generator=torch.Generator(dev).manual_seed(7),
                              device=dev)
    sm_cpu = two_tower.TwoTower(
        *(two_tower.Tower(t.table.cpu(), [(w.cpu(), b_.cpu()) for w, b_ in zip(t.w, t.b)],
                          smoke_cfg) for t in (sm.user, sm.item)), smoke_cfg)
    brng = np.random.default_rng(7)
    sbatch = {f"{t}_bags": torch.from_numpy(brng.integers(
        -1, smoke_cfg.n_users, (32, nf, smoke_cfg.bag_size)).astype(np.int32))
        for t, nf in (("user", smoke_cfg.n_user_fields), ("item", smoke_cfg.n_item_fields))}
    np.testing.assert_allclose(
        util.host(sm.serve_step({k_: v_.to(dev) for k_, v_ in sbatch.items()})),
        util.host(sm_cpu.serve_step(sbatch)), rtol=SCORE_RTOL, atol=SCORE_ATOL)
    lm_smoke = dataclasses.replace(h2o_danube_1_8b.SMOKE, attn_impl="flash", attn_block=8)
    slm = tm.init_model(lm_smoke, generator=torch.Generator(dev).manual_seed(7), device=dev)
    slm_cpu = tm.TransformerLM(
        slm.embed.cpu(), [tm.DecoderLayer({n_: p_.cpu() for n_, p_ in lp.named_parameters()})
                          for lp in slm.layers],
        slm.ln_f.cpu(), slm.unembed.cpu(), dataclasses.replace(lm_smoke, attn_impl="ref"))
    stoks = torch.from_numpy(np.random.default_rng(7).integers(0, lm_smoke.vocab, (2, 48)))
    np.testing.assert_allclose(util.host(slm(stoks.to(dev))[0]), util.host(slm_cpu(stoks)[0]),
                               rtol=1e-4, atol=1e-4)
    say("reference", graphs="social scale 10 (image and slotted walks), road scale 10 (BSR)",
        steps=6, dense_oracle="agrees", segment_sum="numpy float64 sums agree (rtol 1e-5)",
        two_tower="SMOKE on the card agrees with the same weights on the CPU",
        transformer="SMOKE (flash on the card) agrees with the dense reference on the CPU "
                    "(rtol 1e-4, atol 1e-4)")

    # 12. kernels against their plain versions at the main path's shapes --
    gidx = sw_ops._prep_gidx(g.dst, nv, img.edges_hi())
    vals = torch.cat([vk, vk.new_zeros(1)]).index_select(0, gidx.reshape(-1))
    vals = vals.reshape(-1, sw_kernel.EB).contiguous()
    src_d = torch.from_numpy(src.astype(np.int32)).to(dev)
    rows = []

    got, ref = sw_kernel.tile_cumsum(vals), sw_kernel.tile_cumsum_torch(vals)
    err = (got - ref).abs()
    tol = 1e-5 * ref.abs() + 1e-6 * ref.abs().amax(dim=1, keepdim=True)
    if not bool((err <= tol).all()):
        raise AssertionError("tile_cumsum: kernel disagrees with its plain version")
    nbytes = vals.numel() * 4 * 2
    rows.append(dict(
        name="tile_cumsum", source="src/repro_torch/csrc/tile_cumsum.cu",
        replaces="src/repro/kernels/slot_walk/kernel.py:43",
        shape=f"[{vals.shape[0]},{vals.shape[1]}] f32",
        max_abs_err=float(err.max()), tolerance="rtol 1e-5, atol 1e-6*tile max",
        ms=time_ms(lambda: sw_kernel.tile_cumsum(vals)),
        plain_ms=time_ms(lambda: sw_kernel.tile_cumsum_torch(vals)),
        library_ms=time_ms(lambda: torch.cumsum(vals, dim=-1)),
        bytes=nbytes, ops=vals.numel(),
    ))

    out_k = su_kernel.merge_rows(*merge_case)
    out_p = su_kernel.merge_rows_torch(*merge_case)
    mism = sum(int((a != b).sum()) for a, b in zip(out_k, out_p))
    if mism:
        raise AssertionError(f"merge_rows: {mism} elements differ from the plain version")
    a, w = merge_case[0].shape
    k = merge_case[3].shape[1]
    rows.append(dict(
        name="merge_rows", source="src/repro_torch/csrc/merge_rows.cu",
        replaces="src/repro/kernels/slot_update/kernel.py:108",
        shape=f"A={a} W={w} K={k}", max_abs_err=0.0, tolerance="bit-exact",
        ms=time_ms(lambda: su_kernel.merge_rows(*merge_case)),
        plain_ms=time_ms(lambda: su_kernel.merge_rows_torch(*merge_case), reps=5),
        library_ms=None,
        bytes=a * w * 16 + a * k * 12 + a * 8,
        ops=a * (w + k * max(int(np.log2(w)), 1)),
    ))

    got, ref = cb_kernel.count_degrees(src_d, n), cb_kernel.count_degrees_torch(src_d, n)
    mism = int((got != ref).sum())
    if mism:
        raise AssertionError(f"count_degrees: {mism} vertices differ from the plain version")
    rows.append(dict(
        name="count_degrees", source="src/repro_torch/csrc/count_degrees.cu",
        replaces="src/repro/kernels/csr_build/kernel.py:47",
        shape=f"M={src_d.shape[0]} n={n}", max_abs_err=0.0, tolerance="bit-exact",
        ms=time_ms(lambda: cb_kernel.count_degrees(src_d, n)),
        plain_ms=time_ms(lambda: cb_kernel.count_degrees_torch(src_d, n)),
        library_ms=time_ms(lambda: torch.bincount(src_d, minlength=n)),
        bytes=src_d.numel() * 4 + n * 4, ops=src_d.numel(),
    ))

    got, ref = (sw_kernel.slot_walk_partials(sw_rows, sw_vals, nv),
                sw_kernel.slot_walk_partials_torch(sw_rows, sw_vals, nv))
    if not torch.equal(got[1], ref[1]):
        raise AssertionError("slot_walk_partials: rank_rows differ from the plain version")
    torch.testing.assert_close(got[0], ref[0], rtol=PARTIALS_RTOL, atol=0.0)
    nz = ref[0] != 0
    rows.append(dict(
        name="slot_walk_partials", source="src/repro_torch/csrc/slot_walk_partials.cu",
        replaces="src/repro/kernels/slot_walk/kernel.py:83",
        shape=f"[{sw_rows.shape[0]},{sw_rows.shape[1]}] i32+f32",
        max_abs_err=float((got[0] - ref[0]).abs().max()),
        max_rel_err=float(((got[0] - ref[0]).abs()[nz] / ref[0][nz]).max()),
        tolerance="rank_rows bit-exact, partials rtol 254*2^-24",
        ms=split["partials_ms"],
        plain_ms=time_ms(lambda: sw_kernel.slot_walk_partials_torch(sw_rows, sw_vals, nv)),
        library_ms=None,
        bytes=sw_rows.numel() * 16, ops=sw_rows.numel(),
    ))
    del got, ref, nz
    rows += [bsr_row, seg_row, bag_row, fa_row]

    kernels = []
    for r in rows:
        bytes_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = r["ops"] / r.get("ops_per_s", VECTOR_OPS_PER_S) * 1e3
        peak = ("HBM 3.35 TB/s" if bytes_ms >= ops_ms
                else r.get("peak", "float32 non-tensor, 67 TFLOP/s"))
        say("kernel", name=r["name"], shape=r["shape"], launches=launches[r["name"]],
            max_abs_err=r["max_abs_err"], tolerance=r["tolerance"],
            **({"max_rel_err": f"{r['max_rel_err']:.3e}"} if "max_rel_err" in r else {}),
            ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            library_ms="none" if r["library_ms"] is None else f"{r['library_ms']:.4f}",
            bound_ms=f"{max(bytes_ms, ops_ms):.4f}", bound_peak=peak)
        kernels.append(dict(
            name=r["name"], route="cuda", source=r["source"], replaces=r["replaces"],
            launches=launches[r["name"]], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations", bound_peak=peak,
            library_ms=r["library_ms"],
        ))
    say("main_path_ms", **{k: f"{v_:.2f}" for k, v_ in times.items()})
    say("wall", total_s=f"{time.perf_counter() - start:.1f}",
        **{k: f"{v_:.1f}" for k, v_ in phase_s.items()})

    # 13. result lines ---------------------------------------------------
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
