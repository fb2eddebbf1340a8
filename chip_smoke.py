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

then holds each kernel against its plain PyTorch version at the shapes its
path gave it and times both.  The line before the last is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
Any failed check raises, so the exit code is non-zero and no result line
is printed.  Without a CUDA device it exits non-zero at once.
"""
import contextlib
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


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


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
    from repro_torch.core import DiGraph, csr, edgebatch, traversal, updates, util
    from repro_torch.io import synthetic
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.kernels.bsr_spmm import kernel as bsr_kernel
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops
    from repro_torch.kernels.csr_build import kernel as cb_kernel
    from repro_torch.kernels.slot_update import kernel as su_kernel
    from repro_torch.kernels.slot_update import ops as su_ops
    from repro_torch.kernels.slot_walk import kernel as sw_kernel
    from repro_torch.kernels.slot_walk import ops as sw_ops

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
    t0 = time.perf_counter()
    src, dst, wgt, n = synthetic.make_coo(
        "social", scale=SCALE, edge_factor=EDGE_FACTOR, seed=SEED
    )
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
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
    t0 = time.perf_counter()
    with counted(KERNELS, launches):
        raw = csr.from_coo(src, dst, wgt, n=n, dedup=False, engine="cuda", device=dev)
    times["load_coo_ms"] = sync_s(t0) * 1e3
    host = csr.from_coo(src, dst, wgt, n=n, dedup=False, engine="host", device=dev)
    for f in ("offsets", "dst", "wgt"):
        if not torch.equal(getattr(raw, f), getattr(host, f)):
            raise AssertionError(f"load: cuda engine {f} differs from the host engine")
    del host
    t0 = time.perf_counter()
    with counted(KERNELS, launches):
        g = DiGraph.from_csr(c, device=dev)
    times["load_arena_ms"] = sync_s(t0) * 1e3
    say("load", m_raw=raw.m, cap_e=g.cap_e, bump=g.layout.bump,
        coo_to_csr_ms=f"{times['load_coo_ms']:.1f}",
        csr_to_arena_ms=f"{times['load_arena_ms']:.1f}", host_engine="bit-identical")
    del raw

    # 4. clone (paper task 2) -------------------------------------------
    t0 = time.perf_counter()
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
        t0 = time.perf_counter()
        with counted(KERNELS, launches), spy as seen:
            _, dm = g.apply(plan)
        times[f"{name}_ms"] = sync_s(t0) * 1e3
        merge_case = seen.get("args", merge_case)
        t0 = time.perf_counter()
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
    t0 = time.perf_counter()
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
    t0 = time.perf_counter()
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
    t0 = time.perf_counter()
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
    p0 = t0 = time.perf_counter()
    rsrc, rdst, _, rn = synthetic.make_coo("road", scale=ROAD_SCALE, seed=SEED,
                                           weighted=False)
    road_gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    road = csr.from_coo(rsrc, rdst, n=rn, device=dev)  # dedup: one entry per pair
    road_dedup_s = time.perf_counter() - t0
    del rsrc, rdst
    t0 = time.perf_counter()
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
    t0 = time.perf_counter()
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
    say("reference", graphs="social scale 10 (image and slotted walks), road scale 10 (BSR)",
        steps=6, dense_oracle="agrees")

    # 9. kernels against their plain versions at the main path's shapes ---
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
    rows.append(bsr_row)

    kernels = []
    for r in rows:
        bytes_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = r["ops"] / VECTOR_OPS_PER_S * 1e3
        say("kernel", name=r["name"], shape=r["shape"], launches=launches[r["name"]],
            max_abs_err=r["max_abs_err"], tolerance=r["tolerance"],
            **({"max_rel_err": f"{r['max_rel_err']:.3e}"} if "max_rel_err" in r else {}),
            ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            library_ms="none" if r["library_ms"] is None else f"{r['library_ms']:.4f}",
            bound_ms=f"{max(bytes_ms, ops_ms):.4f}")
        kernels.append(dict(
            name=r["name"], route="cuda", source=r["source"], replaces=r["replaces"],
            launches=launches[r["name"]], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=r["library_ms"],
        ))
    say("main_path_ms", **{k: f"{v_:.2f}" for k, v_ in times.items()})
    say("wall", total_s=f"{time.perf_counter() - start:.1f}",
        **{k: f"{v_:.1f}" for k, v_ in phase_s.items()})

    # 10. result lines ---------------------------------------------------
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
