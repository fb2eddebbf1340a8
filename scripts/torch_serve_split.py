#!/usr/bin/env python3
"""Split one batched walk of the PyTorch port's walk server by device time.

    python3 scripts/torch_serve_split.py [--root CHECKOUT] [--batches 1,16]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout).  It
builds chip_smoke.py's social graph (R-MAT, scale 21, edge factor 16, seed
42) as a DiGraph on the card, seals generation 0 as ``WalkServer`` does
(``walk_image.seal_generation``) and walks it from B initial visit rows of
4 random seeds each (seed 7), 4 steps, as the server's dispatcher does.
For each B it prints one JSON line: the walk's CUDA-event time (mean of 5
after a warm-up), the share of it in ``tile_cumsum`` and in the
compensated tile-base scan (``_comp_scan``), both timed by CUDA events
around each call, the rest (the gather of the visits into slot order, the
interval reads and the assembly), and ``torch.profiler``'s device time by
kernel name over one walk (the top 12).  The first line is the card's name
and power limit.  Needs one CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

STEPS, SEEDS = 4, 4


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--batches", default="1,16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_split: no CUDA device")
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.core import DiGraph, csr, walk_image
    from repro_torch.io import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels.slot_walk import kernel as sw_kernel
    from repro_torch.kernels.slot_walk import ops as sw_ops
    from repro_torch.launch import serve as launch_serve

    _build.library()  # build the kernels before anything is timed
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    src, dst, wgt, n = synthetic.make_coo("social", scale=21, edge_factor=16, seed=42)
    g = DiGraph.from_csr(csr.from_coo(src, dst, wgt, n=n, device=dev), device=dev)
    del src, dst, wgt
    img = walk_image.seal_generation(g, 0)
    nv = img.nv
    rng = np.random.default_rng(7)

    spans = {"tile_cumsum": [], "comp_scan": []}

    def timed(name, inner):
        def call(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*a, **k)
            end.record()
            spans[name].append((start, end))
            return out
        call.launches = 0  # the kernel wrapper counts its launches on its module name
        return call

    sw_kernel.tile_cumsum = timed("tile_cumsum", sw_kernel.tile_cumsum)
    sw_ops._comp_scan = timed("comp_scan", sw_ops._comp_scan)

    for b in (int(x) for x in args.batches.split(",")):
        v0 = torch.stack([launch_serve.seed_visits_row(nv, rng.integers(0, nv, SEEDS), device=dev)
                          for _ in range(b)])
        walk = lambda: img.walk(STEPS, visits0=v0)  # noqa: E731
        walk()
        torch.cuda.synchronize()
        for v in spans.values():
            v.clear()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            walk()
        end.record()
        end.synchronize()
        walk_ms = start.elapsed_time(end) / 5
        parts = {k: sum(a.elapsed_time(z) for a, z in v) / 5 for k, v in spans.items()}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            walk()
            torch.cuda.synchronize()
        kernels, ops = [], []
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            if us <= 0:
                continue
            row = {"name": e.key[:80], "device_ms": us / 1e3, "calls": e.count}
            if e.device_type == torch.autograd.DeviceType.CPU:
                if e.key.startswith("aten::"):
                    ops.append(row)
            else:
                kernels.append(row)
        kernels.sort(key=lambda r: -r["device_ms"])
        ops.sort(key=lambda r: -r["device_ms"])
        print(json.dumps({
            "b": b, "steps": STEPS, "nv": nv, "tiles": img.edges_hi() // sw_kernel.EB,
            "walk_event_ms": walk_ms,
            "tile_cumsum_event_ms": parts["tile_cumsum"],
            "comp_scan_event_ms": parts["comp_scan"],
            "rest_event_ms": walk_ms - parts["tile_cumsum"] - parts["comp_scan"],
            "profile_device_ms": sum(r["device_ms"] for r in kernels),
            "profile_top": kernels[:12],
            "profile_ops_top": ops[:12],
        }), flush=True)
        del v0


if __name__ == "__main__":
    main()
