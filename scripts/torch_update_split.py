#!/usr/bin/env python3
"""Split the PyTorch port's update batches into fused_apply and the rest.

    python3 scripts/torch_update_split.py [--root CHECKOUT] [--reps 2]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout), so
two checkouts can be compared on one card by running the script once for
each, in turns.  It builds chip_smoke.py's social graph (R-MAT, scale 21,
edge factor 16, seed 42) on the card and applies chip_smoke.py's three
batches (1e-3·|E| deletions, 1e-3·|E| insertions, a 1e-2·|E| mixed batch,
drawn from seed 43) to a copy of the loaded graph, ``--reps`` times, each
time to a fresh copy with the same plans.  For each batch it prints one
JSON line (rep 0 pays first-call costs such as pinned host buffers): the
host wall time of ``DiGraph.apply`` (the device synchronised
before and after), the CUDA-event and host time of its ``fused_apply`` call,
the rest of apply (host planning and the buffer copy-on-write), and the
bytes of the plan operands handed to ``fused_apply``.  The first line is the
card's name and power limit.  Needs one CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_update_split: no CUDA device")
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.core import DiGraph, csr, edgebatch, updates
    from repro_torch.io import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels.slot_update import ops as su_ops

    _build.library()  # build the kernels before anything is timed
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    src, dst, wgt, n = synthetic.make_coo("social", scale=21, edge_factor=16, seed=42)
    base = DiGraph.from_csr(csr.from_coo(src, dst, wgt, n=n, device=dev), device=dev)
    inner = su_ops.fused_apply
    calls = []

    def timed(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        nbytes = sum(x.nbytes for g in a[3] for x in g[5])
        t0 = time.perf_counter()
        start.record()
        out = inner(*a, **k)
        end.record()
        calls.append((start, end, time.perf_counter() - t0, nbytes))
        return out

    su_ops.fused_apply = timed
    plans = []
    for rep in range(args.reps):
        g = base.clone()
        rng = np.random.default_rng(43)
        n_small, n_half = round(1e-3 * g.m), round(0.5e-2 * g.m)
        for i, name in enumerate(("delete", "insert", "mixed")):
            if rep == 0:
                ins = dels = None
                if name != "delete":
                    ins = edgebatch.random_insertions(
                        rng, n, n_small if name == "insert" else n_half,
                        weighted_range=(0.5, 1.5))
                if name != "insert":
                    dels = edgebatch.random_deletions(
                        rng, g.to_csr(), n_small if name == "delete" else n_half)
                plans.append(updates.plan_update(inserts=ins, deletes=dels))
            calls.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.apply(plans[i])
            torch.cuda.synchronize()
            total_ms = (time.perf_counter() - t0) * 1e3
            host_ms = sum(c[2] for c in calls) * 1e3
            print(json.dumps({
                "root": args.root, "rep": rep, "batch": name, "apply_ms": total_ms,
                "fused_apply_event_ms": sum(s.elapsed_time(e) for s, e, _, _ in calls),
                "fused_apply_host_ms": host_ms, "rest_of_apply_ms": total_ms - host_ms,
                "operand_mb": sum(c[3] for c in calls) / 1e6}), flush=True)
        del g
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
