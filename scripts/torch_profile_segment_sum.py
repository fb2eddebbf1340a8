#!/usr/bin/env python3
"""Profile the PyTorch port's edge segment sum kernel by kernel.

    python3 scripts/torch_profile_segment_sum.py [--reps 5]

Builds chip_smoke.py's social CSR (R-MAT, scale 21, edge factor 16, seed
42; 67,073,019 edges) on the card and runs ``edge_segment_sum`` over it at
D = 16 and 64 (values N(0,1), three warm-up calls) under
``torch.profiler``: the table lists each CUDA kernel's device time (the
runs kernel, the seam fold and the ``fill_`` that zeroes the output) over
``--reps`` calls.  The first line is the card's name and power limit.
Needs one CUDA device.
"""
import argparse
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_segment_sum: no CUDA device")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "src"))
    from repro_torch.core import csr, util
    from repro_torch.io import synthetic
    from repro_torch.kernels.edge_segment_sum import ops as seg_ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    src, dst, wgt, n = synthetic.make_coo("social", scale=21, edge_factor=16, seed=42)
    c = csr.from_coo(src, dst, wgt, n=n, device=dev)
    rows = util.expand_rows(c.offsets, c.m)
    gen = torch.Generator(device=dev).manual_seed(42)
    for d in (16, 64):
        vals = torch.randn((n, d), generator=gen, device=dev).index_select(0, c.dst.long())
        for _ in range(3):
            seg_ops.edge_segment_sum(rows, vals, num_segments=n)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                seg_ops.edge_segment_sum(rows, vals, num_segments=n)
            torch.cuda.synchronize()
        print(f"D={d} E={rows.shape[0]} n={n} calls={args.reps}")
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=8), flush=True)
        del vals


if __name__ == "__main__":
    main()
