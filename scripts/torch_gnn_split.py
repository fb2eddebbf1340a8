#!/usr/bin/env python3
"""Split one train step of the PyTorch port's GNN cells by device time.

    python3 scripts/torch_gnn_split.py [--root CHECKOUT] [--cells gcn-cora/ogb_products,...]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout).  For
each cell (default: chip_smoke.py's gnn_train cells, at FULL width, seed
42) it builds ``launch.steps.build_cell(arch, shape, device="cuda")``, runs
two warm-up steps, times three steps by CUDA events and profiles one more
with ``torch.profiler``.  It prints one JSON line a cell: the mean step
time, the profiled kernels' device time and its share of the step (the
card's busy share), the number of kernels launched, the top 12 kernels by
device time and the top 12 ``aten`` ops.  The first line is the card's name
and power limit.  Needs one CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys

import torch

CELLS = "gcn-cora/ogb_products,graphcast/minibatch_lg,schnet/molecule,mace/molecule"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--cells", default=CELLS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_gnn_split: no CUDA device")
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.kernels import _build
    from repro_torch.launch import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()  # build the kernels before anything is timed
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for spec in args.cells.split(","):
        arch, shape = spec.split("/")
        cell = steps.build_cell(arch, shape, device="cuda", seed=42)
        state, batch = cell.args
        for _ in range(2):
            state, _ = cell.step_fn(state, batch)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            state, _ = cell.step_fn(state, batch)
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / 3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            state, _ = cell.step_fn(state, batch)
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
        device_ms = sum(r["device_ms"] for r in kernels)
        print(json.dumps({
            "cell": spec, "step_event_ms": step_ms, "profile_device_ms": device_ms,
            "busy_share": device_ms / step_ms, "kernels_launched": sum(r["calls"] for r in kernels),
            "profile_top": kernels[:12], "profile_ops_top": ops[:12],
        }), flush=True)
        del cell, state, batch, prof
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
