#!/usr/bin/env python3
"""Split the PyTorch port's LM and two-tower train steps by device time.

    python3 scripts/torch_lm_split.py [--root CHECKOUT] [--cells h2o,moe,two_tower,moe_prefill]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout).
Each cell is chip_smoke.py's ``lm_train`` cell, built the same way (seed
42): ``h2o`` (h2o-danube-1.8b train_4k, 2 microbatches of 2 x 4,096
tokens), ``moe`` (qwen3-moe-235b-a22b train_4k cost1 on 1 x 4,096),
``two_tower`` (FULL width on 5M-row vocabularies, batch 16,384) and
``moe_prefill`` (qwen3-moe cost1 prefill_32k with the flash kernel, batch
1).  After a warm-up it times two calls by CUDA events, the optimizer's
``update`` inside them by its own events, and profiles one more with
``torch.profiler``.  It prints one JSON line a cell: the mean call time,
the update's share, the profiled kernels' device time and its share of
the call (the card's busy share), kernels launched, and the top 12
kernels and ``aten`` ops by device time.  The first line is the card's
name and power limit.  Needs one CUDA device.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

CELLS = "h2o,moe,two_tower,moe_prefill"


def build(name, steps, train_loop, two_tower, tree, tt_cfg):
    """(call(), cell name): one train step or prefill of the named cell."""
    if name == "h2o":
        cell = steps.build_cell("h2o-danube-1.8b", "train_4k", device="cuda", seed=42)
        state, full = cell.args
        batch = {k: v[:2, :2] for k, v in full.items()}
        step = train_loop.make_train_step(cell.meta["loss"], cell.meta["opt_cfg"], grad_accum=2)
    elif name == "moe":
        cell = steps.build_cell("qwen3-moe-235b-a22b", "train_4k", variant="cost1",
                                device="cuda", seed=42)
        state, full = cell.args
        batch = {k: v[:1] for k, v in full.items()}
        step = cell.step_fn
    elif name == "two_tower":
        cfg = dataclasses.replace(tt_cfg, n_users=5_000_000, n_items=5_000_000)
        gen = torch.Generator(device="cuda").manual_seed(42)
        params = two_tower.init_params(cfg, generator=gen, device="cuda")
        state = train_loop.init_state(tree.tree_map(lambda p: p.requires_grad_(), params),
                                      steps.OPT_CFG)
        batch = {f"{t}_bags": torch.randint(-1, 5_000_000, (16384, nf, cfg.bag_size),
                                             generator=gen, device="cuda", dtype=torch.int32)
                 for t, nf in (("user", cfg.n_user_fields), ("item", cfg.n_item_fields))}
        batch["item_logq"] = torch.zeros((16384,), device="cuda")
        step = train_loop.make_train_step(lambda p, b: two_tower.loss_fn(p, b, cfg),
                                          steps.OPT_CFG)
    else:
        cell = steps.build_cell("qwen3-moe-235b-a22b", "prefill_32k", variant="cost1",
                                device="cuda", seed=42)
        params, toks = cell.args[0], cell.args[1][:1]
        fwd = cell.meta["make_step"](attn_impl="flash")
        return lambda: fwd(params, toks)
    box = {"state": state}

    def call():
        box["state"], _ = step(box["state"], batch)
    return call


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--cells", default=CELLS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_lm_split: no CUDA device")
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.configs import two_tower_retrieval
    from repro_torch.core import tree
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    from repro_torch.models.recsys import two_tower
    from repro_torch.train import loop as train_loop
    from repro_torch.train import optimizer as opt_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()  # build the kernels before anything is timed
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    inner = opt_mod.update
    spans = []

    def timed_update(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = inner(*a, **k)
        ev[1].record()
        spans.append(ev)
        return out

    opt_mod.update = timed_update  # the loop calls it through the module
    for name in args.cells.split(","):
        torch.cuda.empty_cache()
        call = build(name, steps, train_loop, two_tower, tree, two_tower_retrieval.FULL)
        call()  # warm-up
        torch.cuda.synchronize()
        spans.clear()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(2):
            call()
        end.record()
        end.synchronize()
        call_ms = start.elapsed_time(end) / 2
        update_ms = sum(a.elapsed_time(b) for a, b in spans) / 2
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
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
            "cell": name, "call_event_ms": call_ms, "update_event_ms": update_ms,
            "update_share": update_ms / call_ms, "profile_device_ms": device_ms,
            "busy_share": device_ms / call_ms,
            "kernels_launched": sum(r["calls"] for r in kernels),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "profile_top": kernels[:12], "profile_ops_top": ops[:12],
        }), flush=True)
        del call, prof
        torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
