#!/usr/bin/env python3
"""Time the walk step's gather (``slot_gather``) on the card, every read order.

    python3 scripts/torch_gather_split.py [--configs NAME ...] [--reps 10]
                                          [--walk-steps 42] [--out FILE]

For each benchmark configuration (``bench/configs/NAME.json``, generated on
the card from ``--seed`` as the benchmark does, without its set-up rounds)
it takes the walk image's tile-padded index (``ops._prep_gidx``) and, at
every batch size of ``BATCHES`` (the configuration's own cell's first),
times with CUDA events, as the mean of ``--reps`` calls after a warm-up:

  candidate   the C entry point with a fixed pass plan: R rows a pass
              (1, 2, 4, 8, 16; above 1 from a vertex-major pack), each
              checked bit for bit against the plain version
  chosen      ``slot_gather`` itself (the plan ``gather_rows_per_pass`` gives)
  plain       ``slot_gather_torch``: cat with the zero column, index_select
  library     ``index_select`` alone, on a visits tensor that already has
              the zero column (the yardstick)

and, with ``--walk-steps``, a batched ``slot_walk_image`` walk of that many
normalised steps with the kernel and with the plain gather put in its place
(results bit for bit).  One JSON line a reading, on stdout and in ``--out``;
the first names the card and its power limit.  Needs one CUDA device.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import system  # noqa: E402
from repro_torch.kernels.slot_walk import kernel as sw_kernel  # noqa: E402
from repro_torch.kernels.slot_walk import ops as sw_ops  # noqa: E402

#: the batch sizes each configuration's cell walks first, then the others
BATCHES = {"rmat22-social": (16, 1, 2, 4, 8, 17), "road-europe-osm": (1,), "rmat23-web": (1, 16)}


def events_ms(fn, reps: int) -> float:
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


def card() -> dict:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True)
    return {"card": q.stdout.strip(), "torch": torch.__version__}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="*", default=list(BATCHES))
    ap.add_argument("--seed", type=int, default=3200000101)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--walk-steps", type=int, default=42)
    ap.add_argument("--out", default=str(ROOT / "build" / "gather_split.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    out = open(args.out, "a")

    def say(**rec):
        line = json.dumps(rec)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    say(**card())
    for name in args.configs:
        cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
        g, _, _ = system.build_graph(cfg, args.seed, dev)
        img = g.to_walk_image()
        gidx = sw_ops._prep_gidx(img.dst, img.nv, img.edges_hi())
        live = int((gidx < img.nv).sum())
        say(config=name, n=img.nv, tiles=gidx.shape[0], slots=gidx.numel(), live_slots=live)
        gen = torch.Generator(dev).manual_seed(args.seed)
        for b in BATCHES[name]:
            visits = torch.rand((b, img.nv), generator=gen, device=dev)
            plain = sw_kernel.slot_gather_torch(visits, gidx)
            chosen = sw_kernel.gather_rows_per_pass(b)
            for r in (1, 2, 4, 8, 16):
                if r > b:
                    continue
                got = sw_kernel._launch_gather(visits, gidx, r)
                same = bool(torch.equal(got, plain))
                del got
                say(config=name, rows=b, rows_per_pass=r, bit_equal=same, chosen=r == chosen,
                    ms=events_ms(lambda: sw_kernel._launch_gather(visits, gidx, r), args.reps))
            del plain
            zv = torch.cat([visits, visits.new_zeros(b, 1)], dim=1)
            flat = gidx.reshape(-1)
            say(config=name, rows=b, rows_per_pass=chosen,
                ms=events_ms(lambda: sw_kernel.slot_gather(visits, gidx), args.reps),
                plain_ms=events_ms(lambda: sw_kernel.slot_gather_torch(visits, gidx), args.reps),
                library_ms=events_ms(lambda: zv.index_select(1, flat), args.reps),
                bound_ms=4 * (b * gidx.numel() + gidx.numel() + b * img.nv) / 3.35e9)
            del zv
            if args.walk_steps and b == BATCHES[name][0]:
                v0 = torch.rand((b, img.nv), generator=gen, device=dev)
                walk = lambda: sw_ops.slot_walk_image(  # noqa: E731
                    img, args.walk_steps, visits0=v0, normalize=True)
                kernel_ms = events_ms(walk, 3)
                vk = walk()
                inner = sw_kernel.slot_gather
                sw_kernel.slot_gather = sw_kernel.slot_gather_torch
                try:
                    plain_ms = events_ms(walk, 3)
                    vp = walk()
                finally:
                    sw_kernel.slot_gather = inner
                say(config=name, rows=b, walk_steps=args.walk_steps, walk_ms=kernel_ms,
                    plain_gather_walk_ms=plain_ms, walks_bit_equal=bool(torch.equal(vk, vp)))
                del v0, vk, vp
            del visits
            torch.cuda.empty_cache()
        del g, img, gidx
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
