"""Run one cell of the benchmark and print its result as the last line.

    python3 bench/run.py --workload road-europe-stream --seed 7 --seconds 51 --trace 0

Run from the root of a checkout on a machine with the card(s) the cell asks
for.  ``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (the profiler then runs over the last part of the
window).  The numbers ``correct`` compares are printed beside their limits
as the last lines of standard error and under ``checks`` in the result.
Exits non-zero, printing no result, without enough CUDA devices, when a
piece of the cell is missing, or when ``jax``, ``jaxlib``, ``flax`` or
``repro`` was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def setup_paths() -> None:
    # import ``bench`` as a package from the checkout's root (not this
    # folder, whose modules would shadow the standard library's) and the
    # program from ``src``; keep every kernel cache inside the checkout
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    setup_paths()
    import torch

    from bench import harness

    spec = harness.benchmark()
    cell = {w["name"]: w for w in spec["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         device="cuda", t_process=T_PROCESS, spec=spec)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    report(result)
    return 0


def report(result: dict) -> None:
    """The numbers compared as the last lines of standard error, then the
    result as the last line of standard output."""
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
