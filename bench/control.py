"""Read the numbers ``correct`` compares for a cell, on several seeds in one
process: the program's (the lower readings of each limit), the control's,
the plain reference computed in bfloat16 and put in the program's place
(the upper readings), and the program's with a fault of ``faults.py``
planted.  The benchmark's own runs never run the control or a fault.

    python3 bench/control.py --workload road-europe-stream --seconds 5 \\
        --control-seeds 11,12,13 --program-seeds 21,22,23 \\
        --fault small_visits_altered --fault-seeds 31,32,33

Prints one line a run: the seed, what ran, ``correct`` and every number
compared.  The faulted runs come last, as a fault stays planted.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    sys.path[0:1] = [str(ROOT)]
    from bench import run as run_cli
    run_cli.setup_paths()
    from bench import faults, harness

    def read(seed: int, what: str) -> None:
        r = harness.run(args.workload, seed, args.seconds, False, device="cuda",
                        t_process=time.perf_counter(), control=what == "control")
        checks = {k: v["value"] for k, v in r["checks"].items()}
        print(f"[control] {args.workload} seed={seed} run={what} "
              f"correct={r['correct']} {json.dumps(checks)}", flush=True)

    for s in seeds(args.control_seeds):
        read(s, "control")
    for s in seeds(args.program_seeds):
        read(s, "program")
    if args.fault:
        faults.plant(args.fault)
        for s in seeds(args.fault_seeds):
            read(s, args.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
