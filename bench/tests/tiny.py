"""Run a benchmark cell at a tiny size on the CPU (the tests' rehearsal).

The program runs its plain versions there (no CUDA kernel); the graph,
traffic, loops, checks and result line are the benchmark's own.
"""
from __future__ import annotations

import time

from bench import harness

#: configuration overrides: a 256-vertex graph of the same family
SIZES = {
    "rmat22-social": {"scale": 8, "vertices": 256, "edge_factor": 16, "edges": 4096},
    "road-europe-osm": {"vertices": 256, "edges": 560},
}
#: traffic overrides by loop kind: batches big enough to touch many rows
TRAFFIC = {
    "stream": {"batch_fraction": 0.01, "max_rounds_per_s": 600, "trace_seconds": 10},
    "walks": {"batch_fraction": 0.02, "max_calls_per_s": 5000, "trace_seconds": 10,
              "check_stride": 2},
}

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def run(cell: str, *, seed: int = 2**31 + 11, seconds: float = 0.3, traced: bool = False,
        **kw) -> dict:
    entry, _, traffic, _ = harness.cell_parts(harness.benchmark(), cell)
    return harness.run(cell, seed, seconds, traced, device="cpu",
                       t_process=time.perf_counter(),
                       config_overrides=SIZES[entry["config"]],
                       traffic_overrides=TRAFFIC[traffic["loop"]], **kw)
