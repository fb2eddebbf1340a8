"""Run a benchmark cell at a tiny size on the CPU (the tests' rehearsal).

The program runs its plain versions there (no CUDA kernel); the graph,
traffic, loops, checks and result line are the benchmark's own.

A cell's tiny sizes come from what it is made of, never from its name: the
graph's from its configuration's ``generator`` family (``SIZES``), the
traffic's from its loop module's ``TINY``.  So a configuration of a known
family, or a loop that brings its own ``TINY``, joins the rehearsal by its
own files.  A new generator family is an edit to ``bench/gen.py::make_graph``
anyway, and adds its tiny size here with it.
"""
from __future__ import annotations

import time

from bench import harness

#: graph overrides by generator family: 256 vertices of the same family;
#: ``symmetric`` and the family's shape parameters stay the configuration's
SIZES = {
    "rmat": {"scale": 8, "vertices": 256, "edge_factor": 16, "edges": 4096},
    "road": {"vertices": 256, "edges": 560},
}

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def config_sizes(config: dict) -> dict:
    """The tiny graph overrides of a configuration, by its generator family."""
    family = config["generator"]
    if family not in SIZES:
        raise LookupError(f"no tiny size for generator family {family!r}: add one to "
                          f"SIZES in bench/tests/tiny.py beside its generator in bench/gen.py")
    return SIZES[family]


def traffic_sizes(traffic: dict) -> dict:
    """The tiny traffic overrides of a mix: its loop module's ``TINY``."""
    kind = traffic["loop"]
    tiny = getattr(harness.loop_module(kind), "TINY", None)
    if tiny is None:
        raise LookupError(f"loop {kind!r} has no tiny traffic: add a TINY dict to "
                          f"bench/loops/{kind}.py")
    return tiny


def run(cell: str, *, seed: int = 2**31 + 11, seconds: float = 0.3, traced: bool = False,
        spec: dict | None = None, **kw) -> dict:
    spec = spec or harness.benchmark()
    _, config, traffic, _ = harness.cell_parts(spec, cell)
    return harness.run(cell, seed, seconds, traced, device="cpu",
                       t_process=time.perf_counter(), spec=spec,
                       config_overrides=config_sizes(config),
                       traffic_overrides=traffic_sizes(traffic), **kw)
