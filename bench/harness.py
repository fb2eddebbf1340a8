"""The benchmark's harness: find a cell's pieces by name, run its loop, print.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration's file, the mix's file (``traffic/<mix>.json``, which names
its loop kind), the loop (``loops/<kind>.py``), each per-layer metric's
reader (``metrics/<metric>.py``) and the cell's limits
(``limits/<cell>.json``) are found by those names.  So a cell, a mix, a
metric, a configuration of a generator family that ``gen.make_graph``
knows, or a loop kind is added by adding files: the tests' tiny rehearsal
(``tests/tiny.py``) sizes a cell by its configuration's ``generator`` and
its loop's ``TINY``, not by its names.

A loop's ``run(ctx)`` builds the system from the seed, calls
``ctx.open_window()`` when set-up is done, drives the window, calls
``ctx.close_window()``, frees the program's state, checks what the window
produced against the plain reference and returns an ``Outcome``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from . import trace

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "bench"
#: top-level module names no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_parts(spec: dict, name: str):
    """-> (cell entry, configuration dict, traffic dict, limits dict)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return (cell, load_json(ROOT / entry["file"]),
            load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            load_json(HERE / "limits" / f"{name}.json"))


def end_to_end(spec: dict, cell: str) -> list:
    return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer(spec: dict, cell: str) -> list:
    moves = {m["name"] for m in end_to_end(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moves)]


def metric_reader(name: str):
    """The module of ``metrics/<name>.py`` (names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop_module(kind: str):
    return importlib.import_module(f"bench.loops.{kind}")


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules``),
    compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Check:
    """One number ``correct`` compares, and its limit (value <= limit)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    e2e: dict
    record: dict
    attempted: int
    failed: int
    checks: list


@dataclasses.dataclass
class Ctx:
    """What a loop gets: the cell's data, the clock, spans and the tracer."""

    cell: str
    seed: int
    seconds: float
    device: torch.device
    config: dict
    traffic: dict
    limits: dict
    t_process: float
    spans: trace.Spans
    tracer: trace.Tracer
    setup_s: float = math.nan
    window_s: float = math.nan
    peak_bytes: int = 0
    #: put the plain reference in bfloat16 in the program's place (control.py)
    control: bool = False
    _w0: float = 0.0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def note(self, what: str) -> None:
        """A progress line on standard error, stamped from the process start."""
        self.sync()
        print(f"[bench] {time.perf_counter() - self.t_process:8.2f} s  {what}",
              file=sys.stderr, flush=True)

    def open_window(self) -> None:
        self.sync()
        if self.tracer.enabled and self.tracer.seconds >= self.seconds:
            # a trace of the whole window starts before it: the profiler's
            # start-up (seconds, at times) would stall the window's first step
            self.tracer.start()
        self.setup_s = time.perf_counter() - self.t_process
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self._w0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._w0

    def tick(self) -> None:
        """Between two steps of the window: start the profiler for the
        window's last ``trace_seconds``, so the spans of the untraced part
        before it are not slowed by it (its launch hooks stay on once
        started).  Its start-up takes some of those seconds."""
        if (self.tracer.enabled and not self.tracer.active and self.tracer.summary is None
                and self.elapsed() >= self.seconds - self.tracer.seconds):
            self.tracer.start()

    def close_window(self) -> None:
        self.sync()
        self.window_s = time.perf_counter() - self._w0
        if self.device.type == "cuda":
            self.peak_bytes = int(torch.cuda.max_memory_allocated(self.device))
        self.tracer.stop()
        self.tracer.reduce()

    def keep_buffer(self, shape) -> torch.Tensor:
        """Host memory a window output is copied to without a wait."""
        return torch.empty(shape, dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")

    def free(self) -> None:
        """After the program's state is dropped: return its memory."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def device_info(ctx: Ctx, traced: bool) -> dict:
    if ctx.device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
                "count": 1, "memory_peak_bytes": ctx.peak_bytes}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": ctx.peak_bytes}
    if traced:
        s = ctx.tracer.summary or {"busy_s": 0.0, "window_s": 0.0}
        info["busy_s"] = s["busy_s"]
        info["window_s"] = s["window_s"]
    return info


def run(cell: str, seed: int, seconds: float, traced: bool, *, device,
        t_process: float, spec: dict | None = None, config_overrides=None,
        traffic_overrides=None, control: bool = False) -> dict:
    """Run one cell and return its result object (not yet printed).

    The overrides serve the tests, which run a cell at a tiny size on the
    CPU; the command line never passes them.
    """
    spec = spec or benchmark()
    _, config, traffic, limits = cell_parts(spec, cell)
    config = {**config, **(config_overrides or {})}
    traffic = {**traffic, **(traffic_overrides or {})}
    device = torch.device(device)
    spans = trace.Spans()
    ctx = Ctx(cell=cell, seed=int(seed), seconds=float(seconds), device=device,
              config=config, traffic=traffic, limits=limits, t_process=t_process,
              spans=spans, control=control,
              tracer=trace.Tracer(traced, min(float(traffic["trace_seconds"]), float(seconds)),
                                  spans, device))
    out = loop_module(traffic["loop"]).run(ctx)
    out.record.setdefault("spans", spans)
    out.record.setdefault("trace", ctx.tracer.summary)
    out.record.setdefault("peak_bytes", ctx.peak_bytes)

    metrics = {}
    if traced:
        for m in per_layer(spec, cell):
            v = metric_reader(m["name"]).read(out.record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"setup_s": ctx.setup_s, **out.e2e}
        for m in end_to_end(spec, cell):
            if m["name"] not in values:
                raise RuntimeError(f"loop {traffic['loop']!r} gave no {m['name']!r}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {
        "correct": all(c.ok for c in out.checks) and bool(out.checks),
        "attempted": int(out.attempted),
        "failed": int(out.failed),
        "metrics": metrics,
        "device": device_info(ctx, traced),
    }
    if traced and ctx.tracer.summary is not None:
        result["breakdown"] = ctx.tracer.summary["breakdown"]
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return result
