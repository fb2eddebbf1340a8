"""The benchmark's layout and result line.

Every cell, configuration, mix and metric of ``BENCHMARK.json`` resolves to
its files by name; names, units and texts keep to the allowed characters
and lengths; every metric's ``moves`` target is reported in each cell that
lists it; a tiny run on the CPU prints the result line a check reads; no
run loads ``jax``, ``jaxlib``, ``flax`` or ``repro``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest
import torch

from bench import harness, readers, run as run_cli
from bench.loops import stream
from bench.tests import tiny

SPEC = harness.benchmark()
ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = tiny.CELLS
LAYERS = [m["name"] for m in SPEC["per_layer"]]


def text_ok(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text_ok(c["source"]) and text_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert text_ok(w["why"]) and w["chips"] == 1 and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert text_ok(m["layer"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    assert [m["bound"] for m in SPEC["end_to_end"] if m["name"] == "setup_s"] == [0.25]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    entry, config, traffic, limits = harness.cell_parts(SPEC, cell)
    conf = {c["name"]: c for c in SPEC["configs"]}[entry["config"]]
    assert conf["file"].startswith("bench/configs/")
    assert sorted(conf["reduced"]) == sorted(config["reduced"])
    assert all(k in config for k in conf["reduced"])
    assert harness.loop_module(traffic["loop"]).run
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    e2e = {m["name"] for m in harness.end_to_end(SPEC, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = harness.per_layer(SPEC, cell)
    assert layers and all(m["moves"] in e2e for m in layers)


@pytest.mark.parametrize("name", LAYERS)
def test_metric_reader_declares_what_benchmark_json_says(name):
    m = {x["name"]: x for x in SPEC["per_layer"]}[name]
    mod = harness.metric_reader(name)
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"], m["moves"])
    assert callable(mod.read)
    for cell in m.get("workloads", CELLS):
        assert m["moves"] in {e["name"] for e in harness.end_to_end(SPEC, cell)}


def test_every_config_is_used_and_layers_share_names():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    layers = {m["layer"] for m in SPEC["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    assert all(f"| {layer} |" in perf for layer in layers)


@pytest.mark.parametrize("traced", [False, True])
def test_dry_run_prints_the_result_line(traced, capsys):
    result = tiny.run("road-europe-stream", traced=traced)
    run_cli.report(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == want and list(line)[-1] == "checks"
    assert set(line) == set(want) | {"checks"} | ({"breakdown"} if traced else set())
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    names = {m["name"] for m in (harness.per_layer(SPEC, "road-europe-stream") if traced
                                 else harness.end_to_end(SPEC, "road-europe-stream"))}
    assert set(line["metrics"]) <= names
    if not traced:
        assert set(line["metrics"]) == names
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert all(s.startswith("check ") and "limit" in s for s in last)


def test_profiler_starts_for_the_window_s_last_trace_seconds(monkeypatch):
    class Tracer:
        enabled, active, summary, seconds, starts = True, False, None, 4.0, 0

        def start(self):
            self.active, self.starts = True, self.starts + 1

    ctx = harness.Ctx(cell="c", seed=1, seconds=10.0, device=torch.device("cpu"), config={},
                      traffic={}, limits={}, t_process=0.0, spans=None, tracer=Tracer())
    clock = iter([99.0, 100.0, 105.0, 106.5, 107.0])  # set-up, start, three ticks
    monkeypatch.setattr(harness.time, "perf_counter", lambda: next(clock))
    ctx.open_window()
    assert ctx.tracer.starts == 0           # a 4 s trace of a 10 s window waits
    ctx.tick()
    assert ctx.tracer.starts == 0           # 5 s in
    ctx.tick()
    assert ctx.tracer.starts == 1           # 6.5 s in: the last 4 s are traced
    ctx.tick()
    assert ctx.tracer.starts == 1


def test_forbidden_modules_compare_whole_top_level_names():
    fine = ["repro_torch", "repro_torch.core.digraph", "jaxtyping", "flaxen", "torch"]
    assert harness.forbidden_loaded(fine) == []
    assert harness.forbidden_loaded(fine + ["repro.core", "jax.numpy", "flax"]) == [
        "flax", "jax", "repro"]


def test_a_run_loads_neither_jax_nor_repro():
    code = ("import sys, time; sys.path[:0] = [%r, %r]\n"
            "from bench.tests import tiny\nfrom bench import harness\n"
            "r = tiny.run('social22-walk16', seconds=0.2)\n"
            "print(r['correct'], harness.forbidden_loaded())" % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.stdout.strip().splitlines()[-1] == "True []", out.stderr[-2000:]


def test_command_without_a_card_exits_non_zero_and_prints_nothing():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "road-europe-stream", "--seed",
                          str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    if "needs 1 CUDA device" not in out.stderr:
        pytest.skip("a CUDA device is present")
    assert out.returncode != 0 and out.stdout == ""


def test_stream_idle_share_reads_untraced_rounds():
    # rounds of 0.2 s untraced, then three traced rounds slowed to 0.3 s
    ends = [(0.2, 0, 0, False), (0.4, 0, 0, False), (0.9, 0, 0, True),
            (1.2, 0, 0, True), (1.5, 0, 0, True)]
    assert stream.untraced_round_s(ends) == pytest.approx(0.2)
    assert stream.untraced_round_s([(0.3, 0, 0, True)]) is None
    record = {"trace": {"busy_s": 0.15, "window_s": 1.1}, "traced_walks": [(42, 1, 9)] * 3,
              "round_s_untraced": 0.2}
    assert readers.idle_pct_of_rounds(record) == pytest.approx(75.0)
    assert readers.idle_pct_of_rounds({**record, "trace": None}) is None
    assert readers.idle_pct_of_rounds({**record, "round_s_untraced": None}) is None
