"""The tiny rehearsal sizes a cell by what it is made of, not by its names.

The accepted cells keep the tiny sizes they always had; a family or loop
with no tiny size says where to add one; and a configuration that no file
under ``bench/`` names (a directed R-MAT with the web quadrants), with a
cell of it on the road's stream mix, runs from files of its own written
outside the checkout: sound, it is ``correct``, and its control is not.
"""
from __future__ import annotations

import json
import shutil

import pytest
import torch

from bench import gen, harness
from bench.loops import stream
from bench.tests import tiny

SPEC = harness.benchmark()
#: the tiny graph sizes each accepted configuration has always had
FORMER_SIZES = {
    "rmat22-social": {"scale": 8, "vertices": 256, "edge_factor": 16, "edges": 4096},
    "road-europe-osm": {"vertices": 256, "edges": 560},
}
#: the tiny traffic each accepted loop kind has always had
FORMER_TRAFFIC = {
    "stream": {"batch_fraction": 0.01, "max_rounds_per_s": 600, "trace_seconds": 10},
    "walks": {"batch_fraction": 0.02, "max_calls_per_s": 5000, "trace_seconds": 10,
              "check_stride": 2},
}
WEB = {
    "name": "rmat23-web",
    "source": "indochina-2004, SuiteSparse LAW (https://sparse.tamu.edu/LAW/indochina-2004)",
    "generator": "rmat", "scale": 23, "edge_factor": 24, "a": 0.57, "b": 0.19, "c": 0.19,
    "symmetric": False, "weight_range": [0.5, 1.5],
    "vertices": 8388608, "edges": 194109311,
    "reduced": {},
    "guarantees": "every acknowledged batch is applied exactly",
}
CELL = "web23-stream"


@pytest.mark.parametrize("name", sorted(FORMER_SIZES))
def test_accepted_config_keeps_its_tiny_sizes(name):
    entry = {c["name"]: c for c in SPEC["configs"]}[name]
    assert tiny.config_sizes(harness.load_json(harness.ROOT / entry["file"])) == \
        FORMER_SIZES[name]


@pytest.mark.parametrize("kind", sorted(FORMER_TRAFFIC))
def test_accepted_loop_keeps_its_tiny_traffic(kind):
    assert tiny.traffic_sizes({"loop": kind}) == FORMER_TRAFFIC[kind]


def test_a_family_or_loop_without_tiny_sizes_says_where_to_add_them(monkeypatch):
    with pytest.raises(LookupError, match="SIZES in bench/tests/tiny.py"):
        tiny.config_sizes({"generator": "kronecker"})
    monkeypatch.delattr(stream, "TINY")
    with pytest.raises(LookupError, match="TINY dict to bench/loops/stream.py"):
        tiny.traffic_sizes({"loop": "stream"})


def test_tiny_sizes_keep_a_directed_configuration_directed():
    cfg = {**WEB, **tiny.config_sizes(WEB)}
    assert cfg["symmetric"] is False and (cfg["a"], cfg["b"], cfg["c"]) == (0.57, 0.19, 0.19)
    src, dst, _, n = gen.make_graph(cfg, 5, torch.device("cpu"))
    keys = set((src.to(torch.int64) * n + dst).tolist())
    back = set((dst.to(torch.int64) * n + src).tolist())
    assert keys - back, "a directed R-MAT graph has edges without their reverse"


def _checkout_files() -> dict:
    bench = harness.ROOT / "bench"
    files = [p for d in ("configs", "traffic", "limits") for p in (bench / d).iterdir()]
    files.append(harness.ROOT / "BENCHMARK.json")
    return {str(p): p.read_bytes() for p in files}


@pytest.mark.parametrize("control", [False, True], ids=["sound", "control"])
def test_a_new_config_joins_the_rehearsal_by_its_own_files(control, tmp_path, monkeypatch):
    before = _checkout_files()
    bench = tmp_path / "bench"
    shutil.copytree(harness.HERE / "traffic", bench / "traffic")
    (bench / "configs").mkdir()
    (bench / "configs" / "rmat23-web.json").write_text(json.dumps(WEB))
    (bench / "limits").mkdir()
    shutil.copy(harness.HERE / "limits" / "road-europe-stream.json",
                bench / "limits" / f"{CELL}.json")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": WEB["name"], "source": WEB["source"],
                            "file": "bench/configs/rmat23-web.json", "reduced": [],
                            "why": "directed web crawl: hub rows wider than a warp"})
    spec["workloads"].append({"name": CELL, "config": WEB["name"],
                              "traffic": "stream-mixed-1e-3", "chips": 1,
                              "why": "the road's stream rounds on a directed web graph"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "road-europe-stream" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "HERE", bench)

    r = tiny.run(CELL, spec=harness.benchmark(tmp_path), seconds=0.2, control=control)
    monkeypatch.undo()
    assert _checkout_files() == before
    assert set(r["metrics"]) == {"round_ms", "setup_s"}
    if not control:
        assert r["correct"] is True, r["checks"]
    else:
        assert r["correct"] is False
        assert r["checks"]["walk_gap"]["value"] > r["checks"]["walk_gap"]["limit"]
