"""The port's roofline (``repro_torch.launch.roofline``) against
``repro``'s: ``model_flops`` bit for bit for all 40 cells, and
``step_costs`` from the same dry-run records; the terms priced with the
H100 data-sheet constants."""
import json

import pytest

from repro.configs import base as j_base
from repro.launch import roofline as j_roofline
from repro_torch.configs import base
from repro_torch.launch import roofline

j_base.all_archs()

#: (arch, shape, {variant: (flops, bytes, collective bytes)}, loop_correction)
RECORDS = [
    ("h2o-danube-1.8b", "train_4k",
     {"full": (9e15, 4e12, 3e11), "cost2": (3e13, 9e10, 5e9), "cost4": (5e13, 1.5e11, 8e9),
      "opt1": (1e9, 2e9, 1e6), "opt2": (1.5e9, 3e9, 2e6)},
     {"kind": "lm_train", "n_layers": 24, "accum": 16, "full_layers": 24}),
    ("qwen2-72b", "prefill_32k",
     {"full": (7e16, 3e13, 2e12), "cost2": (2e15, 7e11, 9e10), "cost4": (3.5e15, 1.3e12, 1.6e11)},
     {"kind": "lm_prefill", "full_layers": 80}),
    ("mace", "ogb_products",
     {"full": (4e14, 9e12, 1e12), "chunk2": (3e14, 7e12, 8e11), "chunk4": (2e14, 5e12, 6e11)},
     {"kind": "gnn_chunked", "chunks": 64, "layers": 2}),
    ("two-tower-retrieval", "serve_bulk", {"full": (4e12, 2e11, 1e9)}, {"kind": "recsys"}),
]


def test_model_flops_match_repro_for_all_cells():
    cells = base.all_cells()
    assert len(cells) == 40
    for arch, shape, _ in cells:
        assert roofline.model_flops(arch, shape) == j_roofline.model_flops(arch, shape), \
            (arch, shape)


@pytest.fixture
def records(tmp_path, monkeypatch):
    d = tmp_path / "16x16"
    d.mkdir()
    for arch, shape, variants, lc in RECORDS:
        for v, (flops, nbytes, coll) in variants.items():
            rec = {"arch": arch, "shape": shape, "variant": v, "status": "ok",
                   "cost": {"flops": flops, "bytes_accessed": nbytes},
                   "collectives": {"total_bytes": {"all-gather": coll / 4,
                                                   "all-reduce": coll * 3 / 4}},
                   "memory": {"peak_bytes": 7e10, "total_bytes": 7e10,
                              "peak_bytes_aliased": 7e10},
                   "loop_correction": lc}
            (d / f"{arch}__{shape}__{v}.json").write_text(json.dumps(rec))
    monkeypatch.setattr(roofline, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(j_roofline, "RESULTS_DIR", str(tmp_path))


def test_step_costs_match_repro(records):
    """``repro``'s extrapolations, but for MACE's chunk loop: the port's
    records count every chunk's trip (a Python loop), so the full variant's
    costs are the step's, where ``repro`` undoes XLA's once-counted scan."""
    for arch, shape, variants, lc in RECORDS:
        got = roofline.step_costs(arch, shape)
        if lc["kind"] == "gnn_chunked":
            flops, nbytes, coll = variants["full"]
            assert got == {"flops": flops, "bytes": nbytes, "coll": coll}
            assert got != j_roofline.step_costs(arch, shape)
            continue
        assert got is not None and got == j_roofline.step_costs(arch, shape), (arch, shape)


def test_costs_from_the_variants_without_the_full_record(records, tmp_path):
    """A sweep that could not dry-run a cell's full variant still prices it
    from the reduced ones (its memory unknown), as ``step_costs`` would."""
    lm, mace = RECORDS[0], RECORDS[2]
    for arch, shape, _, _ in (lm, mace):
        want = roofline.step_costs(arch, shape)
        (tmp_path / "16x16" / f"{arch}__{shape}__full.json").unlink()
        row = roofline.analyze_cell(arch, shape)
        if arch == "mace":  # the chunk2 record's own costs
            flops, nbytes, coll = mace[2]["chunk2"]
            want = {"flops": flops, "bytes": nbytes, "coll": coll}
        assert row["status"] == "ok" and row["full"] is False and row["hbm_peak_gib"] is None
        assert row["compute_s"] == want["flops"] / 989e12
        assert row["collective_s"] == want["coll"] / 50e9


def test_terms_are_priced_on_h100_constants(records):
    rows = {(r["arch"], r["shape"]): r for r in roofline.analyze_all()}
    assert len(rows) == 40
    for arch, shape, _, _ in RECORDS:
        r, step = rows[(arch, shape)], roofline.step_costs(arch, shape)
        assert r["status"] == "ok"
        assert r["compute_s"] == step["flops"] / 989e12
        assert r["memory_s"] == step["bytes"] / 3.35e12
        assert r["collective_s"] == step["coll"] / 50e9
        assert r["fits_hbm"] and r["hbm_peak_gib"] == 7e10 / 2**30
    assert rows[("gcn-cora", "molecule")]["status"] == "missing"
    table = roofline.markdown_table(list(rows.values()))
    assert table.count("\n") == 42 and "| mace | ogb_products |" in table
