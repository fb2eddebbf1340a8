"""The dry run's counters and CLI (``repro_torch.launch.dryrun``).

Each case runs in a fresh process: the dry run joins a fake process group,
which would outlive the test in this one.

* **The counters:** on a fake (2, 2) ``("data", "model")`` mesh, one
  sharded product and its gather count the LOCAL product's flops (a
  ``FlopCounterMode`` outside DTensor would count the global one) and the
  all-gathers' operand bytes; a contraction-sharded product's
  ``Partial → Shard(0)`` is one reduce-scatter of the local partial.
* **The CLI** on the production 16×16 mesh writes an ``ok`` record with
  the fields ``launch.roofline`` reads, and a cell that fails is recorded
  as ``"status": "error"`` with its reason.
"""
import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

_COUNTERS = textwrap.dedent("""
    import json, torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch import dryrun, mesh as mesh_mod
    dryrun.init_fake_world(4)
    mesh = mesh_mod.make_mesh_like((2, 2), ("data", "model"), device_type="cpu")

    def dist(shape, pl):
        return distribute_tensor(torch.empty(shape), mesh, pl, src_data_rank=None)

    with FakeTensorMode():
        a, w = dist((64, 32), [Shard(0), Replicate()]), dist((32, 16), [Replicate(), Shard(1)])
        b, v = dist((64, 32), [Replicate(), Shard(1)]), dist((32, 16), [Replicate(), Shard(0)])
        with dryrun.LocalCounter() as gather:
            (a @ w).redistribute(mesh, [Replicate(), Replicate()])
        with dryrun.LocalCounter() as scatter:
            (b @ v).redistribute(mesh, [Replicate(), Shard(0)])
    print(json.dumps([[c.flops, c.collectives()] for c in (gather, scatter)]))
""")


def _run(code, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                       cwd=ROOT, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_counters_count_local_flops_and_collective_bytes():
    (g_flops, g_coll), (s_flops, s_coll) = json.loads(_run(_COUNTERS).splitlines()[-1])
    # a [32, 32] row block times a [32, 8] column block on each rank
    assert g_flops == 2 * 32 * 32 * 8
    # the [32, 8] result gathered over one axis, then the [32, 16] over the other
    assert g_coll["count"] == {"all-gather": 2}
    assert g_coll["total_bytes"] == {"all-gather": (32 * 8 + 32 * 16) * 4}
    # [64, 16] rows by [16, 16] on each rank: a Partial(sum) scattered by rows
    assert s_flops == 2 * 64 * 16 * 16
    assert s_coll["count"] == {"reduce-scatter": 1}
    assert s_coll["total_bytes"] == {"reduce-scatter": 64 * 16 * 4}
    assert g_coll["while_body_bytes"] == {}


def test_cli_records_ok_and_error_cells(tmp_path):
    code = textwrap.dedent("""
        import sys
        from repro_torch.launch import dryrun
        rc = dryrun.main(["--arch", "gcn-cora", "--shape", "molecule", "--device", "cpu",
                          "--out", sys.argv[1]])
        rc2 = dryrun.main(["--arch", "h2o-danube-1.8b", "--shape", "train_4k",
                           "--variant", "cost3", "--device", "cpu", "--out", sys.argv[1]])
        print(rc, rc2)
    """)
    out = _run(code, str(tmp_path))
    assert out.split()[-2:] == ["0", "1"]
    ok = json.loads((tmp_path / "16x16" / "gcn-cora__molecule__full.json").read_text())
    assert ok["status"] == "ok" and ok["n_devices"] == 256 and ok["mesh"] == "16x16"
    assert ok["cost"]["flops"] > 0 and ok["cost"]["bytes_accessed"] > 0
    assert ok["memory"]["argument_bytes"] > 0 and ok["memory"]["peak_bytes"] > 0
    assert ok["collectives"]["total_bytes"]["all-reduce"] > 0
    assert ok["loop_correction"] == {"kind": "gnn"}
    bad = json.loads((tmp_path / "16x16" / "h2o-danube-1.8b__train_4k__cost3.json")
                     .read_text())
    assert bad["status"] == "error" and "cost3" in bad["error"]
