"""Durability in the port (``repro_torch.runtime.durable``,
``repro_torch.checkpoint.manager``, ``repro_torch.runtime.faultinject``),
on the CPU.

Two halves:

* the port alone: every journal, checkpoint-manager, crash, torn-tail,
  interrupted-checkpoint, auto-checkpoint, hypothesis-sweep and audit case
  of ``tests/test_durable.py``, over the five representations and the three
  crash points, held bit for bit (``state_tree()`` and ``to_csr()``)
  against an uncrashed twin;
* the port against ``repro`` on the same numpy inputs: WAL segments byte
  for byte, checkpoints (flat and pytree) restored across the packages,
  and a journal plus checkpoints one package wrote through a crash
  recovered by the other, bit for bit against the writer's uncrashed twin.
"""
import json
import os
import pathlib
import shutil
import types

import numpy as np
import pytest
import torch

import repro.core as J
from repro.checkpoint import manager as j_ckpt
from repro.core import edgebatch as j_eb
from repro.core import updates as j_up
from repro.runtime import durable as j_dur
from repro.runtime import faultinject as j_fi
import repro_torch.core as T
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import csr, edgebatch, updates
from repro_torch.core import tree as tree_mod
from repro_torch.runtime import durable, faultinject

N_V = 48
NAMES = list(T.REPRESENTATIONS)
CRASH_POINTS = ("durable.pre_append", "durable.post_append", "durable.post_apply")
CPU = {"device": "cpu"}

PKGS = {
    "repro": types.SimpleNamespace(reps=J.REPRESENTATIONS, durable=j_dur, fi=j_fi,
                                   ckpt=j_ckpt, eb=j_eb, up=j_up, kw={}),
    "port": types.SimpleNamespace(reps=T.REPRESENTATIONS, durable=durable, fi=faultinject,
                                  ckpt=ckpt, eb=edgebatch, up=updates, kw=CPU),
}


@pytest.fixture(autouse=True)
def _port_faultinject_leak_guard():
    """Fail a test that leaks an armed point of the port's registry (the
    conftest guard watches ``repro``'s only)."""
    faultinject.disarm()
    yield
    leaked = faultinject.armed()
    if leaked:
        faultinject.disarm()
        pytest.fail(f"test leaked armed port faultinject points: {leaked}")


def _coo(seed=11, m=220):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N_V, m), rng.integers(0, N_V, m),
            rng.random(m).astype(np.float32))


@pytest.fixture(scope="module")
def base_csr():
    return csr.from_coo(*_coo(), n=N_V, device="cpu")


def _base(pkg):
    """The same base graph as a CSR of ``pkg`` ("repro" or "port")."""
    if pkg == "repro":
        return J.from_coo(*_coo(), n=N_V)
    return csr.from_coo(*_coo(), n=N_V, device="cpu")


def make_plans(k=6, seed=7, n=N_V, pkg="port"):
    p = PKGS[pkg]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        ib = p.eb.from_arrays(rng.integers(0, n, 12), rng.integers(0, n, 12),
                              rng.random(12).astype(np.float32))
        db = p.eb.from_arrays(rng.integers(0, n, 6), rng.integers(0, n, 6))
        out.append(p.up.plan_update(inserts=ib, deletes=db))
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_bit_parity(a, b):
    """``to_csr()`` and ``state_tree()`` of two representations (of either
    package) bit for bit.  ``to_csr`` runs first on both: it consolidates a
    LazyCSR, so both sides settle the same way before their states are
    read."""
    ca, cb = a.to_csr(), b.to_csr()
    assert (int(ca.n), int(ca.m)) == (int(cb.n), int(cb.m))
    for f in ("offsets", "dst", "wgt"):
        x, y = _np(getattr(ca, f)), _np(getattr(cb, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x[: ca.m] if f != "offsets" else x,
                                      y[: cb.m] if f != "offsets" else y, err_msg=f)
    ta, tb = a.state_tree(), b.state_tree()
    assert ta.keys() == tb.keys()
    for k in ta:
        x, y = np.asarray(ta[k]), np.asarray(tb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


# ---------------------------------------------------------------------------
# WAL record / journal mechanics
# ---------------------------------------------------------------------------


def test_wal_record_roundtrip():
    plan = make_plans(1)[0]
    rec = durable.encode_record(9, 77, plan)
    seq, nv, (qs, qd, qw, ql) = durable.decode_record(
        rec[: durable._HEADER.size], rec[durable._HEADER.size :]
    )
    assert (seq, nv) == (9, 77)
    np.testing.assert_array_equal(qs, plan.q_src)
    np.testing.assert_array_equal(qd, plan.q_dst)
    np.testing.assert_array_equal(qw, plan.q_wgt)
    np.testing.assert_array_equal(ql, plan.q_del)


def test_journal_append_replay_rotation(tmp_path):
    wal = str(tmp_path / "wal")
    j = durable.UpdateJournal(wal, segment_bytes=256)  # force rotation
    plans = make_plans(5)
    seqs = [j.append(p, N_V) for p in plans]
    assert seqs == [1, 2, 3, 4, 5]
    assert len(j.segments()) > 1  # each ~240-byte record rotates
    j.close()
    j2 = durable.UpdateJournal(wal, segment_bytes=256)
    got = list(j2.replay())
    assert [s for s, _, _ in got] == seqs
    for (_, nv, (qs, qd, qw, ql)), p in zip(got, plans):
        assert nv == N_V
        np.testing.assert_array_equal(qs, p.q_src)
        np.testing.assert_array_equal(qw, p.q_wgt)
    assert [s for s, _, _ in j2.replay(after=3)] == seqs[3:]
    assert j2.next_seq == 6  # reopen resumes the sequence
    j2.close()


def test_journal_truncate_through(tmp_path):
    wal = str(tmp_path / "wal")
    j = durable.UpdateJournal(wal, segment_bytes=256)
    for p in make_plans(6):
        j.append(p, N_V)
    assert len(j.segments()) >= 3
    j.truncate_through(6)
    assert len(j.segments()) == 1  # only the append target survives
    assert all(s <= 6 for s, _, _ in j.replay())
    j.close()


def test_torn_tail_repaired_on_recovery_open(tmp_path):
    wal = str(tmp_path / "wal")
    j = durable.UpdateJournal(wal)
    for p in make_plans(3):
        j.append(p, N_V)
    j.close()
    faultinject.tear_tail(j.segments()[-1], 10)  # torn mid-record at the tail
    j2 = durable.UpdateJournal(wal, repair=True)
    assert [s for s, _, _ in j2.replay()] == [1, 2]  # record 3 cut
    assert j2.next_seq == 3  # its sequence number is reused
    j2.close()


def test_corrupt_record_raises(tmp_path):
    wal = str(tmp_path / "wal")
    j = durable.UpdateJournal(wal)
    for p in make_plans(3):
        j.append(p, N_V)
    j.close()
    # flip a payload byte of the FIRST record: complete but rotten
    faultinject.corrupt_byte(j.segments()[0], durable._HEADER.size + 3)
    with pytest.raises(durable.WalCorruptError):
        list(durable.UpdateJournal(wal).replay())
    with pytest.raises(durable.WalCorruptError):  # repair refuses too
        durable.UpdateJournal(wal, repair=True)


def test_scan_next_seq_reads_final_segment_only(tmp_path):
    wal = str(tmp_path / "wal")
    j = durable.UpdateJournal(wal, segment_bytes=256)
    for p in make_plans(6):
        j.append(p, N_V)
    j.close()
    segs = j.segments()
    assert len(segs) >= 3
    faultinject.corrupt_byte(segs[0], durable._HEADER.size + 3)
    j2 = durable.UpdateJournal(wal, segment_bytes=256)  # opens fine
    assert j2.next_seq == 7
    with pytest.raises(durable.WalCorruptError):
        list(j2.replay())  # the full decode still sees the rot
    j2.close()


def test_scan_next_seq_torn_final_segment(tmp_path):
    wal = str(tmp_path / "wal")
    j = durable.UpdateJournal(wal, segment_bytes=256)
    for p in make_plans(4):
        j.append(p, N_V)
    j.close()
    faultinject.tear_tail(j.segments()[-1], 10)
    j2 = durable.UpdateJournal(wal, segment_bytes=256)
    assert j2.next_seq == 4  # without repair the torn record is not counted
    j2.close()


def test_journal_fsync_rotation_durable(tmp_path):
    wal = str(tmp_path / "wal")
    j = durable.UpdateJournal(wal, segment_bytes=256, fsync=True)
    for p in make_plans(5):
        j.append(p, N_V)
    assert len(j.segments()) > 1
    assert [s for s, _, _ in j.replay()] == [1, 2, 3, 4, 5]
    j.close()


def test_group_append_one_flush_one_segment(tmp_path):
    wal = str(tmp_path / "wal")
    j = durable.UpdateJournal(wal, segment_bytes=256)
    plans = make_plans(4)
    f0 = j.flushes
    seqs = j.append_group(plans, [N_V] * 4)
    assert seqs == [1, 2, 3, 4] and j.flushes - f0 == 1
    assert len(j.segments()) == 1  # a group never splits across segments
    got = list(j.replay())
    assert [s for s, _, _ in got] == seqs
    for (_, _, (qs, _, _, _)), p in zip(got, plans):
        np.testing.assert_array_equal(qs, p.q_src)
    j.append_group(make_plans(2, seed=5), [N_V] * 2)  # rotates first, then lands
    assert len(j.segments()) == 2
    assert [s for s, _, _ in j.replay()] == [1, 2, 3, 4, 5, 6]
    j.close()


def test_wal_disk_full_rolls_back_and_retries(tmp_path):
    wal = str(tmp_path / "wal")
    j = durable.UpdateJournal(wal)
    plans = make_plans(3)
    j.append(plans[0], N_V)
    seq0, flushes0 = j.next_seq, j.flushes
    size0 = os.path.getsize(j.segments()[-1])
    faultinject.arm("wal.write", times=1)
    with pytest.raises(durable.WalDiskFullError):
        j.append(plans[1], N_V)
    faultinject.disarm()
    assert j.next_seq == seq0 and j.flushes == flushes0
    assert os.path.getsize(j.segments()[-1]) == size0  # truncated back
    assert [s for s, _, _ in j.replay()] == [1]
    assert j.append(plans[1], N_V) == seq0  # retry on the SAME handle
    j.append(plans[2], N_V)
    j.close()
    j2 = durable.UpdateJournal(wal)
    assert [s for s, _, _ in j2.replay()] == [1, 2, 3]
    j2.close()


def test_wal_disk_full_group_append_atomic(tmp_path):
    wal = str(tmp_path / "wal")
    j = durable.UpdateJournal(wal)
    j.append_group(make_plans(2, seed=3), [N_V] * 2)
    group = make_plans(3, seed=4)
    with faultinject.injected("wal.write"):
        with pytest.raises(durable.WalDiskFullError):
            j.append_group(group, [N_V] * 3)
    assert j.next_seq == 3
    assert [s for s, _, _ in j.replay()] == [1, 2]  # no torn group suffix
    assert j.append_group(group, [N_V] * 3) == [3, 4, 5]
    assert [s for s, _, _ in j.replay()] == [1, 2, 3, 4, 5]
    j.close()


# ---------------------------------------------------------------------------
# checkpoint manager: stale sweep, legacy manifests, diff chains
# ---------------------------------------------------------------------------
def test_clean_stale_sweeps_tmp_dirs(tmp_path):
    cd = str(tmp_path / "ckpt")
    ckpt.save_arrays(cd, 0, {"a": np.arange(4)})
    os.makedirs(os.path.join(cd, ".tmp_ckpt_dead1", "sub"))
    os.makedirs(os.path.join(cd, ".tmp_ckpt_dead2"))
    assert sorted(ckpt.clean_stale(cd)) == [".tmp_ckpt_dead1", ".tmp_ckpt_dead2"]
    assert not [n for n in os.listdir(cd) if n.startswith(".tmp_ckpt_")]
    assert ckpt.all_steps(cd) == [0]
    assert ckpt.clean_stale(cd) == []


def test_legacy_flat_manifest_restores(tmp_path):
    cd = str(tmp_path / "ckpt")
    d = os.path.join(cd, "step_0000000007")
    os.makedirs(d)
    arrays = {"dst": np.arange(10, dtype=np.int32), "deg": np.ones(5, np.int64)}
    np.savez(os.path.join(d, "shard_0.npz"), **arrays)
    manifest = {
        "step": 7,
        "keys": sorted(arrays),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
    }
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    got, step = ckpt.restore_arrays(cd)
    assert step == 7
    np.testing.assert_array_equal(got["dst"], arrays["dst"])
    shards, _ = ckpt.restore_arrays_sharded(cd)
    assert list(shards) == [0]
    np.testing.assert_array_equal(shards[0]["deg"], arrays["deg"])
    trees, _ = ckpt.restore_arrays_diff(cd)
    np.testing.assert_array_equal(trees[0]["dst"], arrays["dst"])
    with pytest.raises(FileNotFoundError):
        ckpt.restore_arrays(cd, shard_id=1)


def test_manager_diff_chain_and_crc_gate(tmp_path):
    cd = str(tmp_path / "ckpt")
    rng = np.random.default_rng(3)
    a0 = {"dst": rng.integers(0, 99, 9000).astype(np.int32),
          "deg": rng.integers(0, 9, 300).astype(np.int64)}
    ckpt.save_arrays_sharded(cd, 0, {0: dict(a0)})
    a1 = {k: v.copy() for k, v in a0.items()}
    a1["dst"][4096 // 4 + 1] = 777  # second 16 KiB chunk
    ckpt.save_arrays_diff(cd, 1, {0: a1})  # hash-compare diff
    a2 = {k: v.copy() for k, v in a1.items()}
    a2["deg"][5] = 42
    p2 = ckpt.save_arrays_diff(cd, 2, {0: a2},
                               dirty={0: {"dst": "clean", "deg": np.array([[5, 6]])}})
    man = ckpt._read_manifest(p2)
    assert man["kind"] == "diff" and man["base_step"] == 1
    for s, want in ((0, a0), (1, a1), (2, a2)):
        trees, _ = ckpt.restore_arrays_diff(cd, step=s)
        for k in want:
            np.testing.assert_array_equal(trees[0][k], want[k])
    man["shards"]["0"]["chunks"]["deg"][0] ^= 0xFF
    with open(os.path.join(p2, "manifest.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="CRC"):
        ckpt.restore_arrays_diff(cd, step=2)


def test_diff_rotation_keeps_chain_base(tmp_path):
    cd = str(tmp_path / "ckpt")
    a = {"x": np.arange(64, dtype=np.int64)}
    ckpt.save_arrays_sharded(cd, 0, {0: dict(a)})
    for s in (1, 2, 3, 4):
        ckpt.save_arrays_diff(cd, s, {0: dict(a)}, keep=2)
    assert 0 in ckpt.all_steps(cd)  # the full base survives keep=2
    trees, _ = ckpt.restore_arrays_diff(cd)
    np.testing.assert_array_equal(trees[0]["x"], a["x"])
    ckpt.save_arrays_sharded(cd, 5, {0: dict(a)}, keep=2)
    ckpt.save_arrays_sharded(cd, 6, {0: dict(a)}, keep=2)
    assert ckpt.all_steps(cd) == [5, 6]


def _diff_chain(tmp_path, nshards=1, mgr=ckpt):
    cd = str(tmp_path / "ckpt")
    rng = np.random.default_rng(9)
    shards0 = {
        s: {"dst": rng.integers(0, 99, 4000).astype(np.int32) + s,
            "deg": rng.integers(0, 9, 64).astype(np.int64)}
        for s in range(nshards)
    }
    mgr.save_arrays_sharded(cd, 0, {s: dict(t) for s, t in shards0.items()})
    shards1 = {s: {k: v.copy() for k, v in t.items()} for s, t in shards0.items()}
    for s in shards1:
        shards1[s]["dst"][7] = 12345 + s
    mgr.save_arrays_diff(cd, 1, {s: dict(t) for s, t in shards1.items()})
    return cd, shards1


def test_restore_diff_corrupt_base_manifest_json(tmp_path):
    cd, _ = _diff_chain(tmp_path)
    with open(os.path.join(cd, "step_0000000000", "manifest.json"), "w") as f:
        f.write('{"step": 0, "kind": "fu')  # torn JSON
    with pytest.raises(ValueError, match="corrupt"):
        ckpt.restore_arrays_diff(cd, step=1)
    with pytest.raises(ValueError, match="corrupt"):
        ckpt.restore_shard_diff(cd, 0, step=1)


def test_restore_diff_base_payload_digest_gate(tmp_path):
    cd, _ = _diff_chain(tmp_path)
    man_path = os.path.join(cd, "step_0000000000", "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    man["shards"]["0"]["chunks"]["dst"][0] ^= 0xFF
    with open(man_path, "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="aborted before patching"):
        ckpt.restore_arrays_diff(cd, step=1)
    assert ckpt.restore_arrays(cd, step=0) is not None  # the base alone restores


def test_restore_diff_missing_base_step(tmp_path):
    cd, _ = _diff_chain(tmp_path)
    shutil.rmtree(os.path.join(cd, "step_0000000000"))
    with pytest.raises((FileNotFoundError, ValueError)):
        ckpt.restore_arrays_diff(cd, step=1)
    with pytest.raises((FileNotFoundError, ValueError)):
        ckpt.restore_shard_diff(cd, 0, step=1)


def test_restore_shard_diff_matches_full_restore(tmp_path):
    cd, want = _diff_chain(tmp_path, nshards=2)
    full, step_f = ckpt.restore_arrays_diff(cd, step=1)
    for sid in (0, 1):
        arrays, step = ckpt.restore_shard_diff(cd, sid, step=1)
        assert step == step_f == 1
        for k in want[sid]:
            np.testing.assert_array_equal(arrays[k], want[sid][k])
            np.testing.assert_array_equal(arrays[k], full[sid][k])
    with pytest.raises(FileNotFoundError):
        ckpt.restore_shard_diff(cd, 7, step=1)


def test_rotation_never_orphans_mid_chain_base(tmp_path):
    cd = str(tmp_path / "ckpt")
    a = {"x": np.arange(32, dtype=np.int64)}
    ckpt.save_arrays_sharded(cd, 0, {0: dict(a)})
    ckpt.save_arrays_diff(cd, 1, {0: dict(a)}, keep=2)
    ckpt.save_arrays_sharded(cd, 2, {0: dict(a)}, keep=2)
    ckpt.save_arrays_diff(cd, 3, {0: dict(a)}, keep=2)
    steps = ckpt.all_steps(cd)
    for s in steps:
        man = ckpt._read_manifest(os.path.join(cd, f"step_{s:010d}"))
        if man.get("kind") == "diff":
            assert man["base_step"] in steps, f"diff {s} orphaned"
        trees, got = ckpt.restore_arrays_diff(cd, step=s)
        assert got == s and trees


def test_checkpoint_refuses_tensors(tmp_path):
    """A tensor is the caller's to copy: nothing is written for it."""
    cd = str(tmp_path / "ckpt")
    with pytest.raises(TypeError, match="host arrays"):
        ckpt.save_arrays(cd, 0, {"w": torch.ones(3)})
    with pytest.raises(TypeError, match="host arrays"):
        ckpt.save(cd, 0, {"layer": [torch.zeros(2)]})
    assert ckpt.all_steps(cd) == []
    assert not [n for n in os.listdir(cd) if n.startswith(".tmp_ckpt_")]


def test_pytree_save_restore_hook(tmp_path):
    cd = str(tmp_path / "ckpt")
    tree = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "b": [np.arange(3, dtype=np.int64), None]},
            "opt": (np.float32(0.5), np.ones(4, np.int32))}
    hook = ckpt.checkpoint_hook(cd, every=2, keep=2)
    for step in range(1, 6):
        hook(step, tree)
    assert ckpt.all_steps(cd) == [2, 4]
    like = {"params": {"w": torch.zeros(2, 3, dtype=torch.float64),
                       "b": [torch.zeros(3, dtype=torch.int64), None]},
            "opt": (torch.zeros((), dtype=torch.float32), np.zeros(4, np.int32))}
    got, step = ckpt.restore(cd, like)
    assert step == 4
    assert got["params"]["w"].dtype == torch.float64 and got["params"]["b"][1] is None
    assert isinstance(got["opt"], tuple) and got["opt"][1].dtype == torch.int32
    np.testing.assert_array_equal(got["params"]["w"].numpy(), tree["params"]["w"])
    np.testing.assert_array_equal(got["params"]["b"][0].numpy(), tree["params"]["b"][0])
    assert float(got["opt"][0]) == 0.5
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore(cd, {"params": {"w": like["params"]["w"]}})


# ---------------------------------------------------------------------------
# checkpoint bit-parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_checkpoint_roundtrip_bit_parity(name, base_csr, tmp_path):
    cls = T.REPRESENTATIONS[name]
    g = cls.from_csr(base_csr, **CPU)
    plans = make_plans(4, seed=3)
    for p in plans[:2]:
        g, _ = g.apply(p)
    d = str(tmp_path / "ck")
    ckpt.save_arrays(d, 0, g.state_tree())
    arrays, _ = ckpt.restore_arrays(d)
    h = cls.from_state_tree(arrays, **CPU)
    assert_bit_parity(g, h)
    # the restored instance keeps applying in lockstep — exact state
    for p in plans[2:]:
        g, _ = g.apply(p)
        h, _ = h.apply(p)
    assert_bit_parity(g, h)
    assert torch.equal(g.reverse_walk(3), h.reverse_walk(3))


# ---------------------------------------------------------------------------
# crash-recovery sweeps
# ---------------------------------------------------------------------------


def run_crash(pkg, name, tmp_path, point, kcrash=3, n_plans=6, seed=7, ckpt_at=None,
              **wrap):
    """Drive ``pkg``'s durable stream into a crash at ``point`` (a diff
    checkpoint after plan ``ckpt_at``, if given).  Returns (wal dir, ckpt
    dir, plans, how many plans the uncrashed twin applies)."""
    p = PKGS[pkg]
    wal, ck = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    plans = make_plans(n_plans, seed=seed, pkg=pkg)
    g = p.durable.DurableGraph(p.reps[name].from_csr(_base(pkg), **p.kw), wal, ck, **wrap)
    crashed = False
    for i, plan in enumerate(plans):
        if i == kcrash:
            p.fi.arm(point)
        try:
            g.apply(plan)
        except p.fi.SimulatedCrash:
            crashed = True
            break
        finally:
            p.fi.disarm()
        if i == ckpt_at:
            g.checkpoint()
    assert crashed
    g.close()
    # pre-append: the crashed apply never hit the log; post-*: it did
    return wal, ck, plans, kcrash if point == "durable.pre_append" else kcrash + 1


def twin(pkg, name, plans):
    p = PKGS[pkg]
    t = p.reps[name].from_csr(_base(pkg), **p.kw)
    for plan in plans:
        t, _ = t.apply(plan)
    return t


@pytest.mark.parametrize("point", CRASH_POINTS)
@pytest.mark.parametrize("name", NAMES)
def test_crash_recovery_bit_parity(name, point, tmp_path):
    wal, ck, plans, upto = run_crash("port", name, tmp_path, point)
    st = {}
    r = durable.DurableGraph.recover(wal, ck, stats=st, **CPU)
    assert st["records"] == upto and r.seq == upto
    tw = twin("port", name, plans[:upto])
    assert_bit_parity(r.rep, tw)
    assert torch.equal(r.reverse_walk(3), tw.reverse_walk(3))
    for p in plans[upto:]:  # the recovered stream keeps going, in lockstep
        r.apply(p)
        tw, _ = tw.apply(p)
    assert_bit_parity(r.rep, tw)
    r.close()


@pytest.mark.parametrize("name", NAMES)
def test_diff_checkpoint_group_commit_recovery(name, tmp_path):
    """diff=True: a differential step between applies, a group commit, a
    crash inside the group; recovery restores the chain and replays the
    group's records."""
    wal, ck = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    plans = make_plans(6, seed=19)
    g = durable.DurableGraph(T.REPRESENTATIONS[name].from_csr(_base("port"), **CPU), wal, ck,
                             diff=True, keep=2)
    for p in plans[:2]:
        g.apply(p)
    g.checkpoint()
    man = ckpt._read_manifest(os.path.join(ck, "step_0000000002"))
    assert man["kind"] == "diff" and man["base_step"] == 0
    flushes = g.journal.flushes
    g.apply_group(plans[2:4])
    assert g.journal.flushes == flushes + 1
    with faultinject.injected("durable.post_apply", after=1):
        with pytest.raises(faultinject.SimulatedCrash):
            g.apply_group(plans[4:6])
    g.close()
    st = {}
    r = durable.DurableGraph.recover(wal, ck, diff=True, stats=st, **CPU)
    assert st["records"] == 4 and r.seq == 6
    assert_bit_parity(r.rep, twin("port", name, plans))
    # replayed applies are untracked: the next checkpoint re-anchors in full
    r.checkpoint()
    assert ckpt._read_manifest(os.path.join(ck, "step_0000000006"))["kind"] == "full"
    r.close()


def test_crash_with_torn_tail(base_csr, tmp_path):
    cls = T.REPRESENTATIONS["digraph"]
    wal, ck = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    plans = make_plans(4)
    g = durable.DurableGraph(cls.from_csr(base_csr, **CPU), wal, ck)
    for p in plans:
        g.apply(p)
    g.close()
    faultinject.tear_tail(g.journal.segments()[-1], 7)  # record 4 torn
    r = durable.DurableGraph.recover(wal, ck, **CPU)
    assert r.seq == 3
    assert_bit_parity(r.rep, twin("port", "digraph", plans[:3]))
    r.close()


def test_interrupted_checkpoint_leaves_debris_and_recovers(base_csr, tmp_path):
    cls = T.REPRESENTATIONS["lazy"]
    wal, ck = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    plans = make_plans(3)
    g = durable.DurableGraph(cls.from_csr(base_csr, **CPU), wal, ck)
    for p in plans[:2]:
        g.apply(p)
    faultinject.arm("checkpoint.pre_rename")
    with pytest.raises(faultinject.SimulatedCrash):
        g.checkpoint()
    faultinject.disarm()
    g.close()
    assert [n for n in os.listdir(ck) if n.startswith(".tmp_ckpt_")]
    r = durable.DurableGraph.recover(wal, ck, **CPU)
    assert not [n for n in os.listdir(ck) if n.startswith(".tmp_ckpt_")]
    assert_bit_parity(r.rep, twin("port", "lazy", plans[:2]))  # step-0 base + full replay
    r.close()


def test_auto_checkpoint_prunes_wal(base_csr, tmp_path):
    cls = T.REPRESENTATIONS["coo"]
    wal, ck = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    g = durable.DurableGraph(cls.from_csr(base_csr, **CPU), wal, ck,
                             checkpoint_every=2, segment_bytes=256)
    plans = make_plans(6, seed=5)
    for p in plans:
        g.apply(p)
    assert ckpt.latest_step(ck) == 6
    assert len(g.journal.segments()) == 1  # pruned behind the checkpoint
    g.close()
    r = durable.DurableGraph.recover(wal, ck, **CPU)
    assert_bit_parity(r.rep, twin("port", "coo", plans))
    r.close()


def test_hypothesis_random_crash_sweep(tmp_path):
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=10, deadline=None)
    @given(seed=st.integers(min_value=0, max_value=2**31 - 1))
    def sweep(seed):
        kcrash, point = faultinject.FaultSchedule(seed, CRASH_POINTS).plan(4)
        name = NAMES[seed % len(NAMES)]
        base = pathlib.Path(tmp_path / f"s{seed}")
        os.makedirs(base, exist_ok=True)
        try:
            wal, ck, plans, upto = run_crash("port", name, base, point, kcrash=kcrash,
                                             n_plans=5, seed=seed)
            r = durable.DurableGraph.recover(wal, ck, **CPU)
            tw = twin("port", name, plans[:upto])
            assert_bit_parity(r.rep, tw)
            assert torch.equal(r.reverse_walk(2), tw.reverse_walk(2))
            r.close()
        finally:
            shutil.rmtree(base, ignore_errors=True)

    sweep()


def test_fault_schedule_matches_repro():
    for seed in (0, 1, 12345):
        a = faultinject.FaultSchedule(seed, CRASH_POINTS)
        b = j_fi.FaultSchedule(seed, CRASH_POINTS)
        assert [a.plan(4) for _ in range(5)] == [b.plan(4) for _ in range(5)]


def test_durable_graph_takes_registered_reps_only(base_csr, tmp_path):
    with pytest.raises(TypeError, match="registered"):
        durable.DurableGraph(base_csr, str(tmp_path / "wal"), str(tmp_path / "ckpt"))
    assert not os.path.exists(tmp_path / "ckpt")


# ---------------------------------------------------------------------------
# invariant audit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_audit_passes_on_live_stream(name, base_csr):
    g = T.REPRESENTATIONS[name].from_csr(base_csr, **CPU)
    for p in make_plans(3, seed=23):
        g, _ = g.apply(p)
    stats = faultinject.audit(g)
    assert stats["m"] == g.to_csr().m
    assert stats["blocks"] >= 1


def test_audit_detects_edge_count_drift(base_csr):
    g = T.REPRESENTATIONS["digraph"].from_csr(base_csr, **CPU)
    g.m += 1  # simulated accounting corruption
    with pytest.raises(faultinject.AuditError, match="rep.m"):
        faultinject.audit(g)


def test_audit_detects_image_geometry_corruption(base_csr):
    g = T.REPRESENTATIONS["vector2d"].from_csr(base_csr, **CPU)
    img = g.to_walk_image()
    img.degs[0] += 1  # degree drift: live-count / payload checks trip
    with pytest.raises(faultinject.AuditError):
        img.audit()
    with pytest.raises(faultinject.AuditError):
        faultinject.audit(g)


def _corrupt(pkg, kind):
    """A representation of ``pkg`` with one corruption of ``kind``: a
    DiGraph's edge count, or a SortedCOO's (private) walk image."""
    name = "digraph" if kind == "m_drift" else "coo"
    g = PKGS[pkg].reps[name].from_csr(_base(pkg), **PKGS[pkg].kw)
    img = g.to_walk_image()
    if kind == "m_drift":
        g.m += 1
    elif kind == "degs":
        img.degs[3] += 1
    elif kind == "wgt_flip":  # a live weight of row 0 flipped in the image
        i = int(img.starts[0])
        img.wgt = (img.wgt.at[i].set(-img.wgt[i] - 1.0) if pkg == "repro"
                   else img.wgt.clone().index_put_((torch.tensor([i]),), -img.wgt[i] - 1.0))
    elif kind == "slack":  # a ghost edge in a block's SENTINEL slack
        row = int(np.nonzero(img.caps > img.degs)[0][0])
        i = int(img.starts[row] + img.degs[row])
        img.dst = (img.dst.at[i].set(0) if pkg == "repro"
                   else img.dst.clone().index_put_((torch.tensor([i]),), torch.tensor(0, dtype=torch.int32)))
    return g


@pytest.mark.parametrize("kind", ["m_drift", "degs", "wgt_flip", "slack"])
def test_audit_raises_repros_message(kind):
    """The same corruption in both packages fails both audits with the
    same message."""
    with pytest.raises(j_fi.AuditError) as want:
        j_fi.audit(_corrupt("repro", kind))
    with pytest.raises(faultinject.AuditError) as got:
        faultinject.audit(_corrupt("port", kind))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the port against repro
# ---------------------------------------------------------------------------


def test_wal_segments_byte_identical_across_packages(tmp_path):
    """The same plans journaled by both packages (single appends with
    rotation, then a group commit) leave the same files, byte for byte."""
    files = {}
    for pkg in PKGS:
        p = PKGS[pkg]
        wal = str(tmp_path / pkg)
        j = p.durable.UpdateJournal(wal, segment_bytes=256)
        plans = make_plans(6, seed=29, pkg=pkg)
        for plan in plans[:3]:
            j.append(plan, N_V)
        j.append_group(plans[3:], [N_V, N_V + 1, N_V + 2])
        j.close()
        files[pkg] = {os.path.basename(s): pathlib.Path(s).read_bytes() for s in j.segments()}
    assert len(files["port"]) >= 2
    assert files["port"] == files["repro"]


def _state_arrays(pkg, seed):
    """A DiGraph state_tree of ``pkg`` plus the durable wrapper's meta keys."""
    g = twin(pkg, "digraph", make_plans(2, seed=seed, pkg=pkg))
    t = dict(g.state_tree())
    t.update({"__meta__/rep": np.array("digraph"), "__meta__/wal_seq": np.int64(2),
              "__meta__/nv_bound": np.int64(N_V)})
    return t


@pytest.mark.parametrize("writer,reader", [("repro", "port"), ("port", "repro")])
def test_checkpoints_restore_across_packages(writer, reader, tmp_path):
    """A full step, a hash-compared diff and a ranged diff written by one
    package restore in the other; both packages' manifests agree."""
    dirs = {}
    for pkg in (writer, reader):
        m = PKGS[pkg].ckpt
        cd = dirs[pkg] = str(tmp_path / pkg)
        a0 = _state_arrays(pkg, 31)
        m.save_arrays_sharded(cd, 0, {0: a0})
        a1 = _state_arrays(pkg, 37)
        m.save_arrays_diff(cd, 1, {0: a1})
        a2 = {k: np.array(v, copy=True) for k, v in a1.items()}
        a2["degrees"][4] += 1
        m.save_arrays_diff(cd, 2, {0: a2}, dirty={0: {"degrees": np.array([[4, 5]])}})
    for s in (0, 1, 2):
        man = {pkg: PKGS[pkg].ckpt._read_manifest(os.path.join(d, f"step_{s:010d}"))
               for pkg, d in dirs.items()}
        assert man[writer] == man[reader], s
        raw = {pkg: pathlib.Path(d, f"step_{s:010d}", "manifest.json").read_bytes()
               for pkg, d in dirs.items()}
        assert raw[writer] == raw[reader], s
        got, step = PKGS[reader].ckpt.restore_arrays_diff(dirs[writer], step=s)
        want, _ = PKGS[writer].ckpt.restore_arrays_diff(dirs[writer], step=s)
        assert step == s and got[0].keys() == want[0].keys()
        for k in want[0]:
            x, y = np.asarray(got[0][k]), np.asarray(want[0][k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_pytree_checkpoints_across_packages(tmp_path):
    """``save``/``restore`` of a nested tree: the port's key strings are
    repro's, and each package restores the other's step."""
    tree = {"enc": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                    "layers": [np.ones(2, np.int32), (np.float32(2.5), np.arange(3, dtype=np.int32))]},
            "step": np.int32(9), "empty": np.zeros((0, 2), np.float32)}
    assert [k for k, _ in tree_mod.paths(tree)] == list(
        j_ckpt._flatten_with_paths(tree)[0])
    ckpt.save(str(tmp_path / "port"), 3, tree)
    j_ckpt.save(str(tmp_path / "repro"), 3, tree)
    for pkg in PKGS:
        d = str(tmp_path / pkg)
        got, step = ckpt.restore(d, tree)
        jgot, jstep = j_ckpt.restore(d, tree)
        assert step == jstep == 3
        for (k, a), (_, b), (_, want) in zip(tree_mod.paths(got),
                                             tree_mod.paths(jgot),
                                             tree_mod.paths(tree)):
            assert a.dtype == torch.from_numpy(np.asarray(want)).dtype, k
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
            np.testing.assert_array_equal(a.numpy(), np.asarray(want), err_msg=k)


@pytest.mark.parametrize("writer,reader", [("repro", "port"), ("port", "repro")])
@pytest.mark.parametrize("point", CRASH_POINTS)
@pytest.mark.parametrize("name", NAMES)
def test_crash_recovers_across_packages(name, point, writer, reader, tmp_path):
    """``writer``'s durable stream (a diff checkpoint after plan 1, then a
    crash at ``point`` on plan 2) recovered by ``reader``: bit for bit
    against ``writer``'s uncrashed twin."""
    wal, ck, plans, upto = run_crash(writer, name, tmp_path, point, kcrash=2, n_plans=3,
                                     seed=41, ckpt_at=1, diff=True)
    r = PKGS[reader].durable.DurableGraph.recover(wal, ck, **PKGS[reader].kw)
    assert r.seq == upto
    assert_bit_parity(r.rep, twin(writer, name, plans[:upto]))
    r.close()
