"""The fleet fault-tolerance state machine in the port
(``repro_torch.runtime.fault``), on the CPU.

Every case of ``tests/test_runtime.py`` on the port under a simulated
clock: deadline-driven death, consecutive-strike stragglers, pow-2 elastic
re-meshing and the ElasticTrainer event stream.  Then both packages'
``ElasticTrainer`` driven by the same clock and step times: their
``events`` lists are equal, and the state each restores from a checkpoint
the other package wrote is the same bit for bit.
"""
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as j_ckpt
from repro.runtime import fault as j_fault
from repro_torch.checkpoint import manager as ckpt
from repro_torch.runtime import fault


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _monitor(n=4, **kw):
    clock = FakeClock()
    mon = fault.FleetMonitor(n, clock=clock, **kw)
    return mon, clock


# -- FleetMonitor -----------------------------------------------------------


def test_dead_by_deadline():
    mon, clock = _monitor(3, fail_timeout=60.0)
    clock.advance(30.0)
    mon.heartbeat(0, 1.0)
    mon.heartbeat(1, 1.0)  # worker 2 stays silent
    clock.advance(45.0)    # 2 is now 75s stale; 0/1 only 45s
    report = mon.check()
    assert report["dead"] == [2]
    assert report["healthy"] == 2
    assert mon.alive_workers() == [0, 1]
    # a dead worker stays dead — no resurrection on later checks
    clock.advance(1.0)
    assert mon.check()["dead"] == []
    assert mon.check()["healthy"] == 2


def test_straggler_needs_consecutive_strikes():
    mon, clock = _monitor(4, strike_limit=3, straggler_factor=2.0)
    slow, fast = 10.0, 1.0
    for _ in range(2):
        clock.advance(1.0)
        for w in range(4):
            mon.heartbeat(w, slow if w == 3 else fast)
        assert mon.check()["stragglers"] == []  # strikes 1, 2: not yet
    clock.advance(1.0)
    for w in range(4):
        mon.heartbeat(w, slow if w == 3 else fast)
    assert mon.check()["stragglers"] == [3]  # third consecutive strike


def test_fast_step_resets_strikes():
    mon, clock = _monitor(4, strike_limit=3, straggler_factor=2.0)
    for w in range(4):
        mon.heartbeat(w, 10.0 if w == 3 else 1.0)
    for _ in range(2):
        clock.advance(1.0)
        assert mon.check()["stragglers"] == []
    # one on-median step wipes the strike count...
    mon.heartbeat(3, 1.0)
    clock.advance(1.0)
    assert mon.check()["stragglers"] == []
    assert mon.workers[3].slow_strikes == 0
    # ...so the NEXT slow streak starts from zero again
    for _ in range(2):
        mon.heartbeat(3, 10.0)
        clock.advance(1.0)
        assert mon.check()["stragglers"] == []


def test_evict_removes_from_alive_set():
    mon, _ = _monitor(3)
    mon.evict(1)
    assert mon.alive_workers() == [0, 2]
    assert mon.check()["healthy"] == 2


# -- elastic re-mesh --------------------------------------------------------


@pytest.mark.parametrize(
    "n_devices,expect",
    [
        (64, (4, 16)),   # full fleet
        (48, (2, 16)),   # lost a quarter: data axis rounds DOWN to pow-2
        (33, (2, 16)),
        (16, (1, 16)),
        (8, (1, 16)),    # fewer devices than one TP group: floor at 1
    ],
)
def test_elastic_mesh_shape_pow2(n_devices, expect):
    assert fault.elastic_mesh_shape(n_devices, model_parallel=16) == expect
    assert j_fault.elastic_mesh_shape(n_devices, model_parallel=16) == expect


# -- ElasticTrainer orchestration -------------------------------------------


def _state():
    return {"w": np.arange(8, dtype=np.float32)}


def test_trainer_remesh_and_restore_on_death(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    state = _state()
    ckpt.save(ckpt_dir, 5, state)
    clock = FakeClock()
    mon = fault.FleetMonitor(64, fail_timeout=60.0, clock=clock)
    tr = fault.ElasticTrainer(monitor=mon, ckpt_dir=ckpt_dir, model_parallel=16)
    # 16 workers (one TP group) go silent past the deadline
    clock.advance(61.0)
    live_times = {w: 1.0 for w in range(16, 64)}
    restored, new_mesh = tr.on_step(7, state, live_times)
    assert new_mesh == (2, 16)  # 48 survivors -> pow-2 data axis 2
    kinds = [e["kind"] for e in tr.events]
    assert kinds == ["remesh", "restore"]
    assert tr.events[0]["dead"] == list(range(16))
    assert tr.events[1]["from_step"] == 5
    np.testing.assert_array_equal(np.asarray(restored["w"]), state["w"])


def test_trainer_evicts_stragglers_without_restore(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    ckpt.save(ckpt_dir, 1, _state())
    clock = FakeClock()
    mon = fault.FleetMonitor(8, strike_limit=2, clock=clock)
    tr = fault.ElasticTrainer(monitor=mon, ckpt_dir=ckpt_dir)
    state = _state()
    for step in range(2):
        clock.advance(1.0)
        out, mesh = tr.on_step(step, state, {w: (9.0 if w == 0 else 1.0) for w in range(8)})
        assert mesh is None  # stragglers never force a re-mesh/restore
    assert [e["kind"] for e in tr.events] == ["evict_stragglers"]
    assert tr.events[0]["workers"] == [0]
    assert 0 not in tr.monitor.alive_workers()


# -- both packages on the same fleet ----------------------------------------


def _fleet_trace(rng):
    """Per step: (clock advance, {worker: step time}) for 32 workers — a
    straggler from step 2, workers 8-15 silent from step 5 (dead at the
    deadline), the rest around 1 s."""
    steps = []
    for step in range(12):
        times = {w: float(1.0 + 0.05 * rng.random()) for w in range(32)}
        if step >= 2:
            times[3] = 7.5
        if step >= 5:
            for w in range(8, 16):
                times.pop(w)
        steps.append((float(2.0 + rng.random()), times))
    return steps


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_elastic_trainers_agree_across_packages(writer, tmp_path):
    """Both packages' ``ElasticTrainer`` on the same clock and step times emit
    equal ``events``; the restored state (from a checkpoint ``writer``
    wrote) is bit for bit the same, and equals what was saved."""
    ckpt_dir = str(tmp_path / "ckpt")
    rng = np.random.default_rng(5)
    state = {"w": rng.standard_normal((4, 8)).astype(np.float32),
             "step": np.asarray(4, np.int32)}  # int64 needs jax_enable_x64
    (j_ckpt if writer == "repro" else ckpt).save(ckpt_dir, 4, state)
    trace = _fleet_trace(np.random.default_rng(6))
    out = {}
    for name, mod in (("repro", j_fault), ("port", fault)):
        clock = FakeClock()
        mon = mod.FleetMonitor(32, fail_timeout=6.0, strike_limit=2, clock=clock)
        tr = mod.ElasticTrainer(monitor=mon, ckpt_dir=ckpt_dir, model_parallel=4)
        restored = []
        for step, (dt, times) in enumerate(trace):
            clock.advance(dt)
            new, shape = tr.on_step(step, state, times)
            if shape is not None:
                restored.append((step, shape, new))
        out[name] = (tr.events, restored, mon.alive_workers())
    assert out["port"][0] == out["repro"][0]
    kinds = [e["kind"] for e in out["port"][0]]
    assert "evict_stragglers" in kinds and kinds.count("remesh") == 1
    assert out["port"][2] == out["repro"][2]
    (jstep, jshape, jnew), = out["repro"][1]
    (pstep, pshape, pnew), = out["port"][1]
    assert (pstep, pshape) == (jstep, jshape)
    for k in state:
        p = pnew[k].numpy() if isinstance(pnew[k], torch.Tensor) else np.asarray(pnew[k])
        j = np.asarray(jnew[k])
        assert p.dtype == j.dtype == state[k].dtype and p.shape == j.shape == state[k].shape
        np.testing.assert_array_equal(p, j)
        np.testing.assert_array_equal(p, state[k])
