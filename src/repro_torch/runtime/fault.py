"""Fault tolerance & elasticity runtime (DESIGN.md §5), the port of
``repro.runtime.fault``.

On a large fleet the control plane watches per-step heartbeats, declares
stragglers and failures by deadline, and restarts the job on the surviving
ranks from the last checkpoint.  All of that is host-side Python, the same
state machine as ``repro``'s: :class:`FleetMonitor` (deadline-driven
death, consecutive-strike stragglers), :func:`elastic_mesh_shape` (the
largest ``(data, model)`` shape the survivors fill, the data axis rounded
down to a power of two), :func:`restart_from_checkpoint` (the newest
durable state through ``checkpoint.manager.restore``) and
:class:`ElasticTrainer`, which turns step-time samples into ``remesh`` /
``restore`` / ``evict_stragglers`` events.  Given the same clock and step
times both packages emit the same events, and a checkpoint either wrote
restores in the other.  Nothing here depends on the device count; building
the new process groups for a shape is the caller's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from ..checkpoint import manager as ckpt


@dataclasses.dataclass
class WorkerState:
    last_heartbeat: float
    slow_strikes: int = 0
    alive: bool = True


class FleetMonitor:
    """Heartbeat/straggler tracking with deterministic deadlines.

    * a worker missing ``fail_timeout`` seconds of heartbeats is DEAD →
      triggers elastic restart on the survivors;
    * a worker whose step time exceeds ``straggler_factor`` × the fleet
      median on ``strike_limit`` consecutive steps is a STRAGGLER →
      scheduled for replacement (the mitigation real fleets use before
      paying a restart).
    """

    def __init__(
        self,
        n_workers: int,
        *,
        fail_timeout: float = 60.0,
        straggler_factor: float = 2.0,
        strike_limit: int = 3,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.clock = clock
        self.fail_timeout = fail_timeout
        self.straggler_factor = straggler_factor
        self.strike_limit = strike_limit
        now = clock()
        self.workers = {i: WorkerState(now) for i in range(n_workers)}
        self.step_times: dict[int, float] = {}

    def heartbeat(self, worker: int, step_time: Optional[float] = None) -> None:
        w = self.workers[worker]
        w.last_heartbeat = self.clock()
        if step_time is not None:
            self.step_times[worker] = step_time

    def check(self) -> dict:
        """Returns {dead: [...], stragglers: [...], healthy: n}."""
        now = self.clock()
        dead, stragglers = [], []
        times = list(self.step_times.values())
        median = float(np.median(times)) if times else 0.0
        for i, w in self.workers.items():
            if not w.alive:
                continue
            if now - w.last_heartbeat > self.fail_timeout:
                w.alive = False
                dead.append(i)
                continue
            t = self.step_times.get(i)
            if t is not None and median > 0 and t > self.straggler_factor * median:
                w.slow_strikes += 1
                if w.slow_strikes >= self.strike_limit:
                    stragglers.append(i)
            else:
                w.slow_strikes = 0
        healthy = sum(1 for w in self.workers.values() if w.alive)
        return {"dead": dead, "stragglers": stragglers, "healthy": healthy}

    def evict(self, worker: int) -> None:
        self.workers[worker].alive = False

    def alive_workers(self) -> list[int]:
        return [i for i, w in self.workers.items() if w.alive]


def elastic_mesh_shape(n_devices: int, *, model_parallel: int = 16):
    """Largest (data, model) mesh fitting the surviving device count.

    Keeps the model-parallel width fixed (a model-parallel group must stay
    whole — losing one member kills the group) and shrinks the data axis,
    rounded down to a power of two so repeated shrink/grow events reuse a
    logarithmic number of shapes.
    """
    data = max(n_devices // model_parallel, 1)
    data_pow2 = 1 << (data.bit_length() - 1)  # round DOWN to pow-2
    return (data_pow2, model_parallel)


def restart_from_checkpoint(ckpt_dir: str, like, *, step=None):
    """Restore the newest durable state (the recovery path after a failure)
    into the structure of ``like``: ``(tree, step)``."""
    return ckpt.restore(ckpt_dir, like, step=step)


@dataclasses.dataclass
class ElasticTrainer:
    """Orchestrates monitor + checkpoint + re-mesh decisions.

    ``on_step`` consumes one step's (worker -> step time) samples — from the
    coordinator's stream in production, from a simulator in tests.
    """

    monitor: FleetMonitor
    ckpt_dir: str
    model_parallel: int = 16
    events: list = dataclasses.field(default_factory=list)

    def on_step(self, step: int, state, step_times: dict[int, float]):
        for w, t in step_times.items():
            if self.monitor.workers[w].alive:
                self.monitor.heartbeat(w, t)
        report = self.monitor.check()
        if report["dead"]:
            # failure: re-mesh on survivors, restore from durable state
            new_shape = elastic_mesh_shape(
                len(self.monitor.alive_workers()), model_parallel=self.model_parallel
            )
            self.events.append(
                {"step": step, "kind": "remesh", "dead": report["dead"],
                 "new_mesh": new_shape}
            )
            restored, at = restart_from_checkpoint(self.ckpt_dir, state)
            self.events.append({"step": step, "kind": "restore", "from_step": at})
            return restored, new_shape
        if report["stragglers"]:
            for w in report["stragglers"]:
                self.monitor.evict(w)
            self.events.append(
                {"step": step, "kind": "evict_stragglers", "workers": report["stragglers"]}
            )
        return state, None
