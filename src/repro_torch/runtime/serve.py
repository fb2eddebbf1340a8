"""Overload-safe multi-tenant walk serving front-end (DESIGN.md §16).

The port of ``repro.runtime.serve``: an async request queue in front of the
walk engine, turning concurrent per-user walk requests into single batched
``[B, V]`` walks, with ``repro``'s robustness contract:

* **Snapshot isolation** — one writer thread applies ``UpdatePlan``s to
  the live representation and *seals* a read-only ``WalkImage``
  generation after each group (``core.walk_image.seal_generation``).
  Torch tensors are mutable, so the port enforces what ``repro`` gets from
  immutable arrays: a sealed DiGraph snapshot makes the next in-place
  update copy the buffers it writes (per-buffer copy-on-write), and a
  sealed image arms ``_cow`` on the live image, whose next patch copies
  its payload first.  Readers always walk the last sealed generation and
  every response carries its ``generation`` id, so consistency is
  checkable against a per-generation oracle (``torn_reads == 0``).

* **Admission control + backpressure** — both queues are bounded.  A
  walk submitted past ``max_queue`` depth is rejected immediately with a
  ``Retry-After``-style hint (``RejectedError.retry_after``, estimated
  from the EMA per-request service time); a request whose deadline
  expired while it waited is shed before dispatch.

* **Bounded retry, no fallback chain** — ``repro`` dispatches through the
  ``kernels/fallback`` breaker chain (pallas → xla → ref).  The port has
  none: nothing sits between a CUDA tensor and its kernel.  A failed batch
  (an injected ``slot_walk.*`` or ``serve.dispatch`` fault, a CUDA error)
  is retried on the SAME backend with jittered backoff
  (``dispatch_retries``); after that its tickets fail visibly.  The
  ``breaker_fallbacks`` stat is kept so the stats dicts have ``repro``'s
  keys, and it is always 0.  The dispatch waits for the batch's device
  work inside its ``try``, so a CUDA error fails (or retries) that batch
  and never shows up as a later ticket's garbage; ``latency_s`` and the
  service-time EMA time finished work.

* **Fault-injected audits** — ``faultinject`` points at the three
  boundary transitions (``serve.enqueue``, ``serve.seal``,
  ``serve.dispatch``) prove the zero-lost contract: every submitted
  ticket resolves as served / rejected / failed (``assert_no_lost``),
  and a failed seal keeps readers on the previous consistent generation
  while the writer retries.

* **Shard failover (DESIGN.md §17)** — serving a ``ShardedGraph``, a
  single lost shard degrades coverage instead of availability.  A walk
  dispatch that trips ``ShardFaultError(sid)`` queues that shard for
  quarantine on the writer (``request_quarantine``) and retries the
  batch; the writer reseals a degraded generation, whose responses carry
  ``coverage`` (the fraction of the vertex space served) and
  ``down_shards``, so a degraded answer is explicit, never silent.  Paced
  ``failover.AuditScheduler`` ticks (``audit_every``) sweep one healthy
  shard a round, and ``run_on_writer`` serialises admin mutations
  (corruption, ``DurableGraph.rebuild_shard`` reintegration) with the
  apply stream.  On the single-device representations, which have no
  shards, this control plane stays inert.

* **A graph on a mesh: rank 0 serves, the other ranks follow** — ``repro``
  serves a mesh ``ShardedGraph`` from one process that drives every
  device.  The port's mesh is multi-controller (one process and one shard
  a rank, ``launch.mesh``), and every mesh-mode call is a collective every
  rank must enter in the same order, while only rank 0 sees requests.  So
  every rank builds a ``WalkServer`` over its view of the same graph (a
  ``ShardedGraph`` or sharded ``DurableGraph`` whose ``mesh`` is set) and
  calls ``start()``.  On rank 0 the server runs as above: its queues,
  admission, deadlines, retries, tickets and stats are unchanged, and the
  ``serve.*`` fault points fire there before anything reaches another
  rank.  On every other rank ``start()`` enters *follower mode*: one
  thread runs what rank 0 sends, ``submit_walk`` / ``submit_update`` /
  ``run_on_writer`` raise (naming rank 0), and ``stop()`` / ``join()``
  return once rank 0 stops.  Every step that touches the graph is an op
  — the walk batch, the apply of one update (with the ``m`` reads around
  it), the seal of generation ``g``, the quarantine of shards, the audit
  tick, an admin function, stop — which rank 0 runs under one lock: it
  broadcasts the op's header (``launch.mesh.Channel``: host data only,
  the plan's canonical op stream, the batch's validated seeds or rows,
  the generation id) and then runs the op, as every follower does when
  the header arrives.  Walks and applies therefore run one at a time on a
  mesh: the writer holds the lock once for a whole round (its
  quarantines, admin ops, applies and seal) and the dispatcher lets a
  waiting round in before its next batch, so a round waits for at most
  the batch in flight, and a batch that hit a shard fault is retried after
  the round that quarantines the shard, on the degraded generation.  Each
  op ends in an agreement, so an error on any rank (a shard
  fault, a failed seal, a CUDA error) is raised on every rank: rank 0
  retries or fails the ticket, a follower goes on to the next header.  A
  walk carries its generation id and a follower whose sealed generation
  has another id raises (the ranks are out of step).  Admin functions run
  on every rank, so on a mesh ``run_on_writer`` takes only a function
  that pickles by reference (module-level, or a ``functools.partial`` of
  one) and raises ``TypeError`` for a lambda.  An idle rank 0 sends a
  heartbeat header well inside the collective timeout, so a follower
  waits as long as rank 0 is alive; a dead follower makes rank 0's next
  op fail within the timeout, and its tickets fail visibly.  In local
  mode and on single-device representations nothing of this runs: each
  op is a direct call.

Where results live: a walk batch runs exactly its ``b`` live rows (no
padding: ``repro`` pads to a power of two only to keep its jit cache warm)
and ``WalkTicket.visits`` is that ticket's row of the batch output, on the
server's device.  ``result()`` returns that tensor; nothing is copied to
the host.

The server is representation-agnostic: anything exposing ``apply(plan)``
(returning ``(rep, dm)`` or mutating in place) plus ``to_walk_image()``
(all five single-device representations) or its own ``seal_generation``
(``ShardedGraph``, ``DurableGraph``) serves.  The dispatcher reads the
sealed generation's ``device`` (a ``WalkImage``'s payload device, or the
device every shard of a ``ShardedGraph`` lives on).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import pickle
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..core import updates, util, walk_image
from . import faultinject

#: Ticket terminal states.  "pending" is the only non-terminal one.
SERVED, REJECTED, FAILED, PENDING = "served", "rejected", "failed", "pending"


class RejectedError(RuntimeError):
    """A request the server declined cleanly (never started).

    ``reason`` is one of the admission reasons ("backpressure",
    "expired", "shutdown", "enqueue_fault", "seed_out_of_range",
    "shape_mismatch"); ``retry_after`` (seconds, backpressure only) is
    the Retry-After hint — the estimated time for the queue to drain
    below the watermark.
    """

    def __init__(self, reason: str, retry_after: Optional[float] = None):
        msg = f"request rejected: {reason}"
        if retry_after is not None:
            msg += f" (retry after {retry_after * 1e3:.1f}ms)"
        super().__init__(msg)
        self.reason = reason
        self.retry_after = retry_after


@dataclasses.dataclass
class Generation:
    """One sealed, read-only walk image (or sealed ``ShardedGraph``) plus
    its bookkeeping."""

    gen_id: int
    image: walk_image.WalkImage
    #: updates applied to the live rep when this generation sealed
    seq: int
    sealed_at: float


class _Ticket:
    """Base request handle: threading.Event + terminal outcome.

    ``resolved_at`` (``time.monotonic()``) stamps the resolution, so an
    update's ack latency is ``resolved_at - submitted_at``.
    """

    __slots__ = (
        "status", "reason", "retry_after", "error", "generation",
        "submitted_at", "resolved_at", "_done",
    )

    def __init__(self):
        self.status = PENDING
        self.reason: Optional[str] = None
        self.retry_after: Optional[float] = None
        self.error: Optional[BaseException] = None
        self.generation: Optional[int] = None
        self.submitted_at = time.monotonic()
        self.resolved_at: Optional[float] = None
        self._done = threading.Event()

    # -- resolution (server side) ---------------------------------------
    def _resolve(self, status: str) -> None:
        self.status = status
        self.resolved_at = time.monotonic()
        self._done.set()

    def _reject(self, reason: str, retry_after: Optional[float] = None):
        self.reason = reason
        self.retry_after = retry_after
        self._resolve(REJECTED)
        return self

    def _fail(self, err: BaseException):
        self.error = err
        self._resolve(FAILED)
        return self

    # -- caller side -----------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def _raise_terminal(self):
        if self.status == REJECTED:
            raise RejectedError(self.reason or "rejected", self.retry_after)
        if self.status == FAILED:
            raise RuntimeError("request failed") from self.error


class WalkTicket(_Ticket):
    """Handle for one walk request; ``result()`` blocks for the visits.

    ``visits`` is the ticket's [nv] float32 row of its batch's output, on
    the server's device.  ``coverage``/``down_shards`` describe the serving
    generation: 1.0 and ``()`` on any single-device image (§17).
    """

    __slots__ = ("seeds", "weights", "visits_row", "steps", "deadline",
                 "attempts", "visits", "latency_s", "coverage",
                 "down_shards")

    def __init__(self, seeds, weights, visits_row, steps, deadline):
        super().__init__()
        self.seeds = seeds
        self.weights = weights
        self.visits_row = visits_row
        self.steps = int(steps)
        self.deadline = deadline
        self.attempts = 0
        self.visits: Optional[torch.Tensor] = None
        self.latency_s: Optional[float] = None
        self.coverage: Optional[float] = None
        self.down_shards: tuple = ()

    def result(self, timeout: Optional[float] = None) -> torch.Tensor:
        if not self.wait(timeout):
            raise TimeoutError("walk ticket still pending")
        self._raise_terminal()
        return self.visits


class UpdateTicket(_Ticket):
    """Handle for one update; acked only once a sealed generation holds it.

    ``seq`` is the update's place in the writer's apply order (1, 2, ...),
    set when it is applied.
    """

    __slots__ = ("plan", "dm", "seq")

    def __init__(self, plan):
        super().__init__()
        self.plan = plan
        self.dm: Optional[int] = None
        self.seq: Optional[int] = None

    def result(self, timeout: Optional[float] = None) -> int:
        """Blocks until the update is visible to readers; returns ΔM."""
        if not self.wait(timeout):
            raise TimeoutError("update ticket still pending")
        self._raise_terminal()
        return self.dm


class AdminTicket(_Ticket):
    """Handle for one writer-thread admin op (``run_on_writer``).

    The callable runs on the writer thread — serialized with applies and
    seals, so it may safely mutate the live representation.  It is NOT
    part of the zero-lost walk/update ledgers; ``admin_ops`` counts it.
    """

    __slots__ = ("fn", "reseal", "value")

    def __init__(self, fn, reseal: bool):
        super().__init__()
        self.fn = fn
        self.reseal = bool(reseal)
        self.value = None

    def result(self, timeout: Optional[float] = None):
        if not self.wait(timeout):
            raise TimeoutError("admin ticket still pending")
        self._raise_terminal()
        return self.value


def _fresh_stats() -> dict:
    return {
        # walk-side accounting (the zero-lost ledger)
        "submitted": 0, "served": 0, "shed_expired": 0,
        "rejected_backpressure": 0, "rejected_other": 0, "failed": 0,
        # update side
        "updates_submitted": 0, "updates_applied": 0, "updates_failed": 0,
        "updates_rejected": 0,
        # engine health ("breaker_fallbacks" stays 0: no chain in the port)
        "seals": 0, "seal_failures": 0, "batches": 0, "max_batch": 0,
        "dispatch_retries": 0, "breaker_fallbacks": 0,
        # shard failover (§17)
        "shard_quarantines": 0, "audit_detections": 0,
        "served_degraded": 0, "admin_ops": 0,
    }


def _wait_device(out: torch.Tensor) -> None:
    """Wait for the work queued on the current stream up to ``out`` (an
    event, not a stream-wide synchronise): a CUDA error raises here."""
    if out.device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(out.device))
        ev.synchronize()


class WalkServer:
    """Batched, snapshot-isolated, overload-safe walk service (§16).

    One writer thread owns the live representation; one dispatcher
    thread drains the walk queue into coalesced ``[B, V]`` batched
    walks against the last sealed generation.  Both threads launch on
    their (default) current stream, so their device work stays in launch
    order.  All tuning knobs are constructor arguments so tests can drive
    every regime:

    ``max_queue``        walk admission bound (backpressure watermark)
    ``batch_max``        max requests coalesced into one dispatch
    ``default_timeout``  per-request deadline when the caller gives none
                         (None = no deadline)
    ``dispatch_retries`` retries of a failed batch, on the same backend
    ``retry_backoff``    base seconds of the retry backoff (attempt 1)
    ``retry_max_backoff`` ceiling of the exponential retry backoff
    ``update_queue_max`` update admission bound
    ``seal_group_max``   updates coalesced under one seal
    ``walk_backend``     walk backend: "auto" | "cuda" | "torch", resolved
                         on the sealed image's device (``util.resolve_backend``)
    ``audit_every``      writer rounds between AuditScheduler ticks
                         (0 = no background integrity audits)

    A ``rep`` on a mesh (its ``mesh`` set) is served by rank 0 and followed
    by the other ranks (the module docstring): every rank constructs its
    server with the same arguments and starts it.
    """

    def __init__(
        self,
        rep,
        *,
        max_queue: int = 256,
        batch_max: int = 32,
        default_timeout: Optional[float] = None,
        dispatch_retries: int = 2,
        retry_backoff: float = 0.002,
        retry_max_backoff: float = 0.25,
        update_queue_max: int = 64,
        seal_group_max: int = 8,
        walk_backend: str = "auto",
        audit_every: int = 0,
    ):
        self._rep = rep
        self.max_queue = int(max_queue)
        self.batch_max = int(batch_max)
        self.default_timeout = default_timeout
        self.dispatch_retries = int(dispatch_retries)
        self.retry_backoff = float(retry_backoff)
        self.retry_max_backoff = float(retry_max_backoff)
        self.update_queue_max = int(update_queue_max)
        self.seal_group_max = int(seal_group_max)
        self.walk_backend = walk_backend
        self.audit_every = int(audit_every)

        self._lock = threading.Lock()
        self._walk_cv = threading.Condition(self._lock)
        self._upd_cv = threading.Condition(self._lock)
        self._walk_q: collections.deque = collections.deque()
        self._upd_q: collections.deque = collections.deque()
        self._stats = _fresh_stats()
        self._ema_service_s = 1e-3  # per-request EMA, seeded optimistically
        self._generation: Optional[Generation] = None
        self._gen_counter = 0
        self._seq = 0  # updates applied to the live rep
        self._seal_pending: list = []  # applied updates awaiting a seal ack
        self._closed = False
        self._threads: list[threading.Thread] = []
        self._backend: Optional[str] = None  # walk_backend, resolved at start
        # §17 failover control plane (writer-owned except the queues)
        self._admin_q: collections.deque = collections.deque()
        self._pending_quarantine: set = set()
        self._auditor = None  # lazy failover.AuditScheduler
        self._known_down: set = set()
        self._rng = np.random.default_rng(0x5EED)  # retry jitter only
        # a graph on a mesh: the op channel and the lock that orders its ops
        # (taken before ``_lock`` wherever both are held)
        self._mesh = getattr(rep, "mesh", None)
        self._chan = None
        self._op_lock = contextlib.nullcontext()
        if self._mesh is not None:
            from ..launch.mesh import Channel

            self._chan = Channel(self._mesh)
            self._op_lock = threading.RLock()
        self._chan_closed = False
        # a mesh's writer takes the op lock once a round; the dispatcher
        # lets a waiting round in before its next batch, and a batch retried
        # after a shard fault waits for the round that quarantines it
        self._round_cv = threading.Condition(self._lock)
        self._writer_waiting = False
        self._writer_done = False
        self._rounds = 0
        self._beat_stop = threading.Event()
        self._beat_thread: Optional[threading.Thread] = None
        self._follow_error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "WalkServer":
        """Seal generation 0 and start the writer + dispatcher threads.

        Raises when generation 0 cannot be sealed or ``walk_backend`` does
        not fit its device, before any thread starts.  On a mesh, rank 0
        also starts the heartbeat, and every other rank starts its follower
        thread instead (it seals generation 0 when rank 0 does).
        """
        if self._threads:
            raise RuntimeError("server already started")
        if self._follower():
            self._threads.append(self._spawn("serve-follow", self._follow_loop))
            return self
        self._known_down = set(getattr(self._base_rep(), "down", ()) or ())
        try:
            if not self._seal_locked(initial=True):
                raise RuntimeError("WalkServer.start: generation 0 failed to seal")
            self._backend = util.resolve_backend(
                self.walk_backend, self._generation.image.device)
        except Exception:
            if self._chan is not None:
                self._send_stop()
            raise
        self._closed = False
        for name, fn in (("serve-writer", self._writer_loop),
                         ("serve-dispatch", self._dispatch_loop)):
            self._threads.append(self._spawn(name, fn))
        if self._chan is not None:
            self._beat_thread = self._spawn("serve-heartbeat", self._beat_loop)
        return self

    def _spawn(self, name: str, fn) -> threading.Thread:
        """Start a daemon thread running ``fn`` (on a mesh rank's card: the
        current device is per thread)."""
        dev = None if self._mesh is None else self._mesh.device

        def run():
            if dev is not None and dev.type == "cuda":
                torch.cuda.set_device(dev)
            fn()

        t = threading.Thread(target=run, name=name, daemon=True)
        t.start()
        return t

    def _follower(self) -> bool:
        """Whether this server follows rank 0 (a mesh rank other than 0)."""
        return self._chan is not None and not self._chan.leader

    def _refuse_on_follower(self, what: str) -> None:
        if self._follower():
            raise RuntimeError(
                f"WalkServer.{what}: rank {self._mesh.rank} follows rank 0 on this mesh; "
                f"submit to rank 0's server")

    def stop(self, *, drain: bool = True, timeout: float = 30.0) -> dict:
        """Stop accepting requests; drain (or reject) the queues; join.

        With ``drain=True`` both threads finish everything already
        admitted before exiting — in-flight requests are never dropped.
        Returns the final stats dict.  On a mesh, rank 0 then sends stop to
        the other ranks; a follower's ``stop()`` waits for that (``join()``).
        """
        if self._follower():
            self.join()
            return self.stats()
        with self._lock:
            self._closed = True
            if not drain:
                while self._walk_q:
                    self._resolve_reject(
                        self._walk_q.popleft(), "shutdown", walk=True
                    )
                while self._upd_q:
                    self._resolve_reject(
                        self._upd_q.popleft(), "shutdown", walk=False
                    )
                while self._admin_q:
                    self._admin_q.popleft()._reject("shutdown")
            self._walk_cv.notify_all()
            self._upd_cv.notify_all()
        for t in self._threads:
            t.join(timeout)
        self._threads.clear()
        if self._chan is not None:
            self._send_stop()
        return self.stats()

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the server's threads to end.  A follower's thread ends
        when rank 0 stops; the error that ended it instead (a collective
        that failed or timed out) is raised here."""
        for t in list(self._threads):
            t.join(timeout)
            if not t.is_alive():
                self._threads.remove(t)
        if self._follow_error is not None:
            raise RuntimeError(
                f"WalkServer: rank {self._mesh.rank} stopped following rank 0"
            ) from self._follow_error

    def __enter__(self) -> "WalkServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["queue_depth"] = len(self._walk_q)
            out["update_depth"] = len(self._upd_q)
            out["generation"] = (
                self._generation.gen_id if self._generation else -1
            )
            out["ema_service_ms"] = self._ema_service_s * 1e3
            gen = self._generation
            out["coverage"] = (
                float(getattr(gen.image, "coverage", 1.0)) if gen else 1.0
            )
            out["down_shards"] = tuple(
                sorted(getattr(gen.image, "down", ()) or ())
            ) if gen else ()
        return out

    @property
    def generation(self) -> Optional[Generation]:
        return self._generation

    @property
    def rep(self):
        """The live representation (read it on the writer: ``run_on_writer``)."""
        return self._rep

    def op_counts(self) -> dict:
        """On a mesh, the op headers this rank sent (rank 0) or received, by
        op name; ``{}`` in local mode."""
        return {} if self._chan is None else dict(self._chan.counts)

    def assert_no_lost(self) -> dict:
        """The zero-lost ledger: submitted == served+shed+rejected+failed.

        Call after ``stop()``; raises AssertionError when any admitted
        request neither resolved nor remains queued (i.e. was silently
        lost).  Returns the stats dict for convenience.
        """
        s = self.stats()
        resolved = (
            s["served"] + s["shed_expired"] + s["rejected_backpressure"]
            + s["rejected_other"] + s["failed"]
        )
        if not (resolved == s["submitted"] and s["queue_depth"] == 0):
            raise AssertionError(
                f"lost walk requests: submitted={s['submitted']} "
                f"resolved={resolved} queued={s['queue_depth']}"
            )
        u_resolved = (
            s["updates_applied"] + s["updates_failed"] + s["updates_rejected"]
        )
        if not (u_resolved == s["updates_submitted"] and s["update_depth"] == 0):
            raise AssertionError(
                f"lost updates: submitted={s['updates_submitted']} "
                f"resolved={u_resolved} queued={s['update_depth']}"
            )
        return s

    # ------------------------------------------------------------------
    # admission (caller threads)
    # ------------------------------------------------------------------
    def _resolve_reject(self, ticket, reason, *, walk: bool,
                        retry_after=None):
        """Reject + account under self._lock (callers hold it)."""
        key = (
            "rejected_backpressure" if reason == "backpressure"
            else "shed_expired" if reason == "expired"
            else "rejected_other"
        )
        if walk:
            self._stats[key] += 1
        else:
            self._stats["updates_rejected"] += 1
        return ticket._reject(reason, retry_after)

    def submit_walk(
        self,
        seeds=None,
        *,
        weights=None,
        visits0=None,
        steps: int = 4,
        timeout: Optional[float] = None,
    ) -> WalkTicket:
        """Admit one walk request; returns a ticket (maybe pre-rejected).

        ``seeds`` (vertex ids, optionally with per-seed ``weights``) or a
        full ``visits0`` row [nv] define the initial visit vector; the
        dispatcher materializes it on the serving generation's device,
        against its vertex count.  ``timeout`` seconds (default: the
        server's ``default_timeout``) bound end-to-end latency — an expired
        request is shed, never walked.  Rejections resolve the ticket
        immediately with ``reason`` and, for backpressure, a
        ``retry_after`` hint; they are never raised here (``result()``
        raises :class:`RejectedError` for the caller that wants one).
        """
        self._refuse_on_follower("submit_walk")
        timeout = self.default_timeout if timeout is None else timeout
        now = time.monotonic()
        deadline = None if timeout is None else now + float(timeout)
        t = WalkTicket(seeds, weights, visits0, steps, deadline)
        with self._lock:
            self._stats["submitted"] += 1
            try:
                faultinject.fire("serve.enqueue")
            except Exception as e:  # injected enqueue fault: clean reject
                t.error = e
                return self._resolve_reject(t, "enqueue_fault", walk=True)
            if self._closed:
                return self._resolve_reject(t, "shutdown", walk=True)
            depth = len(self._walk_q)
            if depth >= self.max_queue:
                retry_after = (depth - self.max_queue + 1) * self._ema_service_s
                return self._resolve_reject(
                    t, "backpressure", walk=True, retry_after=retry_after
                )
            if deadline is not None and deadline <= now:
                return self._resolve_reject(t, "expired", walk=True)
            self._walk_q.append(t)
            self._walk_cv.notify()
        return t

    def submit_update(
        self,
        plan: Optional[updates.UpdatePlan] = None,
        *,
        inserts=None,
        deletes=None,
    ) -> UpdateTicket:
        """Admit one update; the ticket acks when a sealed generation
        contains it (readers can see it) — never earlier."""
        self._refuse_on_follower("submit_update")
        if plan is None:
            plan = updates.plan_update(inserts=inserts, deletes=deletes)
        t = UpdateTicket(plan)
        with self._lock:
            self._stats["updates_submitted"] += 1
            try:
                faultinject.fire("serve.enqueue")
            except Exception as e:
                t.error = e
                return self._resolve_reject(t, "enqueue_fault", walk=False)
            if self._closed:
                return self._resolve_reject(t, "shutdown", walk=False)
            if len(self._upd_q) >= self.update_queue_max:
                retry_after = len(self._upd_q) * self._ema_service_s
                return self._resolve_reject(
                    t, "backpressure", walk=False, retry_after=retry_after
                )
            self._upd_q.append(t)
            self._upd_cv.notify()
        return t

    def run_on_writer(self, fn, *, reseal: bool = False) -> AdminTicket:
        """Run ``fn(server)`` on the writer thread; returns an AdminTicket.

        The callable executes serialized with plan applies and seals —
        the only safe place to mutate the live representation from
        outside.  With ``reseal=True`` the writer seals a fresh generation
        right after, so readers observe the admin change on their next
        dispatch; leave it False for mutations that must NOT reach
        readers until an audit passes.

        On a mesh ``fn`` runs on every rank (on each rank's server), so it
        must pickle by reference — a module-level function or a
        ``functools.partial`` of one; anything else raises ``TypeError``
        here.  Its outcome is agreed: if it raises on any rank, the ticket
        fails on rank 0 with that error.
        """
        if self._chan is not None:
            self._refuse_on_follower("run_on_writer")
            try:
                pickle.dumps(fn)
            except Exception as e:
                raise TypeError(
                    "WalkServer.run_on_writer: on a mesh every rank runs fn, so it must "
                    "pickle by reference (a module-level function or a functools.partial "
                    f"of one), not {fn!r}") from e
        t = AdminTicket(fn, reseal)
        with self._lock:
            if self._closed:
                return t._reject("shutdown")
            self._admin_q.append(t)
            self._upd_cv.notify()
        return t

    def request_quarantine(self, sid: int) -> None:
        """Ask the writer to quarantine shard ``sid`` (idempotent)."""
        self._refuse_on_follower("request_quarantine")
        with self._lock:
            self._pending_quarantine.add(int(sid))
            self._upd_cv.notify()

    # ------------------------------------------------------------------
    # writer thread: control → apply → audit → seal → ack
    # ------------------------------------------------------------------
    def _base_rep(self):
        """The shard-bearing representation (unwraps DurableGraph.rep)."""
        return getattr(self._rep, "rep", self._rep)

    def _note_quarantines(self) -> bool:
        """Sync ``_known_down`` with the live rep; count new quarantines.

        Returns True when the down-set changed (quarantine OR
        reintegration) — either way the serving generation is stale and
        the writer must reseal.
        """
        down = set(getattr(self._base_rep(), "down", ()) or ())
        if down == self._known_down:
            return False
        new = down - self._known_down
        self._known_down = down
        if new:
            with self._lock:
                self._stats["shard_quarantines"] += len(new)
        return True

    def _drain_control(self) -> bool:
        """Apply queued quarantine requests + admin ops (writer thread).

        Returns True when the serving generation must be resealed.
        """
        with self._lock:
            sids = sorted(self._pending_quarantine)
            self._pending_quarantine.clear()
            admin = list(self._admin_q)
            self._admin_q.clear()
        dirty = False
        if sids:
            self._graph_op("quarantine", sids=sids)
            dirty |= self._note_quarantines()
        for t in admin:
            try:
                t.value = self._graph_op("admin", fn=t.fn)
            except Exception as e:
                t._fail(e)
            else:
                with self._lock:
                    self._stats["admin_ops"] += 1
                t._resolve(SERVED)
                dirty |= t.reseal
            dirty |= self._note_quarantines()
        return dirty

    def _audit_tick(self) -> bool:
        """One paced AuditScheduler tick; quarantines on detection.

        Returns True when a shard was quarantined (reseal needed).
        """
        if not hasattr(self._base_rep(), "audit_shard"):
            return False
        if self._graph_op("audit") is None:
            return False
        with self._lock:
            self._stats["audit_detections"] += 1
        self._note_quarantines()
        return True

    def _seal_locked(self, *, initial: bool = False) -> bool:
        """Seal a new generation and ack the updates it contains.

        On failure (an injected seal fault, a failed image flush) readers
        keep the previous generation — still consistent — the
        applied-but-unsealed updates stay queued for ack, and the writer
        retries on its next tick.
        """
        gen_id = self._gen_counter + (0 if initial else 1)
        try:
            faultinject.fire("serve.seal")
            self._graph_op("seal", gen_id=gen_id)
        except Exception:
            self._stats["seal_failures"] += 1
            return False
        self._stats["seals"] += 1
        for t in self._seal_pending:
            t.generation = gen_id
            t._resolve(SERVED)
        self._seal_pending.clear()
        return True

    def _writer_loop(self) -> None:
        audit_round = 0
        try:
            while True:
                with self._lock:
                    while not self._closed and not self._writer_has_work():
                        self._upd_cv.wait(0.05)
                        if self.audit_every:
                            break  # idle tick: keep the audit sweep moving
                    if self._closed and not self._writer_has_work():
                        return
                with self._writer_round():
                    audit_round = self._round(audit_round)
                if self._seal_pending:
                    # failed seal: retry after a short pause so an
                    # injected multi-shot fault can't spin the CPU
                    time.sleep(self.retry_backoff)
        finally:
            with self._lock:
                self._writer_done = True
                self._round_cv.notify_all()

    def _writer_has_work(self) -> bool:
        """Whether updates, acks, admin work or quarantines wait for the
        writer (callers hold ``_lock``)."""
        return bool(self._upd_q or self._seal_pending or self._admin_q
                    or self._pending_quarantine)

    def _round(self, audit_round: int) -> int:
        """One writer round: the queued quarantines and admin ops, a group
        of applies, a paced audit tick, then a seal.  -> the audit round."""
        with self._lock:
            group = [
                self._upd_q.popleft()
                for _ in range(min(len(self._upd_q), self.seal_group_max))
            ]
        dirty = self._drain_control()
        for t in group:
            try:
                t.dm = self._graph_op("apply", plan=self._header_plan(t.plan))
                self._seq += 1
                t.seq = self._seq
                with self._lock:
                    self._stats["updates_applied"] += 1
                    self._seal_pending.append(t)
            except Exception as e:
                # the plan did not take effect (validation, an injected
                # slot_update fault, a device error); the ticket fails
                # VISIBLY and the stream continues.
                with self._lock:
                    self._stats["updates_failed"] += 1
                t._fail(e)
        dirty |= self._note_quarantines()
        audit_round += 1
        if self.audit_every and audit_round >= self.audit_every:
            audit_round = 0
            dirty |= self._audit_tick()
        if group or self._seal_pending or dirty:
            with self._lock:
                self._seal_locked()
        return audit_round

    @contextlib.contextmanager
    def _writer_round(self):
        """A writer round's hold of the graph: on a mesh, ONE hold of the op
        lock for all its ops, so a round waits for at most the batch in
        flight (the dispatcher lets a waiting round in before its next
        batch); a direct call in local mode."""
        if self._chan is None:
            yield
            return
        with self._lock:
            self._writer_waiting = True
        with self._op_lock:
            with self._lock:
                self._writer_waiting = False
                self._round_cv.notify_all()
            try:
                yield
            finally:
                with self._lock:
                    self._rounds += 1
                    self._round_cv.notify_all()

    # ------------------------------------------------------------------
    # dispatcher thread: coalesce → shed → walk → fulfil
    # ------------------------------------------------------------------
    def _take_batch(self) -> Optional[list]:
        """Pop up to batch_max same-steps requests (head-of-line steps)."""
        with self._lock:
            while not self._walk_q:
                if self._closed:
                    return None
                self._walk_cv.wait(0.05)
            head = self._walk_q.popleft()
            batch = [head]
            kept = collections.deque()
            while self._walk_q and len(batch) < self.batch_max:
                t = self._walk_q.popleft()
                if t.steps == head.steps:
                    batch.append(t)
                else:
                    kept.append(t)
            kept.extend(self._walk_q)
            self._walk_q = kept
        return batch

    def _visits_row(self, t: WalkTicket, nv: int):
        """Validate the request's initial visit vector, or reject.

        Reads shapes and host seeds only (no device work, which could
        raise outside the dispatch's ``try``).  Returns ``(None, row)`` for
        a full row of ``nv`` values, ``(seeds, weights)`` for a seed list
        (``_initial_visits`` puts both on the device), or None when the
        ticket was rejected.
        """
        if t.visits_row is not None:
            row = torch.as_tensor(t.visits_row)
            if row.numel() != nv:
                with self._lock:
                    self._resolve_reject(t, "shape_mismatch", walk=True)
                return None
            # on a mesh the row crosses to the other ranks as host data
            return None, (row if self._chan is None else util.host(row))
        seeds = np.atleast_1d(np.asarray(t.seeds, np.int64))
        if seeds.size == 0 or seeds.min() < 0 or seeds.max() >= nv:
            with self._lock:
                self._resolve_reject(t, "seed_out_of_range", walk=True)
            return None
        w = (
            np.ones(seeds.shape[0], np.float32)
            if t.weights is None
            else np.asarray(t.weights, np.float32).reshape(-1)
        )
        if w.shape[0] != seeds.shape[0]:
            with self._lock:
                self._resolve_reject(t, "shape_mismatch", walk=True)
            return None
        return seeds, w

    @staticmethod
    def _initial_visits(specs: list, nv: int, device) -> torch.Tensor:
        """The batch's [b, nv] initial visits on ``device``: full rows
        copied, every seed list added in one accumulating scatter (as
        ``np.add.at`` adds repeated seeds)."""
        v0 = torch.zeros((len(specs), nv), dtype=torch.float32, device=device)
        idx, vals = [], []
        for i, (seeds, w) in enumerate(specs):
            if seeds is None:
                v0[i] = torch.as_tensor(w).reshape(-1).to(device, torch.float32)
            else:
                idx.append(seeds + i * nv)
                vals.append(w)
        if idx:
            v0.view(-1).index_put_(
                (torch.from_numpy(np.concatenate(idx)).to(device),),
                torch.from_numpy(np.concatenate(vals)).to(device),
                accumulate=True,
            )
        return v0

    def _dispatch_loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            self._await_writer(lambda: not self._writer_waiting)
            with self._op_lock:
                failed = self._dispatch(batch)
            if failed is not None:
                self._retry_or_fail(*failed)

    def _await_writer(self, done) -> None:
        """Wait until ``done()`` (read under ``_lock``) or the writer has
        ended; on a mesh only, where the writer's rounds and the batches
        take turns on the op lock."""
        if self._chan is None:
            return
        with self._lock:
            while not done() and not self._writer_done:
                self._round_cv.wait(0.05)

    def _dispatch(self, batch: list):
        """Shed, validate and walk one batch; resolves its served tickets.

        Returns None, or ``(tickets, error, round)`` for a failed walk, which
        the caller retries or fails (outside the op lock: the retry sleeps);
        ``round`` is, for a shard fault on a mesh, the writer rounds done
        when its quarantine was requested (the retry waits for the next).
        """
        now = time.monotonic()
        live: list[WalkTicket] = []
        for t in batch:
            if t.deadline is not None and t.deadline <= now:
                with self._lock:
                    self._resolve_reject(t, "expired", walk=True)
            else:
                live.append(t)
        if not live:
            return None
        gen = self._generation
        nv = int(gen.image.nv)
        specs, tickets = [], []
        for t in live:
            spec = self._visits_row(t, nv)
            if spec is not None:
                specs.append(spec)
                tickets.append(t)
        if not tickets:
            return None
        b = len(tickets)
        t0 = time.monotonic()
        try:
            faultinject.fire("serve.dispatch")
            out = self._graph_op(
                "walk", gen=gen if self._chan is None else gen.gen_id,
                steps=int(tickets[0].steps), backend=self._backend, specs=specs,
            )
        except Exception as e:
            # a shard-attributed walk fault (§17): ask the writer to
            # quarantine that shard, then retry the batch.
            sid = getattr(e, "sid", None)
            if sid is None:
                return tickets, e, None
            self.request_quarantine(int(sid))
            return tickets, e, self._rounds
        dt = time.monotonic() - t0
        cov = float(getattr(gen.image, "coverage", 1.0))
        downs = tuple(sorted(getattr(gen.image, "down", ()) or ()))
        with self._lock:
            self._stats["batches"] += 1
            self._stats["max_batch"] = max(self._stats["max_batch"], b)
            self._stats["served"] += b
            if cov < 1.0:
                self._stats["served_degraded"] += b
            self._ema_service_s += 0.2 * (dt / b - self._ema_service_s)
        done = time.monotonic()
        for i, t in enumerate(tickets):
            t.visits = out[i]
            t.generation = gen.gen_id
            t.coverage = cov
            t.down_shards = downs
            t.latency_s = done - t.submitted_at
            t._resolve(SERVED)
        return None

    def _retry_sleep_s(self, attempt: int) -> float:
        """Jittered exponential backoff: base·2^(attempt-1), capped, with
        uniform ±50% jitter so retry storms decorrelate."""
        base = min(
            self.retry_backoff * (2.0 ** max(int(attempt) - 1, 0)),
            self.retry_max_backoff,
        )
        return base * float(self._rng.uniform(0.5, 1.5))

    def _retry_or_fail(self, tickets: list, err: Exception,
                       after_round: Optional[int] = None) -> None:
        """Bounded retry with backoff; exhausted tickets fail visibly.  On a
        mesh a retry after a shard fault also waits for the writer round
        after ``after_round`` (it quarantines the shard and reseals), so
        the retry walks the degraded generation."""
        retry, dead = [], []
        for t in tickets:
            t.attempts += 1
            (retry if t.attempts <= self.dispatch_retries else dead).append(t)
        with self._lock:
            if retry:
                self._stats["dispatch_retries"] += 1
                self._walk_q.extendleft(reversed(retry))
                self._walk_cv.notify()
            for t in dead:
                self._stats["failed"] += 1
                t._fail(err)
        if retry:
            time.sleep(self._retry_sleep_s(max(t.attempts for t in retry)))
            if after_round is not None:
                self._await_writer(lambda: self._rounds > after_round)

    # ------------------------------------------------------------------
    # graph ops: every step that reaches the graph (on a mesh, one header
    # from rank 0, the same body on every rank)
    # ------------------------------------------------------------------
    def _graph_op(self, op: str, **kw):
        """Run op ``op``: ``_op_<op>(**kw)`` directly in local mode; on a
        mesh, under the op lock, its header broadcast first so every rank
        runs the same op in the same order.  ``kw`` is host data there."""
        if self._chan is None:
            return getattr(self, "_op_" + op)(**kw)
        with self._op_lock:
            if self._chan_closed:
                raise RuntimeError("WalkServer: the mesh's op channel is stopped")
            self._chan.send((op, kw))
            return getattr(self, "_op_" + op)(**kw)

    def _agreed(self, fn, *args):
        """``fn(*args)``; on a mesh with its outcome agreed (every rank
        raises the lowest failing rank's error)."""
        if self._chan is None:
            return fn(*args)
        return self._chan.agree(lambda: fn(*args))

    def _header_plan(self, plan):
        """The plan as an op carries it: itself, or on a mesh its
        canonical op stream."""
        if self._chan is None:
            return plan
        return (plan.q_src, plan.q_dst, plan.q_wgt, plan.q_del)

    def _op_walk(self, gen, steps: int, backend: str, specs: list):
        """One batch: its operands built and agreed before the walk's first
        collective, then the walk, waited for on the device."""
        img, v0 = self._agreed(self._walk_operands, gen, specs)
        return self._agreed(self._walk_run, img, steps, backend, v0)

    def _walk_operands(self, gen, specs: list):
        if self._chan is not None:
            gen = self._sealed(gen)
        img = gen.image
        return img, self._initial_visits(specs, int(img.nv), img.device)

    def _sealed(self, gen_id: int) -> Generation:
        """This rank's sealed generation, which must be ``gen_id``."""
        gen = self._generation
        have = None if gen is None else gen.gen_id
        if have != gen_id:
            raise RuntimeError(
                f"WalkServer: rank {self._mesh.rank} holds sealed generation {have} where "
                f"rank 0 walks generation {gen_id}: the ranks are out of step")
        return gen

    @staticmethod
    def _walk_run(img, steps: int, backend: str, v0):
        out = img.walk(int(steps), backend=backend, visits0=v0)
        _wait_device(out)
        return out

    def _op_apply(self, plan) -> int:
        return self._agreed(self._apply, plan)

    def _apply(self, plan) -> int:
        """Apply one plan; -> its ΔM.  Rep protocol adapter: single-device
        reps return (rep, dm); an apply that mutates in place and returns
        None has its ΔM read off the live edge count (on a mesh, a
        collective)."""
        if isinstance(plan, tuple):  # an op header's canonical op stream
            plan = updates.plan_from_canonical(*plan)
        m0 = int(getattr(self._rep, "m", 0))
        out = self._rep.apply(plan)
        if out is None:
            dm = int(getattr(self._rep, "m", m0)) - m0
        else:
            self._rep, dm = out
        return int(dm)

    def _op_seal(self, gen_id: int):
        img = self._agreed(walk_image.seal_generation, self._rep, gen_id)
        self._gen_counter = gen_id
        self._generation = Generation(
            gen_id=gen_id, image=img, seq=self._seq, sealed_at=time.monotonic()
        )
        return img

    def _op_quarantine(self, sids: list) -> None:
        self._agreed(self._quarantine, sids)

    def _quarantine(self, sids: list) -> None:
        base = self._base_rep()
        for sid in sids:
            if hasattr(base, "quarantine") and sid not in getattr(base, "down", ()):
                base.quarantine(int(sid))

    def _op_audit(self) -> Optional[int]:
        return self._agreed(self._audit_step)

    def _audit_step(self) -> Optional[int]:
        """One AuditScheduler tick; -> the shard it quarantined, or None.
        On a mesh every rank's scheduler sweeps the same shards: each tick
        is an op, the down set is the same on every rank, and
        ``audit_shard`` hands the owner's outcome to every rank."""
        base = self._base_rep()
        if self._auditor is None or self._auditor.g is not base:
            from . import failover
            self._auditor = failover.AuditScheduler(base)
        hit = self._auditor.tick()
        if hit is None:
            return None
        base.quarantine(int(hit[0]))
        return int(hit[0])

    def _op_admin(self, fn):
        return self._agreed(fn, self)

    # ------------------------------------------------------------------
    # the mesh's followers and heartbeat
    # ------------------------------------------------------------------
    def _follow_loop(self) -> None:
        """A follower: run every op rank 0 sends, in order, until stop.  An
        op's agreed failure is rank 0's to handle; any other error (a
        collective that failed or timed out) ends the loop (``join``)."""
        chan = self._chan
        try:
            while True:
                op, kw = chan.recv()
                if op == "stop":
                    return
                if op == chan.BEAT[0]:
                    continue
                try:
                    getattr(self, "_op_" + op)(**kw)
                except Exception as e:
                    if e is not chan.last_error:
                        raise
        except BaseException as e:  # noqa: BLE001 - join() reports it too
            self._follow_error = e
            raise

    def _beat_loop(self) -> None:
        """Rank 0: send a heartbeat whenever the channel has been idle for
        ``beat_s`` (a quarter of the collective timeout)."""
        chan = self._chan
        while not self._beat_stop.wait(min(chan.beat_s / 4, 1.0)):
            if chan.idle_s() < chan.beat_s:
                continue
            with self._op_lock:
                if self._chan_closed:
                    return
                if chan.idle_s() >= chan.beat_s:
                    try:
                        chan.send(chan.BEAT)
                    except Exception:  # noqa: BLE001 - the next op fails visibly
                        return

    def _send_stop(self) -> None:
        """Rank 0: end the followers' loops and the heartbeat (once)."""
        try:
            with self._op_lock:
                if not self._chan_closed:
                    self._chan_closed = True
                    self._chan.send(("stop", {}))
        finally:
            self._beat_stop.set()
            if self._beat_thread is not None:
                self._beat_thread.join()
                self._beat_thread = None
