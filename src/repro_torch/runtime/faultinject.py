"""Deterministic fault injection + cross-layer invariant auditor (DESIGN.md §13).

The port of ``repro.runtime.faultinject``.  The durability layer
(``runtime/durable.py``) is only trustworthy if every failure mode it claims
to survive is actually exercised.  This module provides the injection
families the recovery protocol is tested against:

* **process kill** — ``fire("durable.pre_append" | "durable.post_append" |
  "durable.post_apply")`` raises :class:`SimulatedCrash` (a *BaseException*,
  so nothing in the pipeline accidentally swallows it) at the three
  WAL-ordering-critical points of ``DurableGraph.apply``;
* **torn / corrupted WAL segments** — :func:`tear_tail` and
  :func:`corrupt_byte` damage log files the way a crashed writer or bad
  sector would;
* **interrupted checkpoint** — ``fire("checkpoint.pre_rename")`` kills the
  writer between the tmp-dir write and the atomic rename, leaving the
  ``.tmp_ckpt_*`` debris a real crash leaves;
* **disk full** — ``fire("wal.write")`` fails a segment write.

Injection points are *armed* host-side (``arm``/``injected``) and fire
deterministically: ``after`` skips that many hits, ``times`` bounds how many
raise.  :class:`FaultSchedule` derives a seeded (round, point) schedule for
randomized sweeps.  ``fire()`` on an un-armed point is a dict lookup — the
production hot path pays nothing.

**Point-name registry.**  Every ``fire()`` site in the port, by layer
(default exception class in brackets; ``durable.*``/``checkpoint.*``
default to :class:`SimulatedCrash`, everything else to
:class:`InjectedKernelError`; ``arm(..., exc=...)`` overrides):

=========================  ==================================================
point                      fires
=========================  ==================================================
``slot_update.cuda``       ``fused_apply``, once before its one attempt on
``slot_update.torch``      that backend (operands untouched); the error
                           reaches the caller
``slot_walk.cuda``         ``slot_walk``, once before its one attempt on
``slot_walk.torch``        that backend; the error reaches the caller
``durable.pre_append``     DurableGraph.apply, before the WAL append [crash]
``durable.post_append``    after the WAL append, before the device apply
``durable.post_apply``     after the device apply, before the ack
``checkpoint.pre_rename``  between tmp-dir write and atomic rename [crash]
``wal.write``              UpdateJournal._write_flush, before the
                           segment write — surfaces as WalDiskFullError
                           with the segment truncated back intact
``serve.enqueue``          WalkServer admission, inside the queue lock —
                           the request must resolve as a clean rejection
``serve.seal``             writer thread, before sealing a generation —
                           readers must keep the previous sealed image
``serve.dispatch``         dispatcher, before a batched walk — the batch
                           must be retried or failed, never dropped
``shard.walk``             ShardedGraph.reverse_walk, once per healthy
                           shard — surfaces as ShardFaultError(sid) so
                           the serving layer quarantines that shard
``shard.patch``            ShardedGraph.apply, before one shard's fused
                           patch — the shard quarantines, its sub
                           spools, the REST of the shards still patch
``shard.corrupt``          after one shard's successful patch — silently
                           flips a live weight (no exception escapes);
                           only the §17 integrity pass can detect it
=========================  ==================================================

The kernel-site points carry the port's backend names (``cuda`` for the
hand-written kernel, ``torch`` for its plain version) where ``repro`` has
``pallas`` / ``xla`` / ``ref``, and no chain follows them: ``repro``'s
``kernels/fallback.py`` breaker chain is not ported, because nothing may sit
between a CUDA tensor and its kernel.  A fired point raises out of the op;
the only degradation left is ``WalkServer``'s bounded retry of a batch on
the same backend, after which the ticket fails visibly.

The points live in this module's own registry, apart from ``repro``'s: a
test of the port arms and disarms them here.

:func:`audit` is the post-recovery invariant pass: CSR well-formedness,
WalkImage block-geometry/content integrity (``WalkImage.audit``), and
CSR↔image cross-consistency, for any of the five representations, run as
reductions on the representation's device; a ``ShardedGraph`` runs its own
per-shard + cross-boundary audit.

No ``repro_torch.core`` imports at module level — the core imports this
module (``WalkImage.audit``); keeping it core-free breaks the cycle.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import numpy as np
import torch


class SimulatedCrash(BaseException):
    """Process-kill stand-in.  BaseException: only the test harness (or a
    deliberate ``except BaseException``) may catch it — ordinary
    ``except Exception`` recovery code must let it fly, exactly like a real
    SIGKILL."""

    def __init__(self, point: str):
        super().__init__(f"simulated crash at {point}")
        self.point = point

    def __reduce__(self):
        return type(self), (self.point,)


class InjectedKernelError(RuntimeError):
    """Stand-in for a kernel- or I/O-level failure at an injection point."""

    def __init__(self, point: str):
        super().__init__(f"injected kernel failure at {point}")
        self.point = point

    def __reduce__(self):
        return type(self), (self.point,)


class AuditError(RuntimeError):
    """An invariant audit found cross-layer inconsistency."""


# point -> {"after": int, "times": int, "seen": int, "fired": int, "exc": type}
_ARMED: dict = {}


def arm(point: str, *, after: int = 0, times: int = 1, exc=None) -> None:
    """Arm ``point``: the next ``fire(point)`` calls skip ``after`` hits,
    then raise ``exc(point)`` on the following ``times`` hits."""
    if exc is None:
        exc = SimulatedCrash if point.startswith(("durable.", "checkpoint.")) else InjectedKernelError
    _ARMED[point] = {"after": int(after), "times": int(times), "seen": 0, "fired": 0, "exc": exc}


def disarm(point: Optional[str] = None) -> None:
    """Disarm one point, or everything when ``point`` is None."""
    if point is None:
        _ARMED.clear()
    else:
        _ARMED.pop(point, None)


def fired(point: str) -> int:
    """How many times ``point`` has actually raised since it was armed."""
    st = _ARMED.get(point)
    return 0 if st is None else st["fired"]


def armed() -> tuple:
    """Names of all currently armed points (leak-guard introspection)."""
    return tuple(sorted(_ARMED))


def fire(point: str) -> None:
    """Hit an injection point.  No-op unless armed (production cost: one
    falsy-dict check)."""
    if not _ARMED:
        return
    st = _ARMED.get(point)
    if st is None:
        return
    st["seen"] += 1
    if st["seen"] <= st["after"] or st["fired"] >= st["times"]:
        return
    st["fired"] += 1
    raise st["exc"](point)


@contextlib.contextmanager
def injected(point: str, *, after: int = 0, times: int = 1, exc=None):
    """Scoped ``arm``; always disarms the point on exit."""
    arm(point, after=after, times=times, exc=exc)
    try:
        yield
    finally:
        disarm(point)


class FaultSchedule:
    """Seeded (round, point) schedule for randomized crash sweeps.

    ``plan(n_rounds)`` picks one injection point and the round it fires in,
    deterministically from the seed (the same draws as ``repro``'s), so
    every failure reproduces from its seed alone.
    """

    def __init__(self, seed: int, points: tuple):
        self.seed = int(seed)
        self.points = tuple(points)
        self._rng = np.random.default_rng(self.seed)

    def plan(self, n_rounds: int) -> tuple:
        """Returns (round_index, point) with round_index in [0, n_rounds)."""
        rnd = int(self._rng.integers(0, max(n_rounds, 1)))
        point = self.points[int(self._rng.integers(0, len(self.points)))]
        return rnd, point


# -- file damage helpers (WAL / checkpoint corruption) ----------------------


def tear_tail(path: str, nbytes: int) -> int:
    """Truncate the final ``nbytes`` of ``path`` (a torn write at the tail:
    the crash happened mid-record).  Returns the new size."""
    size = os.path.getsize(path)
    new = max(size - int(nbytes), 0)
    os.truncate(path, new)
    return new


def corrupt_byte(path: str, offset: int) -> None:
    """Flip one byte of ``path`` in place (bit rot / bad sector: the record
    is complete but its checksum no longer matches)."""
    with open(path, "r+b") as f:
        f.seek(int(offset))
        b = f.read(1)
        if not b:
            raise ValueError(f"offset {offset} beyond end of {path}")
        f.seek(int(offset))
        f.write(bytes([b[0] ^ 0xFF]))


# -- invariant auditor ------------------------------------------------------


def _check(cond, msg: str):
    if not cond:
        raise AuditError(msg)


def audit(rep) -> dict:
    """Cross-consistency audit of a live representation (post-recovery gate).

    Verifies, for any of the five representations, with reductions on the
    representation's device (a few scalar reads, no host copy of the edge
    arrays):

    1. the canonical CSR is well-formed — monotone offsets, per-row strictly
       ascending in-range destinations, finite weights, edge count agreeing
       with ``rep.m``;
    2. the representation's WalkImage passes its own geometry/content audit
       (:meth:`WalkImage.audit` — blocks inside the bump frontier, disjoint,
       live prefixes owned and sorted, SENTINEL slack);
    3. CSR ↔ image cross-consistency — the image's live payload, gathered in
       row order, is exactly the CSR's dst/wgt streams.

    Sharded graphs (anything exposing per-shard ``shards`` plus its own
    ``audit``, i.e. ``ShardedGraph`` — duck-typed so this module stays
    core-import-free) delegate to their own per-shard + cross-boundary
    audit pass (DESIGN.md §14), which is the §15 recovery gate.

    Raises :class:`AuditError` on the first violation (``repro``'s
    messages); returns summary stats.
    """
    if hasattr(rep, "shards") and hasattr(rep, "audit"):
        try:
            return rep.audit()
        except ValueError as e:
            raise AuditError(str(e)) from e
    c = rep.to_csr()
    off = c.offsets.to(torch.int64)
    dev = off.device
    nv, m = int(c.n), int(c.m)
    d = c.dst[:m]
    w = c.wgt[:m] if c.wgt is not None else torch.ones(m, dtype=torch.float32, device=dev)

    _check(off.shape[0] == nv + 1, f"csr offsets length {off.shape[0]} != n+1 ({nv + 1})")
    _check(int(off[0]) == 0, "csr offsets[0] != 0")
    deg = off[1:] - off[:-1]
    _check(bool((deg >= 0).all()), "csr offsets not monotone")
    _check(int(off[-1]) == m, f"csr offsets[-1] {int(off[-1])} != m {m}")
    _check(int(rep.m) == m, f"rep.m {int(rep.m)} != csr.m {m}")
    if m:
        _check(bool(((d >= 0) & (d < nv)).all()), "csr dst id out of [0, n)")
        _check(bool(torch.isfinite(w).all()), "non-finite csr weight")
        row_of = torch.repeat_interleave(
            torch.arange(nv, dtype=torch.int64, device=dev), deg, output_size=m)
        interior = row_of[1:] == row_of[:-1]
        _check(
            not bool((interior & (d[1:] <= d[:-1])).any()),
            "csr row not strictly ascending",
        )

    img = rep.to_walk_image()
    stats = img.audit()
    _check(int(img.nv) == nv, f"image nv {int(img.nv)} != csr n {nv}")
    _check(int(img.live) == m, f"image live {int(img.live)} != csr m {m}")
    if m:
        idev = img.dst.device
        starts = torch.from_numpy(np.asarray(img.starts[:nv], np.int64)).to(idev)
        degs = torch.from_numpy(np.asarray(img.degs[:nv], np.int64)).to(idev)
        _check(bool(torch.equal(degs, deg.to(idev))), "image degrees != csr degrees")
        first = torch.cumsum(degs, 0) - degs
        gidx = torch.repeat_interleave(starts - first, degs, output_size=m) + torch.arange(
            m, dtype=torch.int64, device=idev)
        _check(bool((img.dst[gidx] == d.to(idev)).all()), "image dst payload != csr dst")
        _check(bool((img.wgt[gidx] == w.to(idev)).all()), "image wgt payload != csr wgt")
    return {"n": nv, "m": m, **stats}
