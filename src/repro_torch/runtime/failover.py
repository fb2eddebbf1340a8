"""Shard-failover helpers: incremental audit scheduling + corruption
modeling (DESIGN.md §17).

The port of ``repro.runtime.failover``.  Detection of a *silently* damaged
shard (bit rot, a misbehaving device writing garbage — no exception
anywhere) cannot ride on the fused patch path: nothing fails.  Instead the
serving writer runs an :class:`AuditScheduler` between rounds — ONE
healthy shard per tick, round-robin, so a full sweep costs ``n_shards``
idle ticks and the steady-state stream never stalls behind a monolithic
audit.  A tick that trips (``ShardedGraph.audit_shard``: structural audit,
stray-row pass, CRC descriptor verify when ``enable_integrity()`` is on)
hands the failed shard id back for quarantine.  The scheduler is plain
Python over any object with ``n_shards``, ``down`` and
``audit_shard(sid)``; on the single-device representations (which have no
``audit_shard``) ``WalkServer`` never runs it.

:func:`corrupt_shard` is the fault model itself — the damage the
``shard.corrupt`` fault point and the chaos tests inflict: flip one live
slot in place, exactly the way a bad DIMM or a mis-targeted DMA would,
with no exception raised.  Torch tensors are mutable, so the write goes
through the image's copy-on-write: a sealed generation that shares the
shard's payload keeps the pre-damage buffers (``repro`` gets this from
immutable arrays, its corruption *replaces* the live reference).
"""
from __future__ import annotations

import numpy as np

from ..core import util

SENTINEL = util.SENTINEL


class AuditScheduler:
    """Round-robin one-shard-per-tick audit over a sharded graph (§17).

    ``tick()`` audits the next healthy shard; returns ``None`` when it
    passes (or no shard is auditable) and ``(sid, exc)`` on a violation
    — the caller quarantines.  Down shards are skipped, so a degraded
    mesh keeps sweeping its healthy part.
    """

    def __init__(self, g):
        self.g = g
        self._cursor = 0
        self.ticks = 0
        self.detections: list = []

    def tick(self):
        g = self.g
        sid = None
        for k in range(g.n_shards):
            cand = (self._cursor + k) % g.n_shards
            if cand not in g.down:
                sid = cand
                break
        if sid is None:
            return None
        self._cursor = (sid + 1) % g.n_shards
        self.ticks += 1
        try:
            g.audit_shard(sid)
        except Exception as e:
            self.detections.append((sid, e))
            return sid, e
        return None


def corrupt_shard(g, sid: int, *, kind: str = "wgt"):
    """Silently damage one live slot of shard ``sid`` in place.

    * ``kind="wgt"`` perturbs a live weight — structurally valid, so
      ONLY the CRC integrity descriptor can catch it;
    * ``kind="dst"`` stamps SENTINEL into a live destination slot — a
      structural violation the plain ``WalkImage.audit`` content sweep
      trips on even with integrity tracking off.

    Returns the damaged slot index, or ``None`` when the shard holds no
    live edges (nothing to damage).  Never raises into the update path —
    that is the point: detection must come from the audit side.
    """
    if kind not in ("wgt", "dst"):
        raise ValueError(f"corrupt_shard: unknown kind {kind!r}")
    sid = int(sid)
    img = g.shards[sid]
    lo_v, hi_v = g.owned_range(sid)
    degs = np.asarray(img.degs[lo_v:hi_v], np.int64)
    rows = np.nonzero(degs > 0)[0]
    if rows.size == 0:
        return None
    row = int(rows[-1]) + lo_v
    slot = int(img.starts[row])
    img._detach_generation()  # a sealed generation keeps the buffers it sealed
    if kind == "wgt":
        img.wgt[slot] += 0.5
    else:
        img.dst[slot] = int(SENTINEL)
    g._placed = None
    return slot
