"""Shard-failover helpers: incremental audit scheduling (DESIGN.md §17).

The port of ``repro.runtime.failover``'s :class:`AuditScheduler`.
Detection of a *silently* damaged shard (bit rot, a misbehaving device
writing garbage — no exception anywhere) cannot ride on the fused patch
path: nothing fails.  Instead the serving writer runs an
:class:`AuditScheduler` between rounds — ONE healthy shard per tick,
round-robin, so a full mesh sweep costs ``n_shards`` idle ticks and the
steady-state stream never stalls behind a monolithic audit.  A tick that
trips (the graph's ``audit_shard``) hands the failed shard id back for
quarantine.

The scheduler is plain Python over any object with ``n_shards``, ``down``
and ``audit_shard(sid)``; ``WalkServer._audit_tick`` drives it, and on the
single-device representations (which have no ``audit_shard``) it never
runs.  ``repro``'s ``corrupt_shard``, which damages a ``ShardedGraph``'s
shard images, comes with the sharded mesh.
"""
from __future__ import annotations


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
