"""Invariant-audit failures (the auditor half of ``repro``'s faultinject).

``WalkImage.audit`` sweeps an image's geometry and payload and raises
``AuditError`` through ``_check`` on the first broken invariant.  The
fault-injection points and the cross-representation ``audit(rep)`` arrive
with durability.
"""
from __future__ import annotations


class AuditError(RuntimeError):
    """An invariant audit found cross-layer inconsistency."""


def _check(cond, msg: str):
    if not cond:
        raise AuditError(msg)
