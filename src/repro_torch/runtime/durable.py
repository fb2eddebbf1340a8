"""Durable self-healing update pipeline (DESIGN.md §13), single device.

The port of ``repro.runtime.durable``'s single-device half.  Two halves
turn any of the five representations into a crash-recoverable graph:

* :class:`UpdateJournal` — a write-ahead log of canonical ``UpdatePlan``
  op streams.  Every ``DurableGraph.apply`` appends ONE compact binary
  record (the four canonical arrays + a monotone sequence number + a
  CRC32) *before* the fused dispatch runs, so any applied update is
  reconstructible from disk.  Records pack into size-rotated segment
  files; replay tolerates a torn final record (the crash happened
  mid-append) and refuses everything else (bit rot, mid-log tears).
  :meth:`UpdateJournal.append_group` group-commits a round's plans in ONE
  buffer with a single ``flush()``.

* :class:`DurableGraph` — wraps a representation with the WAL, periodic
  checkpoints of its full canonical state (``state_tree()`` through
  ``checkpoint.manager``), and :func:`DurableGraph.recover`: newest
  complete checkpoint + WAL replay through the SAME ``apply`` path the
  live process used, on the device the caller names.  Checkpoints capture
  exact buffers (arena geometry included), and every apply is
  deterministic given its plan and device, so a recovered graph is
  **bit-identical** to the uncrashed one on the same device.  With
  ``diff=True`` periodic checkpoints are differential: chunks are
  hash-compared against the chain's latest step and only changed ones
  persist.

The record format, the segment names and the checkpoint layout are
``repro``'s, byte for byte: a journal or a checkpoint either package wrote
recovers in the other.

Failure model: process crash (SIGKILL, OOM-kill) at any instant.  A
record is durable once ``flush()`` hands it to the OS — fsync per append
is available (``fsync=True``) for the power-loss model but off by
default.  Replay is at-least-once: a crash between the WAL append and the
in-memory apply re-applies the record's plan on recovery, which is safe
because the op stream is idempotent (inserts are upserts at fixed weights,
deletes of absent keys filter out).

Crash points, torn-tail repair, and the post-recovery invariant sweep
are exercised through ``runtime/faultinject.py``.

The sharded half (DESIGN.md §15/§17), for a ``ShardedGraph``:

* **owner-routed parallel replay** — ``recover(parallel=True)`` partitions
  replayed records by shard owner through the SAME ``route_updates``
  searchsorted the live path uses and drains each shard's queue on its own
  thread (each through the shard's fused ``slot_update`` patch path, every
  thread on the device's default stream).  Growth records fence the
  fan-out into epochs; the per-shard + cross-boundary ``audit()`` gates
  the result.
* **tracked differential checkpoints** — with ``diff=True`` the wrapper
  tracks the WAL window's dirty blocks (plan rows + image block geometry)
  and hands them to ``checkpoint.manager.save_arrays_diff`` as hints, so
  only those chunks persist, with a full compaction checkpoint every
  ``full_every`` snapshots.
* **online single-shard rebuild** — ``rebuild_shard`` restores one
  quarantined shard from its checkpoint chain, replays its slice of the WAL
  window and its spool, and reintegrates it while the rest keeps serving.

Over a graph on a mesh (``launch.mesh.Mesh``, one process a rank) every rank
wraps its own process's graph with the same arguments and makes the same
calls: rank 0 alone appends to the WAL (its outcome agreed, so a failed
append raises on every rank), every rank writes its own shard's arrays into
the step rank 0 commits, ``recover(mesh=)`` restores each rank's own shard
and replays the same records through ``apply`` (each rank patching its own
rows: the mesh is the parallel replay), and ``rebuild_shard`` rebuilds on
the owning rank.  The directories are local mode's, so either mode recovers
what the other wrote.
"""
from __future__ import annotations

import errno
import os
import struct
import time
import zlib
from typing import Iterator, Optional

import numpy as np

from ..checkpoint import manager as ckpt
from ..core import REPRESENTATIONS, distributed as dist, updates, walk_image
from . import faultinject

#: Record header: magic "WAL1", sequence number, vertex watermark, op
#: count, CRC32 of the payload bytes.  Little-endian, 24 bytes.
_HEADER = struct.Struct("<IQIII")
_MAGIC = 0x314C4157  # b"WAL1"
#: An n_ops beyond this is implausible for any batch this repo builds —
#: treat it as corruption instead of attempting a huge read.
_MAX_OPS = 1 << 26
#: Bytes per op in the payload: src i4 + dst i4 + wgt f4 (+ packed del bits).
_OP_BYTES = 12


class WalCorruptError(RuntimeError):
    """The journal is damaged beyond the benign torn-tail case."""


class WalDiskFullError(RuntimeError):
    """A segment write failed mid-append (ENOSPC, short write, I/O error).

    The failed append was rolled back — the segment is truncated to its
    last pre-append boundary, so every previously acknowledged record is
    intact and the SAME append may be retried once space returns.  The
    in-memory graph was never touched (WAL-first ordering: the apply
    only runs after the append succeeds)."""


def _payload_size(n_ops: int) -> int:
    return n_ops * _OP_BYTES + (n_ops + 7) // 8


def encode_record(seq: int, nv_bound: int, plan: updates.UpdatePlan) -> bytes:
    """One WAL record: header + packed canonical op stream."""
    n = plan.n_ops
    payload = b"".join(
        (
            np.ascontiguousarray(plan.q_src, np.int32).tobytes(),
            np.ascontiguousarray(plan.q_dst, np.int32).tobytes(),
            np.ascontiguousarray(plan.q_wgt, np.float32).tobytes(),
            np.packbits(plan.q_del.astype(bool)).tobytes(),
        )
    )
    head = _HEADER.pack(_MAGIC, seq, int(nv_bound), n, zlib.crc32(payload))
    return head + payload


def decode_record(head: bytes, payload: bytes):
    """Inverse of :func:`encode_record`; raises :class:`WalCorruptError`."""
    magic, seq, nv_bound, n, crc = _HEADER.unpack(head)
    if magic != _MAGIC:
        raise WalCorruptError(f"bad record magic {magic:#x}")
    if n > _MAX_OPS:
        raise WalCorruptError(f"implausible record size: {n} ops")
    if len(payload) != _payload_size(n):
        raise WalCorruptError("record payload size disagrees with header")
    if zlib.crc32(payload) != crc:
        raise WalCorruptError(f"record {seq}: payload CRC mismatch")
    q_src = np.frombuffer(payload[: 4 * n], np.int32)
    q_dst = np.frombuffer(payload[4 * n : 8 * n], np.int32)
    q_wgt = np.frombuffer(payload[8 * n : 12 * n], np.float32)
    q_del = np.unpackbits(np.frombuffer(payload[12 * n :], np.uint8), count=n).astype(bool)
    return seq, nv_bound, (q_src, q_dst, q_wgt, q_del)


class UpdateJournal:
    """Segment-rotated write-ahead log of UpdatePlan records.

    Segments are ``wal-{first_seq:012d}.seg`` — the name carries the
    first sequence number the segment holds, so truncation after a
    checkpoint is pure filename arithmetic.  ``repair=True`` (the
    recovery path) truncates a torn record off the FINAL segment's tail;
    a torn record anywhere else, or a complete record that fails its
    CRC, is real corruption and raises :class:`WalCorruptError`.
    """

    def __init__(
        self,
        wal_dir: str,
        *,
        segment_bytes: int = 1 << 20,
        fsync: bool = False,
        repair: bool = False,
    ):
        self.wal_dir = wal_dir
        self.segment_bytes = int(segment_bytes)
        self.fsync = bool(fsync)
        os.makedirs(wal_dir, exist_ok=True)
        self._fh = None
        self._cur_path: Optional[str] = None
        #: write()+flush() syscall rounds — the group-commit proof field
        self.flushes = 0
        if repair:
            self.repair_tail()
        self.next_seq = self._scan_next_seq()

    # -- segment bookkeeping -------------------------------------------
    def segments(self) -> list[str]:
        names = sorted(
            n for n in os.listdir(self.wal_dir) if n.startswith("wal-") and n.endswith(".seg")
        )
        return [os.path.join(self.wal_dir, n) for n in names]

    @staticmethod
    def _first_seq(path: str) -> int:
        return int(os.path.basename(path)[4:-4])

    def _scan_next_seq(self) -> int:
        """Next sequence number — learned from the FINAL segment only.

        Segment filenames carry their first record's sequence number, so
        the scan anchors at ``first_seq - 1`` and walks one segment's
        records forward.  A torn tail just stops the walk; bad magic
        mid-segment is real corruption and raises.
        """
        segs = self.segments()
        if not segs:
            return 1
        path = segs[-1]
        last = self._first_seq(path) - 1
        with open(path, "rb") as f:
            data = f.read()
        pos, size = 0, len(data)
        while pos < size:
            head = data[pos : pos + _HEADER.size]
            if len(head) < _HEADER.size:
                break  # torn header at the tail
            magic, seq, _nv, n, _crc = _HEADER.unpack(head)
            if magic != _MAGIC or n > _MAX_OPS:
                raise WalCorruptError(f"{path}: bad record at offset {pos}")
            if pos + _HEADER.size + _payload_size(n) > size:
                break  # torn payload at the tail
            last = seq
            pos += _HEADER.size + _payload_size(n)
        return last + 1

    # -- append side ----------------------------------------------------
    def _open_segment(self, first_seq: int) -> None:
        self._close_fh()
        self._cur_path = os.path.join(self.wal_dir, f"wal-{first_seq:012d}.seg")
        self._fh = open(self._cur_path, "ab")
        if self.fsync:
            # power-loss model: file durability alone does not make the
            # new NAME durable — fsync the directory after rotation
            dfd = os.open(self.wal_dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)

    def _close_fh(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def _segment_for(self, seq: int) -> None:
        """Position the append handle, rotating BEFORE the write — a
        record (or group) never splits across segments."""
        if self._fh is None:
            segs = self.segments()
            if segs and os.path.getsize(segs[-1]) < self.segment_bytes:
                self._cur_path = segs[-1]
                self._fh = open(self._cur_path, "ab")
            else:
                self._open_segment(seq)
        elif self._fh.tell() >= self.segment_bytes:
            self._open_segment(seq)

    def _write_flush(self, buf: bytes) -> None:
        """Write + flush one append, or roll the segment back untouched.

        A failed or short write (disk full, I/O error, the ``wal.write``
        injection point) must not leave a half-record at the tail: the
        handle is closed, the file truncated to the pre-append boundary,
        and a fresh append handle opened — then :class:`WalDiskFullError`
        tells the caller the append is retryable.  ``next_seq`` only
        advances in the caller after this returns, so a retry reuses the
        same sequence numbers.
        """
        size0 = self._fh.tell()
        try:
            faultinject.fire("wal.write")
            wrote = self._fh.write(buf)
            if wrote != len(buf):
                raise OSError(errno.ENOSPC, f"short write: {wrote}/{len(buf)}")
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
        except (OSError, faultinject.InjectedKernelError) as e:
            try:
                self._fh.close()
            except OSError:
                pass  # the roll-back below is what matters
            self._fh = None
            try:
                os.truncate(self._cur_path, size0)
            except OSError:
                pass  # the WalDiskFullError below reports the failed append
            self._fh = open(self._cur_path, "ab")
            raise WalDiskFullError(
                f"{self._cur_path}: segment write failed at offset {size0} "
                f"({e}) — segment rolled back, append retryable"
            ) from e
        self.flushes += 1

    def append(self, plan: updates.UpdatePlan, nv_bound: int) -> int:
        """Write one record; durable (to the OS) before this returns."""
        seq = self.next_seq
        self._segment_for(seq)
        self._write_flush(encode_record(seq, nv_bound, plan))
        self.next_seq = seq + 1
        return seq

    def append_group(self, plans, nv_bounds) -> list[int]:
        """Group commit: a round's plans in ONE buffer, ONE flush/fsync.

        Records keep their individual seq/CRC framing (replay and repair
        are unchanged), only the syscall cost amortizes.  The group lands
        in a single segment — rotation happens before the write, never
        inside it — so a crash tears at most the group's byte suffix,
        which ``repair_tail`` truncates back to the last complete record
        boundary: the surviving prefix was durable, the lost suffix was
        never acknowledged.
        """
        if len(plans) != len(nv_bounds):
            raise ValueError("append_group: plans/nv_bounds length mismatch")
        if not plans:
            return []
        seq0 = self.next_seq
        seqs = list(range(seq0, seq0 + len(plans)))
        self._segment_for(seq0)
        buf = b"".join(encode_record(s, nv, p) for s, nv, p in zip(seqs, nv_bounds, plans))
        self._write_flush(buf)
        self.next_seq = seq0 + len(plans)
        return seqs

    # -- read side ------------------------------------------------------
    def replay(self, after: int = 0) -> Iterator[tuple]:
        """Yield ``(seq, nv_bound, (q_src, q_dst, q_wgt, q_del))`` in order.

        Sequence numbers must be strictly increasing across the whole
        log; an incomplete record is tolerated only at the very tail of
        the FINAL segment (the append the crash interrupted) — replay
        stops there.  Anything else raises :class:`WalCorruptError`.
        """
        segs = self.segments()
        last_seq = None
        for si, path in enumerate(segs):
            final_seg = si == len(segs) - 1
            with open(path, "rb") as f:
                data = f.read()
            pos, size = 0, len(data)
            while pos < size:
                head = data[pos : pos + _HEADER.size]
                if len(head) < _HEADER.size:
                    if final_seg:
                        return  # torn header at the log tail
                    raise WalCorruptError(f"{path}: torn record mid-log")
                magic, seq, nv_bound, n, _crc = _HEADER.unpack(head)
                if magic != _MAGIC or n > _MAX_OPS:
                    raise WalCorruptError(f"{path}: bad record at offset {pos}")
                body = data[pos + _HEADER.size : pos + _HEADER.size + _payload_size(n)]
                if len(body) < _payload_size(n):
                    if final_seg:
                        return  # torn payload at the log tail
                    raise WalCorruptError(f"{path}: torn record mid-log")
                seq, nv_bound, arrs = decode_record(head, body)
                if last_seq is not None and seq <= last_seq:
                    raise WalCorruptError(f"{path}: sequence {seq} not after {last_seq}")
                last_seq = seq
                pos += _HEADER.size + _payload_size(n)
                if seq > after:
                    yield seq, nv_bound, arrs

    def repair_tail(self) -> int:
        """Truncate a torn record off the final segment; returns bytes cut.

        Walks complete records to find the last clean boundary, checking
        CRCs along the way — a complete-but-corrupt record is NOT
        repairable and raises (truncating it would silently lose an
        acknowledged update and every record after it).
        """
        segs = self.segments()
        if not segs:
            return 0
        path = segs[-1]
        with open(path, "rb") as f:
            data = f.read()
        pos, size = 0, len(data)
        while pos < size:
            head = data[pos : pos + _HEADER.size]
            if len(head) < _HEADER.size:
                break
            magic, _seq, _nv, n, _crc = _HEADER.unpack(head)
            if magic != _MAGIC or n > _MAX_OPS:
                raise WalCorruptError(f"{path}: bad record at offset {pos}")
            body = data[pos + _HEADER.size : pos + _HEADER.size + _payload_size(n)]
            if len(body) < _payload_size(n):
                break
            decode_record(head, body)  # CRC check; raises on rot
            pos += _HEADER.size + _payload_size(n)
        cut = size - pos
        if cut:
            os.truncate(path, pos)
        return cut

    def truncate_through(self, seq: int) -> int:
        """Drop segments made redundant by a checkpoint at ``seq``.

        A segment is deletable when its SUCCESSOR's first record is
        already covered (first_seq − 1 <= seq): everything the segment
        holds replays to state the checkpoint captured.  The last
        segment always survives — it is the append target.
        """
        segs = self.segments()
        removed = 0
        for i in range(len(segs) - 1):
            if self._first_seq(segs[i + 1]) - 1 <= seq:
                os.remove(segs[i])
                removed += 1
        return removed

    def close(self) -> None:
        self._close_fh()


class _ShardDirty:
    """Per-shard dirty-block accumulator for differential checkpoints."""

    __slots__ = ("full", "touched", "rows", "ranges")

    def __init__(self):
        self.full = False     # whole shard dirty (rebuild / tracker overflow)
        self.touched = False
        self.rows = []        # np arrays of touched row ids
        self.ranges = []      # np [K, 2] half-open slot-element ranges


#: Beyond this many tracked rows a shard's accumulator degrades to
#: "full" — the diff would approach full size anyway and the tracking
#: lists must not grow with the WAL window unbounded.
_DIRTY_CAP = 1 << 16


class DurableGraph:
    """A representation wrapped in WAL-first apply + checkpoint/restore.

    Ordering contract (the injection points bracket it):

        validate → WAL append → fused apply → watermark advance

    so every state the in-memory graph can reach is reconstructible as
    ``checkpoint ⊕ WAL[seq+1:]``.  ``checkpoint_every=k`` snapshots the
    full canonical state every k applies (k=0: manual only); the
    constructor writes a step-0 checkpoint so recovery always has a base.

    ``rep`` is one of the five registered representations OR a
    ``ShardedGraph`` (§14), on whatever device it was built on — the
    wrapper detects which and routes applies, checkpoints and recovery
    accordingly.  ``diff=True`` switches periodic checkpoints to
    differential steps (every ``full_every``-th snapshot is a full
    compaction point that re-anchors the chain).
    """

    def __init__(
        self,
        rep,
        wal_dir: str,
        ckpt_dir: str,
        *,
        checkpoint_every: int = 0,
        keep: int = 3,
        fsync: bool = False,
        segment_bytes: int = 1 << 20,
        diff: bool = False,
        full_every: int = 8,
        _recovering: bool = False,
    ):
        self._sharded = isinstance(rep, dist.ShardedGraph)
        if not self._sharded and type(rep) not in REPRESENTATIONS.values():
            raise TypeError(
                f"DurableGraph: {type(rep).__name__} is neither a ShardedGraph nor one "
                f"of the registered representations {sorted(REPRESENTATIONS)}"
            )
        self.rep = rep
        self.wal_dir = wal_dir
        self.ckpt_dir = ckpt_dir
        self.checkpoint_every = int(checkpoint_every)
        self.keep = int(keep)
        self.diff = bool(diff)
        self.full_every = max(int(full_every), 1)
        self._ckpts_since_full = 0
        self._dirty: dict = {}
        # replay applies are not tracked → first post-recovery checkpoint
        # must be a full one (as in repro, so the chains agree)
        self._force_full = bool(_recovering)
        #: the graph's mesh (None: one process holds every shard)
        self.mesh = rep.mesh if self._sharded else None

        def journal(repair):
            return UpdateJournal(wal_dir, segment_bytes=segment_bytes, fsync=fsync,
                                 repair=repair)

        if self.mesh is None:
            self.journal = journal(_recovering)
        else:
            # rank 0 appends and repairs; the others read once it has
            own = []
            self.mesh.settle(lambda: own.append(journal(_recovering)), on=0)
            self.journal = own[0] if own else journal(False)
        self.seq = self.journal.next_seq - 1
        self._applies_since_ckpt = 0
        self._nv_bound = max(int(rep.n), 1)
        if not _recovering and self._on_rank0(lambda: ckpt.latest_step(ckpt_dir)) is None:
            self.checkpoint()

    def _on_rank0(self, fn):
        """``fn()`` here, or on a mesh on rank 0 with its result (or its
        exception) handed to every rank."""
        if self.mesh is None:
            return fn()
        return self.mesh.settle(fn, on=0)[0]

    @property
    def rep_name(self) -> str:
        if self._sharded:
            return "sharded"
        cls = type(self.rep)
        for name, c in REPRESENTATIONS.items():
            if c is cls:
                return name
        raise TypeError(f"unregistered representation {cls.__name__}")

    # -- dirty-block tracking (differential checkpoints, §15) ----------
    def _dirty_pre(self, plan):
        """Snapshot the block geometry a plan is about to disturb."""
        rep = self.rep
        per = []
        for sid, sub in dist.route_updates(plan, rep.n_shards, rep.rows_max):
            if not rep.holds(sid):
                continue
            img = rep.shards[sid]
            rows = sub.touched_rows(rep.v_pad)
            per.append((sid, rows, img.block_ranges(rows), img.bump))
        return rep.generation, per

    def _dirty_post(self, pre) -> None:
        gen0, per = pre
        rep = self.rep
        if rep.generation != gen0:
            # a rebuild re-sharded every image: every shard dirty
            for sid in range(rep.n_shards):
                d = self._dirty.setdefault(sid, _ShardDirty())
                d.full = d.touched = True
                d.rows, d.ranges = [], []
            return
        for sid, rows, old_ranges, bump0 in per:
            img = rep.shards[sid]
            d = self._dirty.setdefault(sid, _ShardDirty())
            d.touched = True
            if d.full:
                continue
            d.rows.append(rows)
            d.ranges.append(old_ranges)            # vacated slots → SENTINEL
            d.ranges.append(img.block_ranges(rows))  # current extents
            if img.bump > bump0:                   # freshly bumped blocks
                d.ranges.append(np.array([[bump0, img.bump]], np.int64))
            if sum(r.shape[0] for r in d.rows) > _DIRTY_CAP:
                d.full, d.rows, d.ranges = True, [], []

    def _export_dirty(self) -> dict:
        """The {shard: hint} dirty-block set ``save_arrays_diff`` consumes."""
        meta_full = {
            "__meta__/rep": "full", "__meta__/wal_seq": "full",
            "__meta__/nv_bound": "full",
        }
        out = {}
        for sid in range(self.rep.n_shards):
            d = self._dirty.get(sid)
            if d is None or not d.touched:
                if sid == 0:
                    # shard 0 carries the wrapper meta, which always moves
                    hint = {k: "clean" for k in
                            ("dst", "wgt", "rows", "starts", "caps", "degs")}
                    hint["meta"] = "clean"
                    hint.update(meta_full)
                    out[sid] = hint
                else:
                    out[sid] = "clean"
                continue
            if d.full:
                out[sid] = "full"
                continue
            rows = (
                np.unique(np.concatenate(d.rows)).astype(np.int64)
                if d.rows else np.empty(0, np.int64)
            )
            row_ranges = np.stack([rows, rows + 1], axis=1)
            slot_ranges = (
                np.concatenate([np.asarray(r).reshape(-1, 2) for r in d.ranges])
                if d.ranges else np.empty((0, 2), np.int64)
            )
            hint = {
                "dst": slot_ranges, "wgt": slot_ranges, "rows": slot_ranges,
                "starts": row_ranges, "caps": row_ranges, "degs": row_ranges,
                "meta": "full",  # nv/bump/live counters, a few ints
            }
            if sid == 0:
                hint.update(meta_full)
            out[sid] = hint
        return out

    def _reset_dirty(self) -> None:
        self._dirty = {}
        self._force_full = False

    # -- the durable apply path ----------------------------------------
    def _rep_apply(self, plan: updates.UpdatePlan) -> int:
        """Dispatch one validated plan into the live representation."""
        if not self._sharded:
            # reps with rebuild semantics (SortedCOO) return a successor
            # instance — rebind so the wrapper always tracks live state
            self.rep, dm = self.rep.apply(plan)
            return dm
        pre = self._dirty_pre(plan) if self.diff else None
        self.rep.apply(plan)  # ShardedGraph mutates in place
        if pre is not None:
            self._dirty_post(pre)
        return 0

    def apply(self, plan: updates.UpdatePlan):
        """WAL-first apply; returns (self, net ΔM)."""
        if plan.n_ops == 0:
            return self, 0
        plan.validate()
        nv_bound = max(self._nv_bound, plan.max_insert_vertex() + 1)
        faultinject.fire("durable.pre_append")
        seq = self._on_rank0(lambda: self.journal.append(plan, nv_bound))
        faultinject.fire("durable.post_append")
        dm = self._rep_apply(plan)
        self.seq = seq
        self._nv_bound = nv_bound
        faultinject.fire("durable.post_apply")
        self._applies_since_ckpt += 1
        if self.checkpoint_every and self._applies_since_ckpt >= self.checkpoint_every:
            self.checkpoint()
        return self, dm

    def apply_group(self, plans):
        """Group-committed apply: one WAL flush for a round's plans.

        Same ordering contract as :meth:`apply` — every plan is durable
        (one ``append_group`` buffer) before the first fused dispatch
        runs.  A crash mid-round therefore re-applies the whole round on
        recovery (at-least-once, idempotent); a crash mid-append tears
        the group's suffix, which was never acknowledged.  Returns
        ``(self, net ΔM)`` summed over the round.
        """
        plans = [p for p in plans if p.n_ops]
        if not plans:
            return self, 0
        bounds, nv = [], self._nv_bound
        for p in plans:
            p.validate()
            nv = max(nv, p.max_insert_vertex() + 1)
            bounds.append(nv)
        faultinject.fire("durable.pre_append")
        seqs = self._on_rank0(lambda: self.journal.append_group(plans, bounds))
        faultinject.fire("durable.post_append")
        total = 0
        for p, seq, b in zip(plans, seqs, bounds):
            total += self._rep_apply(p)
            self.seq = seq
            self._nv_bound = b
            faultinject.fire("durable.post_apply")
        self._applies_since_ckpt += len(plans)
        if self.checkpoint_every and self._applies_since_ckpt >= self.checkpoint_every:
            self.checkpoint()
        return self, total

    # -- checkpoint / recover ------------------------------------------
    def checkpoint(self) -> str:
        """Snapshot the canonical state; prune the WAL behind it.

        With ``diff=True`` this writes a differential step against the
        latest checkpoint — unless no base exists, the chain is
        ``full_every`` long (periodic compaction), or the window holds
        replayed applies (post-recovery) — in which case it falls back to
        a full step that re-anchors the chain.  A sharded graph's step
        writes one file per shard and persists exactly its tracked dirty
        blocks; a single-device diff hash-compares chunks against the base.
        """
        meta = {
            "__meta__/rep": np.array(self.rep_name),
            "__meta__/wal_seq": np.int64(self.seq),
            "__meta__/nv_bound": np.int64(self._nv_bound),
        }
        if self._sharded:
            shards = {int(s): dict(t) for s, t in self.rep.state_trees().items()}
            if 0 in shards:
                shards[0].update(meta)
        else:
            arrays = dict(self.rep.state_tree())
            arrays.update(meta)
            shards = {0: arrays}
        step = max(self.seq, 0)
        want_diff = (
            self.diff
            and not self._force_full
            and self._on_rank0(lambda: ckpt.latest_step(self.ckpt_dir)) is not None
            and self._ckpts_since_full < self.full_every - 1
        )
        dirty = self._export_dirty() if want_diff and self._sharded else None
        if self.mesh is not None:
            own = self.mesh.rank
            path = ckpt.save_arrays_mesh(self.ckpt_dir, step, self.mesh, shards[own],
                                         keep=self.keep, diff=want_diff,
                                         dirty=(dirty or {}).get(own))
        elif want_diff:
            path = ckpt.save_arrays_diff(self.ckpt_dir, step, shards, keep=self.keep,
                                         dirty=dirty)
        else:
            path = ckpt.save_arrays_sharded(self.ckpt_dir, step, shards, keep=self.keep)
        self._ckpts_since_full = self._ckpts_since_full + 1 if want_diff else 0
        self._reset_dirty()
        self._on_rank0(lambda: self.journal.truncate_through(self.seq))
        self._applies_since_ckpt = 0
        return path

    @classmethod
    def recover(
        cls,
        wal_dir: str,
        ckpt_dir: str,
        *,
        device=None,
        checkpoint_every: int = 0,
        keep: int = 3,
        fsync: bool = False,
        segment_bytes: int = 1 << 20,
        audit: bool = True,
        parallel: bool = True,
        mesh=None,
        diff: bool = False,
        full_every: int = 8,
        stats: Optional[dict] = None,
    ) -> "DurableGraph":
        """Newest complete checkpoint + WAL replay = the uncrashed graph.

        1. sweep ``.tmp_ckpt_*`` debris (writers the crash interrupted);
        2. restore the newest complete checkpoint's exact state arrays —
           full, sharded, or a differential chain, resolved uniformly
           through ``restore_arrays_diff`` — onto ``device`` (the card
           unless the caller asks for the CPU);
        3. repair the WAL tail (the append the crash interrupted) and
           replay every record past the checkpoint's watermark — for a
           sharded graph with ``parallel=True``, owner-routed across
           per-shard threads (:meth:`_replay_parallel`); otherwise
           serially through the ordinary ``apply`` path — each record
           validated against its own vertex watermark;
        4. run the cross-layer invariant audit on the result (the
           per-shard + cross-boundary pass for sharded graphs).

        With a ``mesh`` (every rank calls it with the same arguments) the
        checkpoint must hold a sharded graph of ``mesh.size`` shards: rank 0
        sweeps the debris, picks the step and reads the wrapper meta, each
        rank restores its own shard (onto ``mesh.device``), and every rank
        replays the same records through ``apply``, patching its own rows
        (``parallel`` has nothing to add: the ranks are the parallel
        replay).  ``stats``, if given, receives ``restore_s`` /
        ``replay_s`` / ``records``.
        """
        dist._check_mesh(mesh, None, "DurableGraph.recover")
        dev = dist._placement(mesh, device)
        t0 = time.perf_counter()
        if mesh is None:
            ckpt.clean_stale(ckpt_dir)
            trees, _step = ckpt.restore_arrays_diff(ckpt_dir)
            meta = trees[0 if 0 in trees else min(trees)]
        else:
            trees, meta = cls._restore_mesh(ckpt_dir, mesh)
        name = str(meta.pop("__meta__/rep")[()])
        wal_seq = int(meta.pop("__meta__/wal_seq")[()])
        nv_bound = int(meta.pop("__meta__/nv_bound")[()])
        if name == "sharded":
            rep = dist.ShardedGraph.from_state_trees(trees, mesh=mesh, device=dev)
        elif mesh is not None:
            raise TypeError(f"recover: a mesh restores a sharded graph; the checkpoint "
                            f"holds {name!r}")
        elif name in REPRESENTATIONS:
            rep = REPRESENTATIONS[name].from_state_tree(meta, device=dev)
        else:
            raise TypeError(f"recover: checkpoint holds {name!r}, neither 'sharded' nor a "
                            f"representation {sorted(REPRESENTATIONS)}")
        t1 = time.perf_counter()
        g = cls(
            rep, wal_dir, ckpt_dir,
            checkpoint_every=checkpoint_every, keep=keep, fsync=fsync,
            segment_bytes=segment_bytes, diff=diff, full_every=full_every,
            _recovering=True,
        )
        g.seq = wal_seq
        g._nv_bound = max(nv_bound, 1)
        if g._sharded and parallel and mesh is None:
            records = g._replay_parallel(wal_seq)
        else:
            records = 0
            for seq, rec_nv, (qs, qd, qw, ql) in g.journal.replay(after=wal_seq):
                plan = updates.plan_from_canonical(qs, qd, qw, ql)
                plan.validate(num_vertices=int(rec_nv))
                if g._sharded:
                    g.rep.apply(plan)
                else:
                    g.rep, _ = g.rep.apply(plan)
                g.seq = seq
                g._nv_bound = max(g._nv_bound, int(rec_nv))
                records += 1
        t2 = time.perf_counter()
        if audit:
            faultinject.audit(g.rep)
        if stats is not None:
            stats.update(restore_s=t1 - t0, replay_s=t2 - t1, records=records)
        return g

    @staticmethod
    def _restore_mesh(ckpt_dir: str, mesh):
        """Each rank restores its own shard of the newest step (every rank
        reads the same directory; rank 0 sweeps the debris).  -> ({rank:
        arrays}, the wrapper meta (shard 0's ``__meta__/*`` keys, handed to
        every rank))."""
        step, n_shards = ckpt.step_shards(ckpt_dir)
        dist._check_mesh(mesh, n_shards, "DurableGraph.recover")
        mesh.settle(lambda: ckpt.clean_stale(ckpt_dir), on=0)
        box = {}

        def own():
            arrays, _ = ckpt.restore_shard_diff(ckpt_dir, mesh.rank, step=step)
            box["meta"] = {k: arrays.pop(k) for k in list(arrays) if k.startswith("__meta__/")}
            box["arrays"] = arrays
            return box["meta"] or None

        metas = mesh.settle(own)
        if metas[0] is None:
            raise ValueError(f"recover: shard 0 of step {step} carries no wrapper meta")
        return {mesh.rank: box["arrays"]}, dict(metas[0])

    def _replay_parallel(self, after: int) -> int:
        """Owner-routed parallel WAL replay over the shards (§15).

        Records are decoded and validated up front, then split into epochs
        at growth records (a growth triggers the global re-shard, which
        must see every earlier record applied and fences every later one).
        Within an epoch each record is routed by the same ``route_updates``
        searchsorted the live path uses into per-shard FIFO queues; one
        thread per touched shard drains its queue through the shard's fused
        patch path (all on the device's default stream, each thread on its
        own shard's buffers).  A shard whose flush fails stops queueing
        immediately (queue depth past ``MAX_PENDING`` would silently drop
        plans) and hands its ordered remainder to ONE global ``_rebuild`` —
        the fallback the live path takes, so recovered content is the
        same.
        """
        import threading
        from concurrent.futures import ThreadPoolExecutor

        records = []
        for seq, rec_nv, (qs, qd, qw, ql) in self.journal.replay(after=after):
            plan = updates.plan_from_canonical(qs, qd, qw, ql)
            plan.validate(num_vertices=int(rec_nv))
            records.append((seq, int(rec_nv), plan))
        if not records:
            return 0

        def drain(sid, subs, start):
            start.wait()  # each touched shard drains on a pool thread of its own
            img = self.rep.shards[sid]
            for k, sub in enumerate(subs):
                if img._stale:
                    return subs[k:]
                img.queue(sub)
                if not img.flush():
                    return subs[k + 1:]  # sub itself pends on img
            return []

        with ThreadPoolExecutor(max_workers=self.rep.n_shards) as ex:
            i = 0
            while i < len(records):
                j = i
                while j < len(records) and records[j][2].max_insert_vertex() < self.rep.n:
                    j += 1
                if j > i:  # fan an epoch of non-growth records out
                    queues: dict = {}
                    for _seq, _nv, plan in records[i:j]:
                        for sid, sub in dist.route_updates(
                            plan, self.rep.n_shards, self.rep.rows_max
                        ):
                            queues.setdefault(sid, []).append(sub)
                    start = threading.Barrier(len(queues), timeout=60)
                    leftovers = list(ex.map(lambda kv: drain(*kv, start),
                                            sorted(queues.items())))
                    self.rep._placed = None
                    extra = [p for rest in leftovers for p in rest]
                    if extra or any(img._pending for img in self.rep.shards):
                        # _rebuild folds per-image pending queues first,
                        # then extras — global (src, dst) order restored
                        self.rep._rebuild(extra=tuple(extra))
                if j < len(records):  # the growth record fencing the epoch
                    self.rep.apply(records[j][2])
                    j += 1
                i = j
        self.seq = records[-1][0]
        self._nv_bound = max(self._nv_bound, max(nv for _s, nv, _p in records))
        return len(records)

    # -- shard failover: online single-shard rebuild (§17) -------------
    def seal_generation(self, generation: int = 0):
        """Seal the live representation as a read-only walk generation.

        Sharded reps seal per shard with quarantine masking (§17);
        everything else goes through the ordinary §16 image seal.
        """
        return walk_image.seal_generation(self.rep, generation)

    def rebuild_shard(self, sid: int, *, stats: Optional[dict] = None) -> int:
        """Rebuild ONE quarantined shard online and reintegrate it (§17).

        restore just this shard's ``shard_{sid}.npz`` diff chain onto the
        graph's device → replay its slice of the WAL window (checkpoint
        step == wal_seq, so ``replay(after=step)`` is exactly the window)
        through the shard's fused ``slot_update`` path → replay the
        quarantine-era spool → audit → atomic ``reintegrate``.  The rest of
        the graph keeps serving throughout — nothing here touches a
        healthy shard.

        Replay double-applies the records the shard already saw live
        before the fault; the canonical op stream is last-op-wins per
        (src, dst) key, so the double-apply converges.  A growth record in
        the window means the layout was re-sharded globally — single-shard
        rebuild is unsound then and :class:`ShardDownError` directs the
        caller to a full ``recover()``.  Returns the number of WAL records
        replayed.

        On a mesh every rank calls it: the owning rank restores, replays and
        swaps its shard in, and every rank gets its outcome (the record
        count, or its error) and takes the shard back.
        """
        if not self._sharded:
            raise TypeError("rebuild_shard: single-device rep has no shards")
        rep = self.rep
        sid = int(sid)
        if sid not in rep.down:
            raise ValueError(f"rebuild_shard: shard {sid} is not quarantined")
        if self.mesh is None:
            records, t0, t1 = self._rebuild_held(sid)
        else:
            records, t0, t1 = self.mesh.settle(lambda: self._rebuild_held(sid), on=sid)[sid]
            rep.down.discard(sid)
            rep._placed = None
        if self.diff:
            # replay applies were not dirty-tracked: the next differential
            # checkpoint must persist this shard in full
            d = self._dirty.setdefault(sid, _ShardDirty())
            d.full = d.touched = True
            d.rows, d.ranges = [], []
        t2 = time.perf_counter()
        if stats is not None:
            stats.update(restore_s=t1 - t0, replay_s=t2 - t1, records=records)
        return records

    def _rebuild_held(self, sid: int):
        """Restore, replay and reintegrate shard ``sid`` (held here);
        -> (records replayed, start time, restore end time)."""
        rep = self.rep
        t0 = time.perf_counter()
        arrays, step = ckpt.restore_shard_diff(self.ckpt_dir, sid)
        arrays = {k: v for k, v in arrays.items() if not k.startswith("__meta__/")}
        meta = arrays["meta"]
        if int(meta[3]) != rep.n or int(meta[4]) != rep.rows_max or int(meta[5]) != rep.n_shards:
            raise dist.ShardDownError(
                f"rebuild_shard: checkpoint layout (n={int(meta[3])}, "
                f"rows_max={int(meta[4])}, S={int(meta[5])}) predates a "
                f"global re-shard of the live graph (n={rep.n}, "
                f"rows_max={rep.rows_max}, S={rep.n_shards}) — run a "
                f"full recover()"
            )
        img = dist.image_from_state_tree(arrays, device=rep.device)
        if img.cap_e != rep.cap_e:
            raise dist.ShardDownError(
                f"rebuild_shard: checkpoint cap_e={img.cap_e} != live "
                f"cap_e={rep.cap_e} — layout re-sharded; run a full recover()"
            )
        t1 = time.perf_counter()
        records = 0
        for _seq, rec_nv, (qs, qd, qw, ql) in self.journal.replay(after=step):
            plan = updates.plan_from_canonical(qs, qd, qw, ql)
            plan.validate(num_vertices=int(rec_nv))
            records += 1
            if plan.max_insert_vertex() >= rep.n:
                raise dist.ShardDownError(
                    "rebuild_shard: growth record in the WAL window — the "
                    "graph re-sharded globally; run a full recover()"
                )
            for s2, sub in dist.route_updates(plan, rep.n_shards, rep.rows_max):
                if s2 == sid:
                    img = dist.shard_image_apply(rep, sid, img, sub)
        for sub in rep.spooled(sid):
            img = dist.shard_image_apply(rep, sid, img, sub)
        if rep.mesh is None:
            rep.reintegrate(sid, img)
        else:
            rep._swap_in(sid, img)  # the caller agrees the outcome
        return records, t0, t1

    # -- passthrough conveniences --------------------------------------
    def to_csr(self):
        if self._sharded:
            return dist.gather_csr(self.rep)
        return self.rep.to_csr()

    def reverse_walk(self, steps: int, **kw):
        return self.rep.reverse_walk(steps, **kw)

    def close(self) -> None:
        self.journal.close()
