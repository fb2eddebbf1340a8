"""Sharded walk images (DESIGN.md §14).

The port of ``repro.core.distributed``.  ``ShardedGraph`` is a thin wrapper
over per-shard ``WalkImage``s: vertices block-partition into ``n_shards``
shards (shard s
owns the contiguous range ``[s·rows_max, (s+1)·rows_max)``, the analogue of
the paper's Alg-5 per-thread partition), and each shard's edges live in its
OWN standard walk image — same packed tiles, same CP2AA/dense layout
policy, same ``kernels/slot_walk`` / ``kernels/slot_update`` programs as
the single-device path:

  * ``reverse_walk`` — ``kernels/slot_walk/sharded.make_local_walk``:
    every healthy shard runs the blocked interval step on its tiles (one
    ``tile_cumsum`` launch a shard a step on the card) and the owned
    slices join into the next frontier.
  * ``apply`` — ``route_updates`` slices a canonical ``UpdatePlan`` by
    owning shard on the host (the stream is (src, dst)-sorted, so routing
    is a searchsorted over block boundaries) and each shard patches its
    slice through its image's fused ``slot_update`` path (one
    ``merge_rows_fused`` launch a width group on the card).
  * ``gather_csr`` — reassembles a CSR from the live block prefixes,
    validating that every shard's edges sit inside its owned row range —
    a row-count mismatch raises instead of silently mis-stitching offsets.

Growth and overflow take the rebuild path every representation uses:
gather, host-apply the unapplied plans, re-shard once — this is how a
grown row (or a new vertex) relocates across a shard boundary.

**Shard failover (DESIGN.md §17).**  A shard that faults mid-walk or
mid-patch (the ``shard.walk`` / ``shard.patch`` fault points, or a real
device error) is *quarantined* instead of taking the graph down:
``quarantine`` marks it in ``down``, drains its unapplied plans into a
per-shard host spool, and every later routed update for it spools too.
Walks keep running over the surviving shards — a down shard runs no step,
so its rows read exact zeros, and ``coverage`` tells readers how much of
the vertex space the response covers.  ``reintegrate`` swaps a rebuilt
image back in (after the shard audit passes) and the next sealed
generation flips readers back to full coverage.  Silent damage is caught
by the opt-in integrity tracker (``enable_integrity``): per-buffer chunk
CRCs refreshed with each fused patch and re-verified by ``verify_shard`` /
``audit_shard`` between rounds.

**Two modes.**  With ``mesh=None`` (local mode) every shard lives on the
one device the graph was built on and one process drives them all.  With a
``launch.mesh.Mesh`` (mesh mode) there is one process a rank and one shard
a rank, as ``repro``'s ``shard_map`` puts one shard a device; but where
``repro`` is one controller over every device, the port is one program per
rank (multi-controller):

  * every rank calls every method with the same arguments in the same
    order; each holds only its own shard's image, on ``mesh.device``
    (``shards[s]`` is None for the others), and computes the host geometry
    (``rows_max``, ``cap_e``, the dense policy, ``route_updates``)
    identically from the same CSR and plans;
  * a decision one rank takes from its own shard (an overflow, a
    ``shard.patch`` or ``shard.walk`` fault, an audit failure) is agreed
    before any rank acts on it — one ``all_reduce`` MAX of a per-shard flag
    vector, or ``Mesh.settle`` — so every rank quarantines the same shards,
    re-shards together or raises the same :class:`ShardFaultError`;
  * the walk's frontier exchange is ``make_sharded_walk``'s all_gather;
    ``gather_csr`` and the re-shard gather every shard's edges to every
    rank; checkpoints write one ``shard_{s}.npz`` a rank under the same
    step manifest local mode writes.

Model sharding (DTensor over a ``DeviceMesh``) is not this module's: it is
``models.sharding_utils`` and ``launch.shardings``.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np
import torch

from . import alloc, csr as csr_mod, updates as upd_mod, util, walk_image
from ..runtime import faultinject as _fi

SENTINEL = util.SENTINEL

#: Device buffers covered by the per-shard integrity descriptor (the
#: host geometry hashes as one combined digest — see _shard_crc_table).
_INTEGRITY_BUFS = ("dst", "wgt", "rows")


class ShardFaultError(RuntimeError):
    """One shard failed (device loss mid-walk/patch, audit violation).

    Carries ``sid`` so the serving layer can quarantine exactly the
    failed shard and keep the rest of the graph live.
    """

    def __init__(self, sid: int, stage: str, detail: str = ""):
        msg = f"shard {sid} fault during {stage}"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
        self.sid = int(sid)
        self.stage = stage
        self.detail = detail

    def __reduce__(self):  # a mesh hands it to every rank
        return type(self), (self.sid, self.stage, self.detail)


class ShardIntegrityError(ShardFaultError):
    """A shard's content no longer matches its maintained CRC descriptor
    (silent corruption — bit rot, a misbehaving device)."""


class ShardDownError(RuntimeError):
    """The operation needs every shard but shards are quarantined
    (vertex growth, global gather/rebuild, checkpointing)."""


def _check_mesh(mesh, n_shards: Optional[int], where: str) -> None:
    """``mesh`` is None or a ``launch.mesh.Mesh`` of ``n_shards`` ranks."""
    if mesh is None:
        return
    from ..launch.mesh import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"{where}: mesh must be None or a repro_torch.launch.mesh.Mesh, "
                        f"got {type(mesh).__name__}")
    if n_shards is not None and mesh.size != n_shards:
        raise ValueError(f"{where}: mesh device count != n_shards "
                         f"({mesh.size} ranks, {n_shards} shards)")


def _placement(mesh, device) -> torch.device:
    """The device a graph's shards live on: ``device`` (the card unless the
    caller asks for the CPU) in local mode, ``mesh.device`` on a mesh."""
    if mesh is None:
        return util.resolve_device("cuda" if device is None else device)
    if device is not None:
        want = torch.device(device)
        if want.type != mesh.device.type or want.index not in (None, mesh.device.index):
            raise ValueError(f"device {str(device)!r} is not this rank's mesh device "
                             f"{mesh.device}")
    return mesh.device


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A private host copy of a tensor (never a view of a CPU tensor)."""
    return t.detach().to("cpu", copy=True).numpy()


def _shard_crc_table(img) -> dict:
    """Integrity descriptor of one shard: live-extent counts + per-buffer
    chunk CRCs over the full device payload + one digest of the host
    block geometry.  Chunking matches the checkpoint manifests
    (``checkpoint.manager.CHUNK_BYTES``) so a mismatch names the damaged
    chunk directly; the same state gives ``repro``'s table."""
    from ..checkpoint.manager import _byte_view, _chunk_crcs

    table = {
        k: _chunk_crcs(_byte_view(util.host(getattr(img, k))))
        for k in _INTEGRITY_BUFS
    }
    geom = 0
    for k in ("starts", "caps", "degs"):
        geom = zlib.crc32(np.ascontiguousarray(getattr(img, k)).tobytes(), geom)
    table["geom"] = geom
    table["live"] = int(img.live)
    table["bump"] = int(img.bump)
    return table


def _dense_policy(deg: np.ndarray, m: int) -> bool:
    """The §12 compaction decision, made ONCE globally so every shard
    builds the same layout."""
    caps = np.where(deg > 0, alloc.edge_capacities(deg), 0)
    total = int(caps.sum())
    return m > 0 and m < walk_image.DENSE_THRESHOLD * total


def _shard_cap(deg_s: np.ndarray, dense: bool) -> int:
    """The cap_e ``WalkImage.from_csr_arrays`` would pick for one shard."""
    if dense:
        total = int(deg_s.sum())
    else:
        total = int(np.where(deg_s > 0, alloc.edge_capacities(deg_s), 0).sum())
    return alloc.pow2_with_headroom(total, 1.0 if dense else 0.25)


@dataclasses.dataclass
class ShardedGraph:
    """Per-shard WalkImages over a block vertex partition (DESIGN.md §14).

    Every image spans the PADDED global vertex space ``v_pad =
    n_shards·rows_max`` (so visit vectors concatenate without index
    remapping — vertex ids are identical on every shard) but holds only
    its owned rows' blocks; rows outside the owned range have no block.
    """

    shards: list          # [S] WalkImage, nv == v_pad each (None: held by another rank)
    n: int                # true global vertex count (<= v_pad)
    rows_max: int         # vertices per shard block
    n_shards: int
    mesh: Optional[object] = None   # launch.mesh.Mesh; None = single-device local mode
    dense: bool = False             # global layout policy (shared by shards)
    #: bumped by every ``_rebuild`` — lets observers (the §15 dirty-block
    #: tracker) distinguish in-place per-shard patches from a global
    #: re-shard that invalidates every shard's layout
    generation: int = dataclasses.field(default=0, compare=False)
    #: quarantined shard ids (§17) — excluded from walks/patches, their
    #: routed updates spool until ``reintegrate``
    down: set = dataclasses.field(default_factory=set, compare=False)
    #: per-down-shard FIFO of routed subplans awaiting reintegration
    _spool: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)
    #: opt-in integrity descriptors {sid: crc table}; None = disabled
    _integrity: Optional[dict] = dataclasses.field(default=None, repr=False, compare=False)
    #: True on sealed generations (§16) — apply() refuses
    _frozen: bool = dataclasses.field(default=False, compare=False)
    #: the walk operands (per shard: dst, owned [lo, hi)), memoized until
    #: the next apply, quarantine, reintegration or corruption
    _placed: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        _check_mesh(self.mesh, self.n_shards, "ShardedGraph")

    def holds(self, s: int) -> bool:
        """Whether this process holds shard ``s``'s image (every shard in
        local mode, its own on a mesh)."""
        return self.mesh is None or int(s) == self.mesh.rank

    def _held(self) -> list:
        """The shard ids this process holds."""
        return list(range(self.n_shards)) if self.mesh is None else [self.mesh.rank]

    # ------------------------------------------------------------------
    @property
    def v_pad(self) -> int:
        return self.n_shards * self.rows_max

    @property
    def nv(self) -> int:
        """Walkable vertex count (serve-layer protocol: visits are [B, nv])."""
        return self.n

    @property
    def device(self) -> torch.device:
        """The device this process's shards' payload lives on."""
        return self.shards[0].device if self.mesh is None else self.mesh.device

    @property
    def coverage(self) -> float:
        """Fraction of the vertex space served by healthy shards (§17)."""
        if not self.down:
            return 1.0
        lost = sum(hi - lo for lo, hi in (self.owned_range(s) for s in self.down))
        return 1.0 - lost / max(self.n, 1)

    def down_rows(self) -> np.ndarray:
        """Vertex ids owned by quarantined shards (walk rows reading zero)."""
        if not self.down:
            return np.empty(0, np.int64)
        return np.concatenate([
            np.arange(*self.owned_range(s), dtype=np.int64) for s in sorted(self.down)
        ])

    @property
    def cap_e(self) -> int:
        return self.shards[self._held()[0]].cap_e

    @property
    def m(self) -> int:
        """Live edges over every shard (on a mesh, a collective)."""
        m = sum(int(self.shards[s].live) for s in self._held())
        return m if self.mesh is None else int(self.mesh.all_sum([m])[0])

    def owned_range(self, s: int) -> tuple[int, int]:
        return s * self.rows_max, min((s + 1) * self.rows_max, self.n)

    def edges_hi(self) -> int:
        """Largest per-shard quantized bump (shards share cap_e, so every
        shard's bound is on the same lattice; on a mesh, a collective)."""
        e = max(self.shards[s].edges_hi() for s in self._held())
        return e if self.mesh is None else int(self.mesh.all_max([e])[0])

    def _lohi(self, s: int, img):
        """Device [lo, hi) intervals of shard ``s``'s owned rows (all
        ``rows_max`` of them, pad rows included: they have no block)."""
        a, b = s * self.rows_max, (s + 1) * self.rows_max
        return walk_image.block_bounds(img.starts[a:b], img.degs[a:b], img.dst.device)

    # ------------------------------------------------------------------
    # updates: host routing + per-shard fused patches
    # ------------------------------------------------------------------
    def apply(self, plan) -> None:
        """Apply one canonical UpdatePlan across the shards.

        Width groups route host-side to the shard owning their rows and
        each shard patches its slice through the unchanged fused
        ``slot_update`` path — one ``fused_apply`` per touched shard.
        Vertex growth or a shard whose bump slack is exhausted falls back
        to ONE gather + host-apply + re-shard — the relocation path that
        can move rows across shard boundaries.

        Failover semantics (§17): a sub routed to a quarantined shard
        spools (the plan is still *accepted* — the spool replays through
        the shard's fused patch path on reintegration); a shard that
        faults during its patch is quarantined mid-call and the remaining
        shards still receive their slices, so healthy shards never diverge
        from the WAL.  Callers detect new quarantines by watching ``down``
        — apply() itself stays non-raising for patch faults.  Vertex
        growth (a global re-shard) while degraded raises
        :class:`ShardDownError`.  The graph mutates in place; returns None.

        On a mesh each rank patches its own shard; the faulted and the
        overflowing shards are agreed (one ``all_reduce`` MAX) before any
        rank quarantines or re-shards, and a quarantined shard's subplans
        spool on its own rank.
        """
        if self._frozen:
            raise RuntimeError("sealed walk generation is read-only")
        plan.validate()
        if plan.n_ops == 0:
            return
        if plan.max_insert_vertex() >= self.n:  # the same plan: the same branch on every rank
            if self.down:
                raise ShardDownError(
                    f"vertex growth needs a global re-shard but shards "
                    f"{sorted(self.down)} are quarantined — rebuild first"
                )
            self._rebuild(extra=(plan,))
            return
        faulted, failed = {}, []
        for sid, sub in route_updates(plan, self.n_shards, self.rows_max):
            if not self.holds(sid):
                continue
            if sid in self.down:
                self._spool.setdefault(sid, []).append(sub)
                continue
            img = self.shards[sid]
            try:
                _fi.fire("shard.patch")
                img.queue(sub)
                ok = img.flush()
            except Exception:
                # device fault mid-patch: THIS shard is quarantined below
                # and its sub spools exactly once; the rest keep patching
                faulted[sid] = sub
                continue
            if not ok:
                failed.append(sid)  # sub / compaction request pends on img
                continue
            if self._integrity is not None:
                self._integrity[sid] = _shard_crc_table(img)
            self._corrupt_tick(sid)
        if self.mesh is not None:
            flags = np.zeros(2 * self.n_shards, np.int64)
            flags[list(faulted)] = 1
            flags[[self.n_shards + s for s in failed]] = 1
            flags = self.mesh.all_max(flags)
            faulted = {s: faulted.get(s) for s in np.flatnonzero(flags[: self.n_shards]).tolist()}
            failed = np.flatnonzero(flags[self.n_shards:]).tolist()
        for sid, sub in sorted(faulted.items()):
            # quarantine drains the queue (flush leaves a failed sub queued)
            self.quarantine(sid)
            if self.holds(sid):
                spool = self._spool[sid]
                if not spool or spool[-1] is not sub:
                    spool.append(sub)
        self._placed = None
        if failed:
            if self.down:
                # a global re-shard is impossible while degraded: the
                # overflowing shards join the quarantine (their pending
                # plans drain into the spool) instead of wedging apply.
                for sid in failed:
                    self.quarantine(sid)
            else:
                self._rebuild()

    def _rebuild(self, extra=()) -> None:
        """Gather + host-apply unapplied plans + re-shard ONCE.

        On a mesh each rank first applies its own shard's pending subplans
        to its own edges (they touch only its rows, so the order across
        shards does not matter), then every shard's edges gather to every
        rank, the ``extra`` plans apply, and every rank re-shards from the
        same CSR.
        """
        if self.down:
            raise ShardDownError(
                f"global re-shard with shards {sorted(self.down)} "
                f"quarantined — rebuild them first"
            )
        pending = [p for s in self._held() for p in self.shards[s]._pending]
        n_new = self.n
        for p in (*pending, *extra):
            n_new = max(n_new, p.max_insert_vertex() + 1)
        if self.mesh is None:
            src, dst, wgt = (util.host(x) for x in _gather_coo(self))
            plans = [*pending, *extra]
        else:
            n_new = int(self.mesh.all_max([n_new])[0])
            own = self.mesh.rank
            coo = _settled(self.mesh, lambda: _image_coo(
                self.shards[own], *self.owned_range(own), self.n, self.v_pad, own))
            src, dst, wgt = (util.host(x) for x in coo)
            for p in pending:
                src, dst, wgt = _host_apply(src, dst, wgt, p)
            src, dst, wgt = (util.host(x) for x in _all_gather_coo(self.mesh, src, dst, wgt))
            plans = list(extra)
        for p in plans:
            src, dst, wgt = _host_apply(src, dst, wgt, p)
        dev = self.device
        c = csr_mod.from_coo(src, dst, wgt, n=n_new, dedup=False, device=dev)
        g = shard_csr(c, self.n_shards, mesh=self.mesh, dense=None, device=dev)
        self.shards = g.shards
        self.n = g.n
        self.rows_max = g.rows_max
        self.dense = g.dense
        self.generation += 1
        self._placed = None
        if self._integrity is not None:
            self.enable_integrity()

    # ------------------------------------------------------------------
    # failover: quarantine / integrity / reintegration (DESIGN.md §17)
    # ------------------------------------------------------------------
    def quarantine(self, sid: int) -> None:
        """Mark one shard down and drain its unapplied plans to the spool.

        Idempotent.  The shard's image stays in ``shards`` (walks skip it,
        so its rows read zero), its integrity entry drops (the content is
        no longer trusted), and every later routed update for it spools
        until :meth:`reintegrate`.  On a mesh every rank marks it down
        and its own rank drains and spools.
        """
        sid = int(sid)
        if not (0 <= sid < self.n_shards):
            raise ValueError(f"quarantine: no shard {sid}")
        if sid in self.down:
            return
        self.down.add(sid)
        self._placed = None
        if not self.holds(sid):
            return
        img = self.shards[sid]
        spool = self._spool.setdefault(sid, [])
        spool.extend(img._pending)
        img._pending.clear()
        img._stale = False
        if self._integrity is not None:
            self._integrity.pop(sid, None)

    def reintegrate(self, sid: int, img) -> None:
        """Atomically swap a rebuilt image in for a quarantined shard.

        The shard audit must pass on the candidate BEFORE the swap becomes
        durable: on audit failure the old (garbage) image is restored and
        the shard stays down — a reader can never observe a
        half-reintegrated shard, because readers only see the swap via the
        NEXT sealed generation.

        On a mesh every rank calls it (``img`` is read on ``sid``'s own rank
        only) and the owner's outcome is agreed: every rank raises, or
        every rank takes the shard back.
        """
        sid = int(sid)
        if sid not in self.down:
            raise ValueError(f"reintegrate: shard {sid} is not quarantined")
        if self.mesh is None:
            self._swap_in(sid, img)
        else:
            self.mesh.settle(lambda: self._swap_in(sid, img), on=sid)
            self.down.discard(sid)
            self._placed = None

    def _swap_in(self, sid: int, img) -> None:
        """Validate, swap in and audit one rebuilt image (this process
        holds ``sid``)."""
        if img.cap_e != self.cap_e or int(img.nv) != self.v_pad:
            raise ValueError(
                f"reintegrate: shard {sid} image layout (cap_e={img.cap_e}, "
                f"nv={img.nv}) != graph layout (cap_e={self.cap_e}, "
                f"nv={self.v_pad})"
            )
        if img.dst.device != self.device:
            raise ValueError(
                f"reintegrate: shard {sid} image is on {img.dst.device}, "
                f"the graph on {self.device}"
            )
        old = self.shards[sid]
        self.shards[sid] = img
        self.down.discard(sid)
        try:
            self._audit_held(sid, verify=False)
        except Exception:
            self.shards[sid] = old
            self.down.add(sid)
            raise
        self._spool.pop(sid, None)
        if self._integrity is not None:
            self._integrity[sid] = _shard_crc_table(img)
        self._placed = None

    def spooled(self, sid: int) -> list:
        """The quarantine-window FIFO of routed subplans for one shard."""
        return list(self._spool.get(int(sid), ()))

    def enable_integrity(self) -> None:
        """Start maintaining per-shard CRC descriptors (§17 detection).

        Each successful fused patch refreshes its shard's table, so any
        out-of-band mutation (bit rot, a buggy kernel, ``shard.corrupt``
        injection) is caught by the next :meth:`verify_shard` /
        :meth:`audit_shard`.  Opt-in: hashing copies the device payload
        to the host.
        """
        self._integrity = {
            s: _shard_crc_table(self.shards[s])
            for s in self._held()
            if s not in self.down
        }

    def _on_owner(self, sid: int, fn):
        """``fn()`` where shard ``sid`` is held; on a mesh a collective that
        hands the owner's result (or its exception) to every rank."""
        if self.mesh is None:
            return fn()
        return self.mesh.settle(fn, on=int(sid))[int(sid)]

    def shard_descriptor(self, sid: int) -> dict:
        """Current integrity descriptor of one shard (seal/checkpoint
        callers persist this next to the payload)."""
        return self._on_owner(sid, lambda: _shard_crc_table(self.shards[int(sid)]))

    def verify_shard(self, sid: int) -> None:
        """Recompute one shard's descriptor against the maintained table.

        Raises :class:`ShardIntegrityError` naming the damaged buffers and
        chunk indices.  No-op when integrity tracking is off; a shard with
        no entry yet (fresh reintegration) is seeded.  On a mesh the owner
        verifies and every rank gets its outcome.
        """
        self._on_owner(sid, lambda: self._verify_held(int(sid)))

    def _verify_held(self, sid: int) -> None:
        if self._integrity is None:
            return
        img = self.shards[sid]
        want = self._integrity.get(sid)
        if want is None:
            self._integrity[sid] = _shard_crc_table(img)
            return
        got = _shard_crc_table(img)
        if got == want:
            return
        bad = []
        for k in _INTEGRITY_BUFS:
            if len(want[k]) != len(got[k]):
                bad.append(f"{k}: chunk count {len(want[k])} -> {len(got[k])}")
                continue
            chunks = [i for i, (a, b) in enumerate(zip(want[k], got[k])) if a != b]
            if chunks:
                bad.append(f"{k}: chunks {chunks[:4]}")
        for k in ("geom", "live", "bump"):
            if want[k] != got[k]:
                bad.append(f"{k}: {want[k]} -> {got[k]}")
        raise ShardIntegrityError(sid, "integrity", "; ".join(bad) or "descriptor mismatch")

    def audit_shard(self, sid: int, *, verify: bool = True) -> dict:
        """One shard's structural audit + stray-row pass + CRC verify (on a
        mesh the owner audits and every rank gets its outcome)."""
        sid = int(sid)
        if sid in self.down:
            raise ShardDownError(f"audit_shard: shard {sid} is quarantined")
        return self._on_owner(sid, lambda: self._audit_held(sid, verify=verify))

    def _audit_held(self, sid: int, *, verify: bool = True) -> dict:
        img = self.shards[sid]
        report = img.audit()
        lo_v, hi_v = self.owned_range(sid)
        degs = np.asarray(img.degs[: self.v_pad], np.int64)
        stray = degs.copy()
        stray[lo_v:hi_v] = 0
        if stray.any():
            raise ShardFaultError(
                sid, "audit",
                f"edges on non-owned rows {np.nonzero(stray)[0][:8].tolist()}",
            )
        if verify:
            self._verify_held(sid)
        return report

    def _corrupt_tick(self, sid: int) -> None:
        """``shard.corrupt`` fault point: after a successful patch,
        silently flip a live weight on this shard — no exception escapes
        (that is the point: only the integrity pass can see it)."""
        try:
            _fi.fire("shard.corrupt")
        except _fi.InjectedKernelError:
            from ..runtime import failover

            failover.corrupt_shard(self, sid, kind="wgt")

    def seal_generation(self, generation: int = 0) -> "ShardedGraph":
        """Seal the graph as one read-only generation (§16/§17).

        Every healthy shard seals O(1) via :meth:`WalkImage.seal` (the
        live images turn copy-on-write, so the next patch or corruption
        of a shard copies its payload before writing); quarantined shards
        keep their live reference but stay masked — the generation's
        ``coverage`` and ``down_rows`` tell readers exactly what the walk
        covers.
        """
        sealed = [
            img if s in self.down or img is None else img.seal(generation)
            for s, img in enumerate(self.shards)
        ]
        return ShardedGraph(
            shards=sealed, n=self.n, rows_max=self.rows_max,
            n_shards=self.n_shards, mesh=self.mesh, dense=self.dense,
            generation=self.generation, down=set(self.down), _frozen=True,
        )

    def block_on(self) -> None:
        """Barrier: wait for the device work queued on every shard."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # traversal: per-shard steps, frontier join
    # ------------------------------------------------------------------
    def _assemble(self):
        """(dsts, los, his) walk operands, memoized until the next apply.

        Per shard its own ``dst`` buffer (no stacked copy of the payload)
        and the device intervals of its owned rows; a quarantined shard
        contributes ``None`` and runs no step.
        """
        if self._placed is not None:
            return self._placed
        dsts, los, his = [], [], []
        for s, img in enumerate(self.shards):
            if s in self.down or img is None:
                dsts.append(None)
                los.append(None)
                his.append(None)
                continue
            lo, hi = self._lohi(s, img)
            dsts.append(img.dst)
            los.append(lo)
            his.append(hi)
        self._placed = (dsts, los, his)
        return self._placed

    def reverse_walk(self, steps: int, *, visits0=None, backend: str = "auto"):
        """k-step reverse walk; [n] (or [B, n] with ``visits0`` [B, n]).

        Unweighted visit counts are exact small integers in f32 on small
        graphs, so the sharded and the single-device WalkImage walks (and
        ``repro``'s) agree bit for bit there.  ``backend`` picks the
        intra-tile level as every walk does (``auto``: the ``tile_cumsum``
        kernel for CUDA tensors, its plain version for CPU tensors).

        Quarantined shards are masked out (their rows read exact zeros);
        a healthy shard that faults here raises :class:`ShardFaultError`
        carrying its ``sid`` so the serving layer can quarantine it and
        retry degraded instead of failing the batch.

        On a mesh (every rank calls it with the same arguments) each rank
        checks its own shard's ``shard.walk`` point and the faults are agreed
        before the first exchange: every rank raises the lowest faulted
        shard's :class:`ShardFaultError`.  Each rank steps its own shard and
        all_gathers the frontier (``make_sharded_walk``); the result is on
        every rank.
        """
        from ..kernels.slot_walk import sharded as _sw

        fault = None
        for s in self._held():
            if s in self.down:
                continue
            try:
                _fi.fire("shard.walk")
            except Exception as e:
                fault = ShardFaultError(s, "walk", str(e))
                fault.__cause__ = e
                break
        if self.mesh is not None:
            flags = np.zeros(self.n_shards, np.int64)
            if fault is not None:
                flags[fault.sid] = 1
            bad = np.flatnonzero(self.mesh.all_max(flags))
            if bad.size and (fault is None or fault.sid != int(bad[0])):
                fault = ShardFaultError(int(bad[0]), "walk", f"on rank {int(bad[0])}")
        if fault is not None:
            raise fault
        dev = self.device
        backend = util.resolve_backend(backend, dev)
        nwalks = 0
        if visits0 is not None:
            if visits0.ndim != 2 or visits0.shape[1] != self.n:
                raise ValueError(
                    f"visits0 must be [num_walks, {self.n}], got {tuple(visits0.shape)}"
                )
            nwalks = int(visits0.shape[0])
        vis = torch.ones((max(nwalks, 1), self.v_pad), dtype=torch.float32, device=dev)
        if visits0 is not None:
            # pad rows keep 1.0 — no edge ever references them, so their
            # value is unobservable and trimmed from the result
            vis[:, : self.n] = torch.as_tensor(visits0, dtype=torch.float32, device=dev)
        dsts, los, his = self._assemble()
        if self.mesh is None:
            e_his = tuple(img.edges_hi() for img in self.shards)
            fn = _sw.make_local_walk(
                steps, self.n_shards, self.rows_max, self.cap_e, e_his, nwalks, backend
            )
            out = fn(dsts, los, his, vis)
        else:
            own = self.mesh.rank
            e_hi = 0 if own in self.down else self.shards[own].edges_hi()
            fn = _sw.make_sharded_walk(
                self.mesh, steps, self.n_shards, self.rows_max, self.cap_e, e_hi, nwalks,
                backend,
            )
            out = fn(dsts[own], los[own], his[own], vis)
        walk_image.STATS["dispatches"] += 1
        out = out[:, : self.n]
        return out[0] if visits0 is None else out

    def walk(self, steps: int, *, visits0=None, backend: str = "auto"):
        """WalkImage-protocol alias (serve-layer dispatch target)."""
        return self.reverse_walk(steps, visits0=visits0, backend=backend)

    def collective_bytes_per_step(self, steps: int, *, nwalks: int = 0) -> int:
        """Collective bytes a rank receives per walk step: 0 in local mode
        (the emulation exchanges nothing); on a mesh, what the exchange
        counter read over a ``steps``-step walk of ``nwalks`` rows this call
        runs (a collective: every rank calls it)."""
        from ..kernels.slot_walk import sharded as _sw

        if self.mesh is None:
            return 0
        before = _sw.EXCHANGE["bytes"]
        v0 = None
        if nwalks:
            v0 = torch.ones((nwalks, self.n), dtype=torch.float32, device=self.device)
        self.reverse_walk(steps, visits0=v0)
        return (_sw.EXCHANGE["bytes"] - before) // max(steps, 1)

    # ------------------------------------------------------------------
    # checkpoint: one file per shard under a shared step manifest
    # ------------------------------------------------------------------
    def state_trees(self) -> dict:
        """{shard_id: flat state dict} — the sharded checkpoint payload
        (host copies; ``repro``'s keys, dtypes and meta layout).  On a mesh,
        this rank's own shard only."""
        if self.down:
            raise ShardDownError(
                f"state_trees: shards {sorted(self.down)} are quarantined — "
                f"a checkpoint would persist garbage; rebuild first"
            )
        out = {}
        for s in self._held():
            img = self.shards[s]
            out[s] = {
                "dst": _host_copy(img.dst),
                "wgt": _host_copy(img.wgt),
                "rows": _host_copy(img.rows),
                "starts": np.array(img.starts, np.int64),
                "caps": np.array(img.caps, np.int64),
                "degs": np.array(img.degs, np.int64),
                "meta": np.asarray(
                    [img.nv, img.bump, img.live, self.n, self.rows_max,
                     self.n_shards, int(self.dense)],
                    np.int64,
                ),
            }
        return out

    def save(self, ckpt_dir: str, step: int, *, keep: int = 3) -> str:
        """One step directory: a ``shard_{s}.npz`` a shard under one
        manifest (on a mesh each rank writes its own, rank 0 the manifest)."""
        from ..checkpoint import manager as ckpt

        if self.mesh is None:
            return ckpt.save_arrays_sharded(ckpt_dir, step, self.state_trees(), keep=keep)
        return ckpt.save_arrays_mesh(ckpt_dir, step, self.mesh,
                                     self.state_trees()[self.mesh.rank], keep=keep)

    @classmethod
    def restore(cls, ckpt_dir: str, *, step: Optional[int] = None, mesh=None,
                device=None) -> "ShardedGraph":
        """Restore a sharded step manifest onto ``device`` (the card unless
        the caller asks for the CPU), every shard serially; on a mesh each
        rank reads its own shard's file of the same step (the newest, or
        ``step``) onto ``mesh.device``."""
        from ..checkpoint import manager as ckpt

        _check_mesh(mesh, None, "ShardedGraph.restore")
        dev = _placement(mesh, device)
        if mesh is None:
            trees, _step = ckpt.restore_arrays_sharded(ckpt_dir, step=step)
        else:
            step, n_shards = ckpt.step_shards(ckpt_dir, step)
            _check_mesh(mesh, n_shards, "ShardedGraph.restore")
            trees = _settled(mesh, lambda: {mesh.rank: ckpt.restore_arrays(
                ckpt_dir, step=step, shard_id=mesh.rank)[0]})
        return cls.from_state_trees(trees, mesh=mesh, device=dev)

    @classmethod
    def from_state_trees(cls, trees: dict, *, mesh=None, device=None) -> "ShardedGraph":
        """Rebuild the graph on ``device`` (the card unless the caller asks
        for the CPU) from ``state_trees()`` dicts (either package's, either
        mode's).  On a mesh ``trees`` needs only this rank's shard."""
        _check_mesh(mesh, None, "ShardedGraph.from_state_trees")
        dev = _placement(mesh, device)
        any_meta = next(iter(trees.values()))["meta"]
        n, rows_max, n_shards, dense = (
            int(any_meta[3]), int(any_meta[4]), int(any_meta[5]), bool(any_meta[6]),
        )
        if mesh is None:
            if sorted(trees) != list(range(n_shards)):
                raise ValueError(
                    f"sharded restore: have shards {sorted(trees)}, "
                    f"manifest says n_shards={n_shards}"
                )
            shards = [image_from_state_tree(trees[s], device=dev) for s in range(n_shards)]
        else:
            _check_mesh(mesh, n_shards, "ShardedGraph.from_state_trees")
            if mesh.rank not in trees:
                raise ValueError(f"sharded restore: no shard {mesh.rank} for rank {mesh.rank} "
                                 f"(have {sorted(trees)})")
            shards = [None] * n_shards
            shards[mesh.rank] = image_from_state_tree(trees[mesh.rank], device=dev)
        return cls(shards=shards, n=n, rows_max=rows_max, n_shards=n_shards, mesh=mesh,
                   dense=dense)

    def audit(self) -> dict:
        """Per-shard image audits plus the cross-shard boundary pass.

        Quarantined shards are skipped (their content is untrusted by
        definition) and reported in ``down`` — a degraded graph audits
        clean on its healthy part instead of tripping on garbage.  On a
        mesh each rank audits its own shard and every rank returns every
        shard's report (or raises the lowest failing shard's error).
        """
        def own(s):
            return None if s in self.down else self._audit_held(s)

        if self.mesh is None:
            reports = [own(s) for s in range(self.n_shards)]
        else:
            reports = self.mesh.settle(lambda: own(self.mesh.rank))
        return {"shards": reports, "m": self.m, "down": sorted(self.down)}


# ---------------------------------------------------------------------------
# construction / routing / gathering
# ---------------------------------------------------------------------------
def shard_csr(
    c: csr_mod.CSR,
    n_shards: int,
    *,
    mesh=None,
    dense: Optional[bool] = None,
    device=None,
) -> ShardedGraph:
    """Partition a CSR into per-shard WalkImages on a block vertex layout,
    every shard on ``device`` (the card unless the caller asks for the CPU).

    All shards share one cap_e (``min_cap_e`` floors each build at the
    largest shard's natural capacity), as in ``repro``, so a rebuilt shard
    can always be swapped in for another of the same graph.  On a mesh
    every rank passes the same CSR and builds only its own shard, on
    ``mesh.device``.
    """
    _check_mesh(mesh, None, "shard_csr")
    dev = _placement(mesh, device)
    if n_shards < 1:
        raise ValueError(f"shard_csr: n_shards must be >= 1, got {n_shards}")
    if c.n < n_shards:
        raise ValueError(f"shard_csr: need n >= n_shards, got n={c.n}, S={n_shards}")
    _check_mesh(mesh, n_shards, "shard_csr")
    rows_max = -(-c.n // n_shards)
    v_pad = n_shards * rows_max
    o = util.host(c.offsets).astype(np.int64)
    deg = np.diff(o)
    if dense is None:
        dense = _dense_policy(deg, int(c.m))

    deg_full = np.zeros(v_pad, np.int64)
    deg_full[: c.n] = deg
    cap_shared = max(
        _shard_cap(deg_full[s * rows_max:(s + 1) * rows_max], dense)
        for s in range(n_shards)
    )
    shards = [None] * n_shards
    for s in range(n_shards) if mesh is None else (mesh.rank,):
        lo_v = s * rows_max
        hi_v = min((s + 1) * rows_max, c.n)
        deg_s = np.zeros(v_pad, np.int64)
        if hi_v > lo_v:
            deg_s[lo_v:hi_v] = deg[lo_v:hi_v]
        offsets_s = np.concatenate([[0], np.cumsum(deg_s)])
        e0, e1 = (int(o[lo_v]), int(o[hi_v])) if hi_v > lo_v else (0, 0)
        w = (
            c.wgt[e0:e1].to(dev, torch.float32)
            if c.wgt is not None
            else torch.ones(e1 - e0, dtype=torch.float32, device=dev)
        )
        shards[s] = walk_image.WalkImage.from_csr_arrays(
            offsets_s, c.dst[e0:e1].to(dev), w, v_pad,
            device=dev, dense=dense, min_cap_e=cap_shared,
        )
    return ShardedGraph(
        shards=shards, n=int(c.n), rows_max=rows_max, n_shards=n_shards, mesh=mesh,
        dense=bool(dense),
    )


def route_updates(plan, n_shards: int, rows_max: int):
    """Slice a canonical UpdatePlan by owning shard: [(shard_id, subplan)].

    The op stream is (src, dst)-sorted, so each shard's ops are one
    contiguous slice — routing is a searchsorted over the block
    boundaries, zero re-sort, and every slice is itself canonical
    (strictly increasing keys), so ``plan_from_canonical`` rebuilds the
    per-shard run structure byte-identically to a locally-planned batch.
    Ops beyond the padded vertex space land on the last shard, where the
    image's own row-range filter drops them.
    """
    bounds = np.arange(1, n_shards, dtype=np.int64) * rows_max
    cuts = np.searchsorted(plan.q_src, bounds, side="left")
    idx = np.concatenate([[0], cuts, [plan.n_ops]]).astype(np.int64)
    out = []
    for s in range(n_shards):
        a, b = int(idx[s]), int(idx[s + 1])
        if a == b:
            continue
        out.append((
            s,
            upd_mod.plan_from_canonical(
                plan.q_src[a:b], plan.q_dst[a:b], plan.q_wgt[a:b], plan.q_del[a:b],
            ),
        ))
    return out


def _image_coo(img, lo_v: int, hi_v: int, n: int, v_pad: int, sid: int):
    """One shard's live (src, dst, wgt) tensors from its block prefixes,
    gathered on the image's device and validated.

    Slack slots drop by construction (only ``deg`` slots per row are
    read).  Edges on rows the shard does not own, or destination ids
    outside ``[0, n)``, raise — silent mis-stitching of the reassembled
    offsets is exactly the failure mode this guards.
    """
    degs = np.asarray(img.degs[:v_pad], np.int64)
    stray = degs.copy()
    stray[lo_v:hi_v] = 0
    if stray.any():
        bad = np.nonzero(stray)[0][:8].tolist()
        raise ValueError(
            f"gather_csr: shard {sid} owns rows [{lo_v}, {hi_v}) but "
            f"carries edges on rows {bad} — shard row-count mismatch"
        )
    dev = img.dst.device
    dg = degs[lo_v:hi_v]
    m_s = int(dg.sum())
    if m_s == 0:
        z = torch.empty(0, dtype=torch.int64, device=dev)
        return z, z.clone(), torch.empty(0, dtype=torch.float32, device=dev)
    starts = np.asarray(img.starts[lo_v:hi_v], np.int64)
    first = np.cumsum(dg) - dg
    dg_t = torch.from_numpy(dg).to(dev)
    gidx = torch.repeat_interleave(
        torch.from_numpy(starts - first).to(dev), dg_t, output_size=m_s
    ) + torch.arange(m_s, dtype=torch.int64, device=dev)
    d = img.dst[gidx]
    if bool(((d == int(SENTINEL)) | (d >= n)).any()):
        raise ValueError(
            f"gather_csr: shard {sid} live prefix holds destination ids "
            f"outside [0, {n}) — shard row-count mismatch"
        )
    src = torch.repeat_interleave(
        torch.arange(lo_v, hi_v, dtype=torch.int64, device=dev), dg_t, output_size=m_s
    )
    return src, d.to(torch.int64), img.wgt[gidx].to(torch.float32)


def _settled(mesh, fn):
    """``fn()`` on every rank with its failure agreed (every rank raises the
    lowest failing rank's error); this rank's own result, kept local."""
    box = []
    mesh.settle(lambda: box.append(fn()))
    return box[0]


def _all_gather_coo(mesh, src, dst, wgt):
    """Every rank's (src, dst, wgt) edges, concatenated in rank order, on
    every rank: one all_gather of ``[3, k]`` int32 words (the weights'
    bits), padded to the largest rank's count."""
    dev = mesh.device
    own = torch.stack([
        torch.as_tensor(src, device=dev).to(torch.int32),
        torch.as_tensor(dst, device=dev).to(torch.int32),
        torch.as_tensor(wgt, dtype=torch.float32, device=dev).view(torch.int32),
    ])
    counts = mesh.gather_objects(int(own.shape[1]))
    width = max(max(counts), 1)
    buf = torch.zeros((3, width), dtype=torch.int32, device=dev)
    buf[:, : own.shape[1]] = own
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    torch.distributed.all_gather(parts, buf, group=mesh.group)
    words = torch.cat([p[:, :k] for p, k in zip(parts, counts)], dim=1)
    return words[0].to(torch.int64), words[1].to(torch.int64), words[2].view(torch.float32)


def _gather_coo(g: ShardedGraph):
    """Live (src, dst, wgt) tensors from every shard's block prefixes (on a
    mesh, a collective: every rank gets every shard's edges)."""
    if g.down:
        raise ShardDownError(
            f"gather: shards {sorted(g.down)} are quarantined — a global "
            f"gather would stitch garbage; rebuild first"
        )
    if g.mesh is not None:
        own = g.mesh.rank
        coo = _settled(g.mesh, lambda: _image_coo(g.shards[own], *g.owned_range(own), g.n,
                                                  g.v_pad, own))
        return _all_gather_coo(g.mesh, *coo)
    parts = [_image_coo(img, *g.owned_range(s), g.n, g.v_pad, s)
             for s, img in enumerate(g.shards)]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def gather_csr(g: ShardedGraph) -> csr_mod.CSR:
    """Collect the sharded graph back into a CSR on its device (on a mesh,
    the whole CSR on every rank)."""
    src, dst, wgt = _gather_coo(g)
    return csr_mod.from_coo(src, dst, wgt, n=g.n, dedup=False, device=g.device)


def _host_apply(src, dst, wgt, plan):
    """Apply one canonical plan to host COO arrays (the rebuild path).

    Keys touched by the plan (either op kind) drop from the old stream —
    an insert replaces, a delete removes — then the plan's inserts
    append.  ``from_coo`` re-sorts afterwards.
    """
    src, dst, wgt = np.asarray(src), np.asarray(dst), np.asarray(wgt)
    keys = (src.astype(np.int64) << 32) | dst.astype(np.int64)
    pk = (plan.q_src.astype(np.int64) << 32) | plan.q_dst.astype(np.int64)
    pos = np.searchsorted(pk, keys)
    pos_c = np.minimum(pos, max(pk.shape[0] - 1, 0))
    hit = (pos < pk.shape[0]) & (pk[pos_c] == keys) if pk.shape[0] else (
        np.zeros(keys.shape[0], bool)
    )
    ins = ~plan.q_del
    return (
        np.concatenate([src[~hit], plan.q_src[ins].astype(np.int64)]),
        np.concatenate([dst[~hit], plan.q_dst[ins].astype(np.int64)]),
        np.concatenate([wgt[~hit], plan.q_wgt[ins]]).astype(np.float32),
    )


def image_from_state_tree(t: dict, *, device="cuda") -> walk_image.WalkImage:
    """Build ONE shard's WalkImage on ``device`` from its flat checkpoint
    state dict (either package's).

    The single-shard slice of :meth:`ShardedGraph.from_state_trees` — the
    §17 online rebuild restores exactly one shard this way and replays its
    WAL window into it before reintegration.
    """
    dev = util.resolve_device(device)
    nv, bump, live = int(t["meta"][0]), int(t["meta"][1]), int(t["meta"][2])

    def payload(key, dtype):
        return torch.from_numpy(np.array(t[key], dtype=dtype)).to(dev)

    return walk_image.WalkImage(
        dst=payload("dst", np.int32), wgt=payload("wgt", np.float32),
        rows=payload("rows", np.int32),
        starts=np.array(t["starts"], np.int64),
        caps=np.array(t["caps"], np.int64),
        degs=np.array(t["degs"], np.int64),
        nv=nv, bump=bump, live=live,
        base_occupancy=live / max(bump, 1),
    )


def shard_image_apply(g: ShardedGraph, sid: int, img, sub):
    """Apply one routed subplan to a standalone (not-yet-reintegrated)
    shard image through the same fused ``slot_update`` path the live graph
    uses; returns the image (possibly repacked).

    Overflow/compaction cannot take the global re-shard (the graph is
    degraded — that is why this image exists): the shard repacks ALONE at
    the shared ``cap_e``, falling back to the §12 dense layout (occupancy
    1.0 — the minimal footprint) when the policy layout's slack no longer
    fits.  If even the dense repack exceeds the shared capacity the
    single-shard rebuild is impossible and :class:`ShardDownError` directs
    the caller to a full ``recover()``.  The patch goes through the
    image's own copy-on-write, so a generation sealed from it keeps its
    buffers.
    """
    img.queue(sub)
    if img.flush():
        return img
    lo_v, hi_v = g.owned_range(sid)
    pending = list(img._pending)
    img._pending.clear()
    img._stale = False
    src, dst, wgt = (util.host(x) for x in _image_coo(img, lo_v, hi_v, g.n, g.v_pad, sid))
    for p in pending:
        src, dst, wgt = _host_apply(src, dst, wgt, p)
    dev = img.dst.device
    c = csr_mod.from_coo(src, dst, wgt, n=g.v_pad, dedup=False, device=dev)
    offs = util.host(c.offsets).astype(np.int64)
    dsts = c.dst[: c.m]
    wgts = (
        c.wgt[: c.m] if c.wgt is not None
        else torch.ones(c.m, dtype=torch.float32, device=dev)
    )
    new = walk_image.WalkImage.from_csr_arrays(
        offs, dsts, wgts, g.v_pad, device=dev, dense=g.dense, min_cap_e=g.cap_e,
    )
    if new.cap_e != g.cap_e and not g.dense:
        new = walk_image.WalkImage.from_csr_arrays(
            offs, dsts, wgts, g.v_pad, device=dev, dense=True, min_cap_e=g.cap_e,
        )
    if new.cap_e > g.cap_e and int(new.bump) <= g.cap_e:
        # the build's pow-2 bump reserve overshot the shared capacity but
        # the slots themselves fit: trim to the graph's shared shape (the
        # shard just has less relocation slack than policy — the next
        # overflow takes the healthy-graph global re-shard)
        new.dst = new.dst[: g.cap_e].clone()
        new.wgt = new.wgt[: g.cap_e].clone()
        new.rows = new.rows[: g.cap_e].clone()
    if new.cap_e != g.cap_e:
        raise ShardDownError(
            f"shard {sid} outgrew the shared cap_e ({new.cap_e} > "
            f"{g.cap_e}) during single-shard rebuild — the graph needs a "
            f"global re-shard; run a full recover()"
        )
    return new


def reverse_walk(g: ShardedGraph, steps: int, *, visits0=None, backend: str = "auto"):
    """Module-level convenience wrapper over ``ShardedGraph.reverse_walk``."""
    return g.reverse_walk(steps, visits0=visits0, backend=backend)
