"""The rank mesh of the multi-device walk (DESIGN.md §14), one process a rank.

The port of ``repro.launch.mesh``'s ``host_mesh`` / ``data_axes``.  ``repro``
is single-controller: one process drives every device of a 1-D ``("data",)``
mesh through ``shard_map``.  The port is multi-controller: one process a
rank, each holding one shard, all running the same program and meeting in
``torch.distributed`` collectives.  ``shard_map_compat`` has no counterpart
here: the per-rank program IS the shard_map body.

* :class:`Mesh` — this rank's view of the mesh: the process group, its
  rank, the rank count, its device and the transport (``backend``), with the
  small collectives the sharded graph agrees through (:meth:`Mesh.settle`,
  :meth:`Mesh.all_max`).
* :func:`host_mesh` — the mesh over the first ``n`` ranks of the process
  group this process joined.
* :func:`run_ranks` — start ``n`` rank processes (spawned: a parent that
  already holds a CUDA context must not fork), rendezvous them through a
  ``file://`` store and join them with a deadline, so a mismatched
  collective fails instead of hanging.
* :class:`Channel` — rank 0's ordered stream of op headers to the other
  ranks, and the agreement that ends each op: how one process that sees the
  requests (``runtime.serve.WalkServer`` on rank 0) makes every rank enter
  the same collectives in the same order.

The transport follows from the topology (:func:`transport`): ``"nccl"``
when each rank has its own card, ``"gloo"`` when ranks share a card or run
on the CPU.  Nothing retries one on the failure of the other.

Model sharding runs on an N-D ``torch.distributed`` ``DeviceMesh`` instead
(``models.sharding_utils``, ``launch.shardings``):

* :func:`make_production_mesh` — ``repro``'s 16×16 ``("data", "model")``
  pod, or 2×16×16 ``("pod", "data", "model")``;
* :func:`make_mesh_like` — any (shape, axes) over the process group this
  process joined: the 4 real ranks of ``run_ranks`` as ``(2, 2)``, or a
  fake process group of 256 / 512 ranks in the dry run
  (``launch.dryrun``).

:func:`data_axes` reads either kind of mesh.
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

#: Seconds a collective may wait for its peers before it fails.
DEFAULT_TIMEOUT_S = 120


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D ``("data",)`` mesh of ranks."""

    group: Any
    rank: int
    size: int
    device: torch.device
    backend: str
    axis_names: tuple = ("data",)

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order, on every rank."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def _all_reduce(self, values, op) -> np.ndarray:
        t = torch.as_tensor(np.asarray(values, np.int64), device=self.device)
        dist.all_reduce(t, op=op, group=self.group)
        return t.cpu().numpy()

    def all_max(self, values) -> np.ndarray:
        """Element-wise MAX of an integer vector (a flag vector) over the ranks."""
        return self._all_reduce(values, dist.ReduceOp.MAX)

    def all_sum(self, values) -> np.ndarray:
        """Element-wise sum of an integer vector over the ranks."""
        return self._all_reduce(values, dist.ReduceOp.SUM)

    def settle(self, fn, *, on: Optional[int] = None) -> list:
        """Run ``fn()`` (on every rank, or only on rank ``on``) and agree on
        the outcome: every rank's result in rank order, or on every rank the
        exception of the lowest rank that raised.

        This is the rule every branch of a mesh-mode method keeps: a
        decision one rank takes from its own shard is agreed before any rank
        acts on it, so no rank enters a collective its peers skip.
        """
        res, exc = None, None
        if on is None or on == self.rank:
            try:
                res = fn()
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 - handed to every rank
                exc = e
        outcomes = self.gather_objects((None, res) if exc is None else (_portable(exc), None))
        for r, (e, _) in enumerate(outcomes):
            if e is not None:
                raise exc if r == self.rank else e
        return [r_ for _, r_ in outcomes]

    def barrier(self) -> None:
        self.settle(lambda: None)


def _portable(exc: BaseException) -> BaseException:
    """``exc`` if it survives pickling, else a RuntimeError naming it."""
    try:
        return pickle.loads(pickle.dumps(exc))
    except Exception:  # noqa: BLE001 - any unpicklable exception
        return RuntimeError(f"{type(exc).__name__}: {exc}")


def _rank_device(device, rank: int) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("host_mesh: no CUDA device; pass device='cpu' to run on the host")
        return torch.device("cuda", rank % torch.cuda.device_count())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"host_mesh: device {str(device)!r} requested but no CUDA "
                               "device is available")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def host_mesh(n_shards: int, *, device=None) -> Mesh:
    """1-D ``("data",)`` mesh over the first ``n_shards`` ranks of the
    process group this process joined (``torch.distributed`` initialised).

    ``device`` is this rank's device: by default ``cuda:{rank % cards}``
    (there is no CPU default); ``"cuda"`` without an index means the same,
    ``"cpu"`` runs the rank on the host.
    """
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n_shards:
        raise ValueError(f"host_mesh: need {n_shards} ranks, have {have}")
    rank = dist.get_rank()
    if rank >= n_shards:
        raise ValueError(f"host_mesh: rank {rank} is outside the first {n_shards} ranks")
    group = dist.group.WORLD if have == n_shards else dist.new_group(list(range(n_shards)))
    return Mesh(group=group, rank=rank, size=n_shards, device=_rank_device(device, rank),
                backend=dist.get_backend(group))


def collective_timeout_s(mesh: Mesh) -> float:
    """Seconds a collective of ``mesh``'s group waits for its peers before
    it fails: the timeout its process group was created with."""
    dev = torch.device("cpu" if mesh.backend == "gloo" else mesh.device.type)
    return mesh.group._get_backend(dev).options._timeout.total_seconds()


class Channel:
    """Rank 0's ordered stream of op headers to the other ranks of ``mesh``.

    A mesh-mode call is a collective every rank must enter with the same
    arguments in the same order, but only one process (rank 0) sees the
    requests that decide which call comes next.  Rank 0 sends a picklable
    header (:meth:`send`; host data only: an op name and its arguments) and
    then runs the op; every other rank receives the headers in order
    (:meth:`recv`) and runs the same op.  Each op ends in :meth:`agree`, so
    an exception on any rank is raised on every rank and no rank goes on to
    a collective its peers skip.

    A rank blocked in :meth:`recv` waits at most the group's collective
    timeout (:attr:`timeout_s`, read off the group): the sender keeps an
    idle channel alive by sending a heartbeat header at least every
    :attr:`beat_s` seconds (see :meth:`idle_s`), so only a silent or dead
    rank 0 ends a receiver's wait.
    ``counts`` tallies the headers this rank sent or received by op name.
    """

    #: the header that keeps an idle channel inside the collective timeout
    BEAT = ("beat", {})

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.counts: collections.Counter = collections.Counter()
        #: the exception the last failed :meth:`agree` raised on this rank
        self.last_error: Optional[BaseException] = None
        self._src = dist.get_global_rank(mesh.group, 0)
        #: the group's collective timeout, which a heartbeat must beat
        self.timeout_s = collective_timeout_s(mesh)
        self._last = time.monotonic()

    @property
    def leader(self) -> bool:
        """Whether this rank sends (rank 0) or receives."""
        return self.mesh.rank == 0

    @property
    def beat_s(self) -> float:
        """The longest a sender may stay silent: a quarter of the timeout."""
        return self.timeout_s / 4

    def idle_s(self) -> float:
        """Seconds since this rank last sent or received a header."""
        return time.monotonic() - self._last

    def _note(self, header) -> None:
        self.counts[header[0]] += 1
        self._last = time.monotonic()

    def send(self, header: tuple) -> None:
        """Broadcast ``header`` (``(op, kwargs)``, picklable) from rank 0."""
        if not self.leader:
            raise RuntimeError(f"Channel.send: rank {self.mesh.rank} receives; rank 0 sends")
        dist.broadcast_object_list([header], src=self._src, group=self.mesh.group)
        self._note(header)

    def recv(self) -> tuple:
        """The next header rank 0 sent (blocks; fails after the timeout)."""
        box = [None]
        dist.broadcast_object_list(box, src=self._src, group=self.mesh.group)
        self._note(box[0])
        return box[0]

    def agree(self, fn):
        """``fn()`` on this rank, then agree on the outcome: this rank's own
        result (nothing is exchanged but the outcome), or on every rank the
        exception of the lowest rank that raised, which is also kept as
        ``last_error``.  A failure of the agreement's own collective (a dead
        peer, a timeout) propagates as it is."""
        res, exc = None, None
        try:
            res = fn()
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 - handed to every rank
            exc = e
        outcomes = self.mesh.gather_objects(None if exc is None else _portable(exc))
        for r, e in enumerate(outcomes):
            if e is not None:
                self.last_error = exc if r == self.mesh.rank else e
                raise self.last_error
        return res


def data_axes(mesh) -> tuple:
    """Axes that carry the batch/vertex dimension (pod folds into data): of
    a rank :class:`Mesh` (``axis_names``) or a ``DeviceMesh`` /
    ``MeshShape`` (``mesh_dim_names``)."""
    names = getattr(mesh, "mesh_dim_names", None) or getattr(mesh, "axis_names", ())
    return tuple(a for a in ("pod", "data") if a in names)


_C10D_LIBS: list = []


def use_c10d_all_gather() -> None:
    """Route the functional all-gather (``_c10d_functional.
    all_gather_into_tensor``, which DTensor issues) of CUDA tensors
    through ``torch.distributed.all_gather_into_tensor``.

    On gloo, the functional all-gather of a CUDA tensor kills the process
    (SIGSEGV, torch 2.11 on the H100), while the c10d call gathers the same
    bytes over the same group; the ranks that share one card over gloo
    (``chip_smoke.py``'s ``model_shard`` phase) install this once.  The op
    and its operands are unchanged, so the dry run's counters see the same
    collective; the call completes before it returns, so DTensor's wait is
    a no-op.
    """
    if _C10D_LIBS:
        return
    from torch.distributed.distributed_c10d import _resolve_process_group

    def gather(inp, group_size, group_name):
        out = inp.new_empty((inp.shape[0] * group_size, *inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", gather, "CUDA")
    _C10D_LIBS.append(lib)


def production_shape(*, multi_pod: bool = False) -> tuple:
    """(shape, axes) of ``repro``'s production mesh: 16×16 = 256 chips a
    pod; multi-pod adds a leading 2-pod axis."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_mesh_like(shape: tuple, axes: tuple, *, device_type: str = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process group
    this process joined, whose world size must be ``prod(shape)``.
    ``device_type`` defaults to ``"cuda"`` where a card is, else ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh_like: join a process group first")
    n = int(np.prod(shape))
    if dist.get_world_size() != n:
        raise ValueError(f"make_mesh_like: mesh {tuple(shape)} needs {n} ranks, the "
                         f"process group has {dist.get_world_size()}")
    if len(axes) != len(shape):
        raise ValueError(f"make_mesh_like: {len(axes)} axis names for {len(shape)} dims")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = None):
    """``repro``'s production mesh (:func:`production_shape`) over the
    process group this process joined (256 or 512 ranks)."""
    return make_mesh_like(*production_shape(multi_pod=multi_pod), device_type=device_type)


def transport(n: int, device) -> str:
    """The collective backend the topology gives ``n`` ranks on ``device``:
    ``"nccl"`` when every rank has a card of its own, else ``"gloo"``."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type != "cuda" or dev.index is not None:
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= n else "gloo"


def _rank_main(rank: int, fn, n: int, backend: str, device, store: str, coll_timeout: float,
               args: tuple) -> None:
    dist.init_process_group(backend, init_method=f"file://{os.path.join(store, 'rdv')}",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=coll_timeout))
    try:
        mesh = host_mesh(n, device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or n) // n))
        out = fn(mesh, *args)
        with open(os.path.join(store, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier(group=mesh.group)
    except BaseException:
        with open(os.path.join(store, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n: int, *, args: tuple = (), device=None, init_dir: Optional[str] = None,
              timeout: float = 300.0, collective_timeout: Optional[float] = None) -> list:
    """Run ``fn(mesh, *args)`` on ``n`` spawned ranks; their results in rank
    order.

    ``fn`` must be picklable (a module-level function).  ``device`` is each
    rank's (``host_mesh``'s rule: ``"cpu"``, ``"cuda"`` for a card a rank
    where there are enough, ``"cuda:0"`` for one shared card), and the
    transport is :func:`transport`'s for ``n`` ranks on it.  The
    rendezvous file and the results live in a fresh directory under
    ``init_dir`` (the system's temporary directory by default), removed on
    the way out.  A collective fails after ``min(timeout,
    collective_timeout)`` seconds without its peers (``DEFAULT_TIMEOUT_S``
    when ``collective_timeout`` is None; :func:`collective_timeout_s`),
    and the ranks are killed if they have not all finished within
    ``timeout``: a rank that raised, or died, takes the others down and its
    error is raised here.
    """
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    backend = transport(n, device)
    coll = min(timeout, DEFAULT_TIMEOUT_S if collective_timeout is None else collective_timeout)
    store = tempfile.mkdtemp(prefix="ranks_", dir=init_dir)
    try:
        ctx = mp.start_processes(_rank_main, args=(fn, n, backend, device, store, coll, args),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"run_ranks: {n} ranks still running after {timeout} s")
        except (ProcessException, TimeoutError) as e:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
            raise RuntimeError(f"run_ranks: {e}" + "".join(
                f"\n-- rank {r}:\n" + open(os.path.join(store, f"error_{r}.txt")).read()
                for r in range(n) if os.path.exists(os.path.join(store, f"error_{r}.txt"))
            )) from e
        out = []
        for rank in range(n):
            with open(os.path.join(store, f"result_{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(store, ignore_errors=True)
