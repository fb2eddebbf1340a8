"""Dry run of model sharding on the production meshes, and its counters.

The H100 counterpart of ``repro.launch.dryrun``.  ``repro`` lowers and
compiles every (architecture × input shape × variant) cell for 512 forced
host devices and reads XLA's ``memory_analysis``, ``cost_analysis`` and the
collectives in the HLO.  Nothing of that exists here: PyTorch runs eagerly.
The port runs one step of each cell instead, in one process, as one rank of
a fake process group of the production mesh's world size (256, or 512 for
``--multi-pod``; ``torch.testing``'s ``FakeStore``), with every tensor a
fake (``FakeTensorMode``) on the card's device type, so that DTensor picks
the collectives a card would and nothing is allocated:

  * ``launch.mesh.make_production_mesh`` (a ``DeviceMesh``);
  * ``steps.build_cell(..., data_axes=data_axes(mesh))`` under the fake
    mode (the cells' data as empty fakes of their shapes), every kernel
    site on its kernel (``backend="cuda"``): the kernels' custom ops run
    their fake bodies, never the plain versions;
  * ``steps.attach_shardings`` and ``steps.shard_cell``, then one step
    under :class:`LocalCounter` and ``MemTracker``.

Per device it records the argument bytes (the local shards of state and
inputs), the step's peak bytes (``MemTracker``), the flops of the LOCAL ops
(a ``FlopCounterMode`` around DTensor code counts the global op, so the
counter lets DTensor desugar first and counts what each rank runs, the
kernels' custom ops by their registered formulas), the collectives'
operand bytes and counts by ``repro``'s kinds (``"all-gather"``,
``"all-reduce"``, ``"reduce-scatter"``, ``"all-to-all"``; the
``_c10d_functional`` ops DTensor issues), the trace seconds and
``loop_correction``.  A cell that cannot be traced (a data-dependent shape
under the fake mode, a placement a site refuses) is recorded as
``"status": "error"`` with its reason, as ``repro`` records it.

Dropped from ``repro``: the HLO parser (``collective_stats``,
``_type_bytes``) and the 512-device ``XLA_FLAGS`` line: the counter sees
the collectives as they are issued, with their tensors, and the fake
process group takes any world size.  ``while_body_bytes`` is always
``{}``: the port's loops are Python loops, every trip counted.

The same counter runs on real ranks (``chip_smoke.py``'s ``model_shard``
phase), where the local tensors are real; the sharding propagator's own
ops on fakes are never counted.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gcn-cora --shape molecule
Variants (roofline support): full cost1 cost2 cost4 opt1 opt2 chunk2 chunk4.
Results as JSON under results/dryrun/<mesh>/.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import time
import traceback

import torch

from ..configs import base as cfgbase
from ..core import tree as tree_mod
from . import mesh as mesh_mod
from . import steps

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun")

#: ``_c10d_functional`` ops -> ``repro``'s collective kinds
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}


def _tensors(tree) -> list:
    out = []
    for x in tree if isinstance(tree, (list, tuple)) else [tree]:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
    return out


class LocalCounter:
    """A dispatch mode that counts what this rank runs: flops of the local
    ops (``torch.utils.flop_counter``'s formulas: matrix products,
    attention and the kernels' custom ops; elementwise ops count 0), the
    bytes they access (every op that makes a tensor reads its inputs and
    writes its outputs once: eager, unfused; views are free) and the
    collectives' operand bytes and counts by kind.

    It returns ``NotImplemented`` for DTensor-level ops, so DTensor
    desugars them into local ops and collectives, which come back through
    it.  DTensor's sharding propagator runs each op once more on fakes of
    the global shapes (in the dry run's own fake mode, where there is one);
    ops inside the propagator are not counted.
    """

    #: the ShardingPropagator methods that run ops on fakes, newest first
    PROPAGATORS = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return counter._dispatch(func, types, args, kwargs or {})

        self._mode = _Mode()
        self._in_propagation = 0
        self._patched = None
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_bytes: collections.Counter = collections.Counter()
        self.coll_count: collections.Counter = collections.Counter()

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = next((n for n in self.PROPAGATORS if hasattr(ShardingPropagator, n)), None)
        if name is None:
            raise RuntimeError("LocalCounter: no ShardingPropagator method of "
                               f"{self.PROPAGATORS} to keep the propagator's ops out")
        inner = getattr(ShardingPropagator, name)

        def propagate(*a, **k):
            self._in_propagation += 1
            try:
                return inner(*a, **k)
            finally:
                self._in_propagation -= 1

        setattr(ShardingPropagator, name, propagate)
        self._patched = (ShardingPropagator, name, inner)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            return self._mode.__exit__(*exc)
        finally:
            cls, name, inner = self._patched
            setattr(cls, name, inner)

    def _dispatch(self, func, types, args, kwargs):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._in_propagation:
            return out
        tensors = _tensors(list(args) + list(kwargs.values()))
        packet = func._overloadpacket
        outs = [t for t in _tensors(out) if not t._is_view()]
        if outs and func.namespace not in ("_c10d_functional", "prim"):
            self.bytes_accessed += sum(t.numel() * t.element_size() for t in tensors + outs)
        if func.namespace == "_c10d_functional":
            kind = COLLECTIVE_KINDS.get(packet.__name__)
            if kind is not None:
                self.coll_bytes[kind] += sum(t.numel() * t.element_size()
                                             for t in _tensors(args[0]))
                self.coll_count[kind] += 1
        elif packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        return out

    def collectives(self) -> dict:
        """``{"total_bytes": {kind: bytes}, "count": {kind: n},
        "while_body_bytes": {}}`` (``repro``'s record, less the loop part)."""
        return {"total_bytes": dict(self.coll_bytes), "count": dict(self.coll_count),
                "while_body_bytes": {}}


def arg_bytes(args) -> int:
    """Bytes of this rank's shards of ``args`` (every tensor leaf)."""
    total = 0
    for leaf in tree_mod.leaves(list(args)):
        if isinstance(leaf, torch.Tensor):
            local = leaf.to_local() if hasattr(leaf, "to_local") else leaf
            total += local.numel() * local.element_size()
    return total


def build_cell(arch: str, shape: str, variant: str, *, mesh, device, backend="cuda",
               reduced: bool = False):
    """The cell of ``variant`` (``reduced``: the SMOKE cell) on ``mesh``'s
    data axes with every kernel site on ``backend``: (cell, placements)."""
    if variant.startswith("opt"):
        cell = steps.build_opt_cell(arch, variant=variant, device=device)
    else:
        cell = steps.build_cell(arch, shape, variant=variant, device=device, reduced=reduced,
                                data_axes=mesh_mod.data_axes(mesh))
    placements = steps.attach_shardings(cell, mesh, arch, shape)
    if "make_step" in cell.meta:
        cell.step_fn = cell.with_backend(backend)
    return cell, placements


def step_record(cell, placements, mesh) -> dict:
    """Shard ``cell`` over ``mesh``, run one step under the counters, and
    record per device: argument bytes, peak bytes (``MemTracker``), flops,
    collectives and the step's seconds."""
    from torch.distributed._tools.mem_tracker import MemTracker

    sharded = steps.shard_cell(cell, placements, mesh)
    rec = {"memory": {"argument_bytes": arg_bytes(sharded.args)}}
    tracker = MemTracker()
    tracker.track_external(*[x for x in tree_mod.leaves(list(sharded.args))
                             if isinstance(x, torch.Tensor)])
    t0 = time.perf_counter()
    with tracker, LocalCounter() as counter:
        sharded.step_fn(*sharded.args)
    rec["trace_s"] = round(time.perf_counter() - t0, 3)
    peak = tracker.get_tracker_snapshot("peak")
    rec["memory"]["peak_bytes"] = int(max((v.get("Total", 0) for v in peak.values()),
                                          default=0))
    rec["cost"] = {"flops": float(counter.flops),
                   "bytes_accessed": float(counter.bytes_accessed)}
    rec["collectives"] = counter.collectives()
    rec["loop_correction"] = cell.loop_correction
    return rec


def run_cell(arch: str, shape: str, *, mesh, variant: str = "full", device=None,
             reduced: bool = False) -> dict:
    """One cell's record on ``mesh`` (a fake process group's), every tensor
    a fake on ``device`` (the mesh's device type by default); ``reduced``
    dry-runs the SMOKE cell (to hold it against real ranks)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    entry = cfgbase.get(arch)
    rec = {"arch": arch, "shape": shape, "variant": variant,
           "mesh": "x".join(map(str, mesh.shape)), "n_devices": mesh.size()}
    skip = entry.skip_shapes.get(shape)
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec
    device = device or mesh.device_type
    t0 = time.perf_counter()
    with FakeTensorMode():
        cell, placements = build_cell(arch, shape, variant, mesh=mesh, device=device,
                                      reduced=reduced)
        rec["build_s"] = round(time.perf_counter() - t0, 3)
        rec.update(step_record(cell, placements, mesh))
    rec["status"] = "ok"
    return rec


def result_path(arch, shape, variant, multi_pod, *, root=RESULTS_DIR):
    mesh = "2x16x16" if multi_pod else "16x16"
    d = os.path.abspath(os.path.join(root, mesh))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{shape}__{variant}.json")


def lm_variants(shape_kind: str) -> list[str]:
    # (cost2, cost4) pair: repro's 1-layer lowering fuses anomalously, so
    # its extrapolation uses depths 2 and 4
    if shape_kind == "train":
        return ["full", "cost2", "cost4", "opt1", "opt2"]
    return ["full", "cost2", "cost4"]


def variants_for(arch: str, shape: str) -> list[str]:
    entry = cfgbase.get(arch)
    if entry.family == "lm":
        kind = cfgbase.FAMILY_SHAPES["lm"][shape]["kind"]
        return lm_variants(kind)
    if arch == "mace" and shape in ("ogb_products",):
        return ["full", "chunk2", "chunk4"]
    return ["full"]


def init_fake_world(world_size: int) -> None:
    """Join a fake process group of ``world_size`` ranks as rank 0 (no
    peers: collectives return at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), world_size=world_size, rank=0)


def error_record(arch, shape, variant, mesh_name, exc) -> dict:
    return {"arch": arch, "shape": shape, "variant": variant, "mesh": mesh_name,
            "status": "error", "error": f"{type(exc).__name__}: {exc}"[:2000],
            "traceback": traceback.format_exc()[-4000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--variant", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--missing-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the fakes' device type (default: cuda where a card is, else cpu)")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--budget-s", type=float, default=None,
                    help="start no cell after this many seconds; the rest are recorded as "
                         "'not run'; the LM train cells' full variants go last")
    args = ap.parse_args(argv)

    todo = []
    if args.all:
        for arch, shape, skip in cfgbase.all_cells():
            vs = ["full"] if args.multi_pod else variants_for(arch, shape)
            if skip:
                vs = ["full"]
            todo.extend((arch, shape, v) for v in vs)
    else:
        vs = [args.variant] if args.variant else (
            ["full"] if args.multi_pod else variants_for(args.arch, args.shape))
        todo = [(args.arch, args.shape, v) for v in vs]

    if args.budget_s is not None:  # the slowest traces last: 16 microbatches of every layer
        todo.sort(key=lambda c: c[2] == "full" and cfgbase.get(c[0]).family == "lm"
                  and cfgbase.FAMILY_SHAPES["lm"][c[1]]["kind"] == "train")
    t_start = time.perf_counter()
    shape_, axes = mesh_mod.production_shape(multi_pod=args.multi_pod)
    mesh_name = "x".join(map(str, shape_))
    init_fake_world(int(torch.tensor(shape_).prod()))
    mesh = mesh_mod.make_production_mesh(multi_pod=args.multi_pod, device_type=args.device)

    n_ok = n_fail = n_skip = n_left = 0
    for arch, shape, variant in todo:
        path = result_path(arch, shape, variant, args.multi_pod, root=args.out)
        if args.missing_only and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    continue
        print(f"[dryrun] {arch} × {shape} ({variant}) mesh={mesh_name}", flush=True)
        if args.budget_s is not None and time.perf_counter() - t_start > args.budget_s:
            rec = {"arch": arch, "shape": shape, "variant": variant, "mesh": mesh_name,
                   "status": "not run", "reason": f"the sweep's budget of {args.budget_s} s"}
        else:
            try:
                rec = run_cell(arch, shape, mesh=mesh, variant=variant)
            except Exception as e:  # noqa: BLE001 — record the failure, keep going
                rec = error_record(arch, shape, variant, mesh_name, e)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        st = rec["status"]
        n_ok += st == "ok"
        n_fail += st == "error"
        n_skip += st == "skipped"
        n_left += st == "not run"
        msg = {"ok": f"ok  build={rec.get('build_s')}s step={rec.get('trace_s')}s "
                     f"peak={rec.get('memory', {}).get('peak_bytes', 0) / 2**30:.2f}GiB/dev",
               "skipped": f"SKIP ({rec.get('reason', '')[:60]})",
               "not run": "NOT RUN (budget)",
               "error": f"FAIL {rec.get('error', '')[:160]}"}[st]
        print(f"  -> {msg}", flush=True)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} failed, {n_left} not run")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
