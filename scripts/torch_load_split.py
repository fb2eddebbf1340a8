#!/usr/bin/env python3
"""Split the PyTorch port's COO -> CSR load on the card into its parts.

    python3 scripts/torch_load_split.py [--root CHECKOUT] [--reps 5]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout), so
two checkouts can be compared on one card by running the script once for
each, in turns.  It makes chip_smoke.py's raw social COO (R-MAT, scale 21,
edge factor 16, seed 42: 67,108,864 edges over 2,097,152 vertices) on the
host and prints one JSON line per part of ``csr.from_coo(engine="cuda")``,
each the mean of ``--reps`` calls after a warm-up:

  host_conversions   ``csr._coo_int32`` (host clock)
  copies             ``csr._to_device``, pageable host->device (events)
  device_build       ``csr._build_device``: sort, offsets, range check
                     (events)
  sort_argsort_gather    the packed-key argsort and three gathers
                         (``ops.sort_coo_device``'s formulation before it
                         took the ids from the sorted key)
  sort_key_words     ``ops.sort_coo_device``: the sorted key's two words
                     and one gather (checked bit for bit against the above)
  degree_offsets     the kernel on the sorted sources
  searchsorted       ``torch.searchsorted`` of vertex ids (the plain
                     version and the library call)
  histogram_cumsum   ``count_degrees`` on the raw sources and a cumsum (the
                     device build's offsets before the sorted-source kernel)

and the whole call, cold (the first of the process) and warm (host clock,
the device synchronised before and after).  The first line is the card's
name and power limit.  Needs one CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch


def events_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_load_split: no CUDA device")
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.core import csr
    from repro_torch.io import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels.csr_build import kernel as cb_kernel
    from repro_torch.kernels.csr_build import ops as cb_ops

    _build.library()  # build the kernels before anything is timed
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    src, dst, wgt, n = synthetic.make_coo("social", scale=21, edge_factor=16, seed=42)
    m = int(src.shape[0])

    def emit(part, ms, **kw):
        print(json.dumps({"part": part, "ms": ms, "m": m, "n": n, **kw}), flush=True)

    def whole():
        return csr.from_coo(src, dst, wgt, n=n, dedup=False, engine="cuda", device=dev)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole()
    torch.cuda.synchronize()
    emit("from_coo_cold", (time.perf_counter() - t0) * 1e3)
    emit("from_coo_warm", host_ms(whole, args.reps))

    host = csr._coo_int32(src, dst, wgt)
    emit("host_conversions", host_ms(lambda: csr._coo_int32(src, dst, wgt), args.reps))
    emit("copies", events_ms(lambda: csr._to_device(*host, device=dev), args.reps),
         bytes=sum(a.nbytes for a in host))
    s, d, w = csr._to_device(*host, device=dev)
    del host
    emit("device_build", events_ms(
        lambda: csr._build_device(s, d, w, n=n, engine="cuda", presorted=False), args.reps))

    def argsort_gather():
        key = (s.to(torch.int64) << 32) | (d.to(torch.int64) & 0xFFFFFFFF)
        order = torch.argsort(key, stable=True)
        del key
        return s[order], d[order], w[order]

    a = argsort_gather()
    b = cb_ops.sort_coo_device(s, d, w)
    for x, y in zip(a, b):
        if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
            raise AssertionError("sort_coo_device differs from the argsort and gathers")
    del a
    emit("sort_argsort_gather", events_ms(argsort_gather, args.reps))
    emit("sort_key_words", events_ms(lambda: cb_ops.sort_coo_device(s, d, w), args.reps))
    src_s = b[0]
    del b
    emit("degree_offsets", events_ms(lambda: cb_kernel.degree_offsets(src_s, n), args.reps))
    emit("searchsorted", events_ms(lambda: cb_kernel.degree_offsets_torch(src_s, n), args.reps))

    def histogram_cumsum():
        deg = cb_kernel.count_degrees(s, n)
        offsets = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        torch.cumsum(deg, dim=0, dtype=torch.int32, out=offsets[1:])
        return offsets

    if not torch.equal(histogram_cumsum(), cb_kernel.degree_offsets(src_s, n)):
        raise AssertionError("degree_offsets differs from the histogram's cumsum")
    emit("histogram_cumsum", events_ms(histogram_cumsum, args.reps))


if __name__ == "__main__":
    main()
