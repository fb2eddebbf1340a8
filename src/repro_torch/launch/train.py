"""Training launcher: end-to-end training of any registered arch.

The counterpart of ``repro.launch.train``: trains the REDUCED config of an
arch's train cell (LM ``train_4k``, GNN ``full_graph_sm``, recsys
``train_batch`` unless ``--shape`` names another) on synthetic data, with
checkpoint/restart.  Checkpoints are ``repro``'s layout and keys
(``checkpoint.manager``; a bfloat16 leaf as its raw 16-bit words), so the
port resumes from ``repro``'s and ``repro`` from the port's float32 ones.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-235b-a22b
  PYTHONPATH=src python -m repro_torch.launch.train --arch mace --device cpu \
      --steps 20 --ckpt-dir /tmp/ck --resume
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint import manager as ckpt
from ..configs import base as cfgbase
from ..core import tree as tree_mod
from . import steps


def default_shape(arch: str) -> str:
    fam = cfgbase.get(arch).family
    return {"lm": "train_4k", "gnn": "full_graph_sm", "recsys": "train_batch"}[fam]


def save(ckpt_dir: str, step: int, state: dict) -> str:
    """Checkpoint ``state`` (host copies of its tensors) at ``step``."""
    return ckpt.save(ckpt_dir, step, tree_mod.tree_map(ckpt.host_array, state))


@torch.no_grad()
def restore(ckpt_dir: str, state: dict) -> int:
    """Load the latest checkpoint into ``state``'s tensors in place (the
    parameters stay the model's); returns its step."""
    loaded, at = ckpt.restore(ckpt_dir, state)
    tree_mod.tree_map(lambda t, v: t.copy_(v), state, loaded)
    return at


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    shape = args.shape or default_shape(args.arch)
    cell = steps.build_cell(args.arch, shape, reduced=True, device=args.device)
    state, batch = cell.args

    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        at = restore(args.ckpt_dir, state)
        print(f"[train] resumed from step {at}")

    t0 = time.time()
    losses = []
    for i in range(args.steps):
        state, metrics = cell.step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if i % args.log_every == 0:
            print(f"[train] step {i:4d} loss {loss:.4f} "
                  f"({(time.time()-t0)/(i+1)*1e3:.1f} ms/step)", flush=True)
        if args.ckpt_dir and i > 0 and i % args.ckpt_every == 0:
            save(args.ckpt_dir, i, state)
    if args.ckpt_dir:
        save(args.ckpt_dir, args.steps, state)
    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    if not (losses[-1] < losses[0] or np.isclose(losses[-1], losses[0], rtol=0.2)):
        print("[train] WARNING: loss did not decrease")
    return losses


if __name__ == "__main__":
    main()
