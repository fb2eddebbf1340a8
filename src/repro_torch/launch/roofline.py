"""Roofline analysis from the dry run's records, priced on the H100.

The counterpart of ``repro.launch.roofline``: ``step_costs``,
``model_flops``, ``analyze_cell``, ``analyze_all`` and ``markdown_table``
are ``repro``'s code.  The records are ``launch.dryrun``'s: flops and bytes
accessed per device counted over the local ops of one eager step, and
collective operand bytes per device.  The port's loops are Python loops,
so every trip is counted and a variant's costs are exact; the LM
extrapolation from the reduced-depth variants stays ``repro``'s (a layer's
costs are linear in the depth either way):

  LM train : f(L) = cost1 + (L-1)·(cost2-cost1)   (per microbatch, depth L)
             g(L) = opt1  + (L-1)·(opt2-opt1)     (optimizer apply)
             step = accum·(f(L) - g(L)) + g(L)
  LM infer : step = cost1 + (L-1)·(cost2-cost1)
  MACE ogb : the full variant's costs, else chunk2's (``repro``'s
             base + D/C extrapolation undoes XLA's once-counted scan body,
             which the port's Python loop does not have)
  others   : the full variant's costs.

Hardware model: NVIDIA H100 SXM5 80 GB, from its data sheet (modelled,
not measured):

  * ``PEAK_FLOPS`` 989e12 FLOP/s: dense bfloat16 tensor-core rate (the
    constant ``chip_smoke.py`` prices flash attention with);
  * ``HBM_BW`` 3.35e12 B/s: HBM3 bandwidth;
  * ``HBM_BYTES`` 80e9 B: the card's memory;
  * ``LINK_BW`` 50e9 B/s per GPU for the collective term: a 16-wide mesh
    axis on 8-GPU nodes crosses the node's 400 Gb/s InfiniBand link
    (ConnectX-7, one a GPU), which bounds a ring over the axis; the one
    collective term is ``repro``'s (a per-axis model would be a feature
    ``repro`` lacks).

Terms (seconds per step, 256-GPU mesh):
  compute    = flops_dev / 989e12
  memory     = bytes_dev / 3.35e12
  collective = collective_bytes_dev / 50e9
"""
from __future__ import annotations

import json
import os
from typing import Optional

from ..configs import base as cfgbase

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 50e9
CHIPS = 256
HBM_BYTES = 80e9

RESULTS_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "dryrun"
)


def _load(arch, shape, variant, mesh="16x16") -> Optional[dict]:
    p = os.path.abspath(
        os.path.join(RESULTS_DIR, mesh, f"{arch}__{shape}__{variant}.json")
    )
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _vec(rec) -> dict:
    """(flops, bytes, collective bytes) per device for one variant's step."""
    coll = sum(rec["collectives"]["total_bytes"].values())
    return {
        "flops": rec["cost"]["flops"],
        "bytes": rec["cost"]["bytes_accessed"],
        "coll": float(coll),
    }


def _axpy(a, x, y=None):
    out = {k: a * x[k] + (y[k] if y else 0.0) for k in x}
    return out


def _sub(x, y):
    return {k: x[k] - y[k] for k in x}


def _add(x, y):
    return {k: x[k] + y[k] for k in x}


def step_costs(arch: str, shape: str) -> Optional[dict]:
    """Extrapolated per-device, per-step (flops, bytes, coll bytes)."""
    full = _load(arch, shape, "full")
    if full is None or full.get("status") != "ok":
        return None
    return costs_from(arch, shape, full.get("loop_correction", {}), full)


def costs_from(arch: str, shape: str, lc: dict, full: Optional[dict] = None) -> Optional[dict]:
    """``step_costs`` from the variants' records and a loop correction
    ``lc`` (the full variant's; a reduced variant's carries the same kind),
    without the full record where the kind extrapolates."""
    entry = cfgbase.get(arch)
    kind = lc.get("kind", "")
    if kind in ("lm_train", "lm_prefill", "lm_decode"):
        c2 = _load(arch, shape, "cost2")
        c4 = _load(arch, shape, "cost4")
        if not (c2 and c4 and c2["status"] == c4["status"] == "ok"):
            return None
        L = entry.full.n_layers
        per_layer = {k: max(v, 0.0) for k, v in _axpy(0.5, _sub(_vec(c4), _vec(c2))).items()}
        base = {k: max(v, 0.0) for k, v in _sub(_vec(c2), _axpy(2, per_layer)).items()}
        f_l = _axpy(L, per_layer, base)
        if kind == "lm_train":
            o1 = _load(arch, shape, "opt1")
            o2 = _load(arch, shape, "opt2")
            accum = lc.get("accum", 16)
            if o1 and o2 and o1["status"] == o2["status"] == "ok":
                g_l = _axpy(L - 1, _sub(_vec(o2), _vec(o1)), _vec(o1))
                g_l = {k: max(v, 0.0) for k, v in g_l.items()}
                fwdbwd = {k: max(v, 0.0) for k, v in _sub(f_l, g_l).items()}
                step = _add(_axpy(accum, fwdbwd), g_l)
            else:
                step = _axpy(accum, f_l)
            return step
        return f_l
    if kind == "gnn_chunked":
        # repro extrapolates from chunk2/chunk4 because XLA counts a scan's
        # body once; the port's chunk loop is a Python loop whose every
        # trip is counted, so a record's costs are its step's: the full
        # variant's, else chunk2's (the edges the same, in 2 chunks)
        if full is not None:
            return _vec(full)
        f2 = _load(arch, shape, "chunk2")
        return _vec(f2) if f2 and f2["status"] == "ok" else None
    return None if full is None else _vec(full)


# ---------------------------------------------------------------------------
# MODEL_FLOPS — useful-compute yardsticks (global, per step)
# ---------------------------------------------------------------------------
def model_flops(arch: str, shape_name: str) -> float:
    entry = cfgbase.get(arch)
    shape = cfgbase.FAMILY_SHAPES[entry.family][shape_name]
    if entry.family == "lm":
        cfg = entry.full
        n_act = cfg.n_active_params()
        L, hq, dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
        if shape["kind"] == "train":
            toks = shape["seq_len"] * shape["global_batch"]
            s_eff = min(shape["seq_len"], cfg.sliding_window or shape["seq_len"])
            attn = 6 * L * toks * hq * dh * s_eff  # 2 matmuls·(S/2 causal)·3x bwd
            return 6.0 * n_act * toks + attn
        if shape["kind"] == "prefill":
            toks = shape["seq_len"] * shape["global_batch"]
            s_eff = min(shape["seq_len"], cfg.sliding_window or shape["seq_len"])
            return 2.0 * n_act * toks + 2 * L * toks * hq * dh * s_eff
        # decode: one token per sequence
        b = shape["global_batch"]
        s_ctx = min(shape["seq_len"], cfg.sliding_window or shape["seq_len"])
        return 2.0 * n_act * b + 4.0 * L * b * hq * dh * s_ctx
    if entry.family == "gnn":
        cfg = entry.full
        if shape["kind"] == "sampled":
            from ..sampling import neighbor

            sizes = neighbor.flat_sizes(shape["batch_nodes"], shape["fanout"])
            n = sum(sizes)
            e = sum(sizes[i + 1] for i in range(len(shape["fanout"])))
        elif shape["kind"] == "batched":
            n = shape["n_nodes"] * shape["batch"]
            e = shape["n_edges"] * shape["batch"]
        else:
            n, e = shape["n_nodes"], shape["n_edges"]
        train_mult = 3.0  # fwd+bwd
        if entry.model == "gcn":
            d0 = shape.get("d_feat", cfg.d_in)
            h, c = cfg.d_hidden, cfg.n_classes
            fwd = 2 * n * d0 * h + 2 * e * h + 2 * n * h * c + 2 * e * c
        elif entry.model == "schnet":
            d, r = cfg.d_hidden, cfg.n_rbf
            fwd = cfg.n_interactions * (
                2 * e * (r * d + d * d) + e * d + 2 * n * (2 * d * d)
            )
        elif entry.model == "mace":
            c = cfg.d_hidden
            per_l = (
                2 * e * (cfg.n_rbf * 32 + 32 * 3 * c)  # radial MLP
                + 2 * e * c * 13                        # density s/v/t
                + 3 * 2 * n * c * c                     # channel mixing
                + 2 * 24 * n * c * 13                   # product basis (2 rounds)
            )
            fwd = cfg.n_layers * per_l
        else:  # graphcast
            d, nv = cfg.d_hidden, cfg.n_vars
            fwd = (
                2 * n * (nv * d + d * d) * 2            # enc+dec
                + cfg.n_layers * (2 * e * (3 * d * d + d * d) + 2 * n * (2 * d * d + d * d))
            )
        return train_mult * fwd
    # recsys
    cfg = entry.full
    d = cfg.embed_dim
    sizes = [0, *cfg.tower_mlp]
    mlp_flops = sum(2 * sizes[i] * sizes[i + 1] for i in range(1, len(sizes) - 1))
    per_ex_user = cfg.n_user_fields * cfg.bag_size * d + 2 * (
        cfg.n_user_fields * d * cfg.tower_mlp[0]
    ) + mlp_flops
    per_ex_item = cfg.n_item_fields * cfg.bag_size * d + 2 * (
        cfg.n_item_fields * d * cfg.tower_mlp[0]
    ) + mlp_flops
    if shape["kind"] == "train":
        b = shape["batch"]
        return 3.0 * b * (per_ex_user + per_ex_item) + 3.0 * 2 * b * b * cfg.tower_mlp[-1]
    if shape["kind"] == "retrieval":
        c = shape["n_candidates"]
        return per_ex_user + c * per_ex_item + 2 * c * cfg.tower_mlp[-1]
    b = shape["batch"]
    return b * (per_ex_user + per_ex_item + 2 * cfg.tower_mlp[-1])


# ---------------------------------------------------------------------------
def terms(arch: str, shape: str, step: dict) -> dict:
    """The step's roofline terms on the H100 (seconds), the dominant one,
    and the useful-compute ratios."""
    compute_s = step["flops"] / PEAK_FLOPS
    memory_s = step["bytes"] / HBM_BW
    coll_s = step["coll"] / LINK_BW
    t = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(t, key=t.get)
    mf = model_flops(arch, shape)
    hlo_global = step["flops"] * CHIPS
    return dict(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=coll_s,
        dominant=dominant,
        bound_s=t[dominant],
        model_flops=mf,
        hlo_flops_global=hlo_global,
        useful_ratio=mf / hlo_global if hlo_global else 0.0,
        roofline_fraction=(mf / PEAK_FLOPS / CHIPS) / t[dominant] if t[dominant] else 0.0,
    )


def analyze_cell(arch: str, shape: str) -> dict:
    entry = cfgbase.get(arch)
    skip = entry.skip_shapes.get(shape)
    row = {"arch": arch, "shape": shape}
    if skip:
        row["status"] = "skipped"
        row["reason"] = skip
        return row
    full = _load(arch, shape, "full")
    if full is None or full["status"] != "ok":
        # the step from the reduced variants where the full one was not
        # dry-run (a sweep's budget): its memory is then not known
        first = _load(arch, shape, "cost2") or _load(arch, shape, "chunk2")
        step = (costs_from(arch, shape, first.get("loop_correction", {}))
                if first and first.get("status") == "ok" else None)
        if step is None:
            row["status"] = "missing" if full is None else full["status"]
            if full is not None:
                row["error"] = full.get("error", full.get("reason", ""))[:200]
            return row
        row.update(status="ok", full=False, **terms(arch, shape, step),
                   hbm_peak_gib=None, fits_hbm=None)
        return row
    step = step_costs(arch, shape)
    if step is None:
        row["status"] = "partial"
        return row
    row.update(
        status="ok",
        full=True,
        **terms(arch, shape, step),
        hbm_peak_gib=full["memory"]["peak_bytes"] / 2**30,
        fits_hbm=full["memory"]["peak_bytes"] <= HBM_BYTES,
    )
    return row


def analyze_all() -> list[dict]:
    return [analyze_cell(a, s) for a, s, _ in cfgbase.all_cells()]


def markdown_table(rows) -> str:
    hdr = (
        "| arch | shape | compute (s) | memory (s) | collective (s) | bound | "
        "MODEL_FLOPS | useful/HLO | roofline frac | HBM GiB | fits |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    out = [hdr]
    for r in rows:
        if r.get("status") != "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | {r.get('status')} "
                f"| — | — | — | — | {r.get('reason', r.get('error', ''))[:60]} |\n"
            )
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | {r['dominant']} | "
            f"{r['model_flops']:.2e} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.2f} | "
            + ("— | full not dry-run |\n" if r["hbm_peak_gib"] is None else
               f"{r['hbm_peak_gib']:.1f} | {'✓' if r['fits_hbm'] else '✗'} |\n")
        )
    return "".join(out)


def main(argv=None):
    import argparse

    global RESULTS_DIR
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=RESULTS_DIR, help="the dry run's records")
    RESULTS_DIR = ap.parse_args(argv).results
    rows = analyze_all()
    out = os.path.abspath(os.path.join(RESULTS_DIR, "..", "roofline.json"))
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"Roofline per step on {CHIPS} GPUs, modelled from NVIDIA H100 SXM data-sheet "
          f"constants ({PEAK_FLOPS:.3g} FLOP/s bf16, {HBM_BW:.3g} B/s HBM, "
          f"{LINK_BW:.3g} B/s a GPU's link, {HBM_BYTES:.3g} B HBM)\n")
    print(markdown_table(rows))
    print(f"\nwritten: {out}")


if __name__ == "__main__":
    main()
