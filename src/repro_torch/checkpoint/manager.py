"""Checkpointing: atomic, rotated, restart-from-latest (the port of
``repro.checkpoint.manager``).

Fault-tolerance contract (DESIGN.md §5): a step is durable once its
directory is atomically renamed into place; restart picks the newest
complete checkpoint; rotation bounds disk.  Arrays are stored as one
``.npz`` per shard plus a JSON manifest of keys, shapes, dtypes and chunk
digests, so a restore can validate structure before touching device
memory.  Sharded owners write one ``shard_{id}.npz`` per device under ONE
shared step manifest via :func:`save_arrays_sharded` — the atomic rename
commits all shards or none.  On a mesh of ranks (one process a shard)
:func:`save_arrays_mesh` writes the same layout: each rank its own shard
file, rank 0 the manifest and the rename.

**Differential checkpoints (DESIGN.md §15).**  Full manifests carry a
per-key list of ``CHUNK_BYTES``-granular CRC32 digests.
:func:`save_arrays_diff` writes a step that persists only the chunks
that changed since ``base_step`` — detected by hashing against the
base manifest's digests, or told directly via ``dirty`` hints.  Diff
manifests chain through ``base_step`` and always carry the FULL logical
key/shape/dtype/digest set, so any diff step is a complete restore point:
:func:`restore_arrays_diff` loads the chain's full base and patches chunks
forward, verifying persisted-chunk CRCs.  Rotation is chain-aware — a base
is never rotated out from under a kept diff.

The file layout, the manifest's fields and ``CHUNK_BYTES`` are ``repro``'s,
so a step directory written by either package restores in the other.  The
functions take host (numpy) arrays: a ``torch.Tensor`` is refused, so a
device buffer is never copied to the host behind the caller's back (hand
over ``state_tree()`` or ``util.host`` copies).  Digests are computed over
a byte view of each array, never a second copy of it.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import zlib
from typing import Any, Optional

import numpy as np
import torch

from ..core import tree as tree_mod

#: Dirty-block granularity of differential checkpoints.  16 KiB keeps
#: manifests small (one digest per chunk) while a single-row patch still
#: persists only a few chunks of the slot arrays.
CHUNK_BYTES = 1 << 14


def _host_array(key: str, v) -> np.ndarray:
    """``v`` as a numpy array; a tensor is the caller's to copy."""
    if isinstance(v, torch.Tensor):
        raise TypeError(
            f"checkpoint: {key!r} is a torch.Tensor on {v.device}; the checkpoint "
            "functions take host arrays (state_tree(), or util.host of the tensor)"
        )
    return np.asarray(v)


#: a bfloat16 leaf on disk: its raw 16-bit words, npz descr ``<V2``, as
#: ``repro`` writes an ``ml_dtypes.bfloat16`` array; the manifest names it
BF16_WORDS = np.dtype("V2")


def _dtype_name(arr) -> str:
    """The manifest's name of an array's dtype (``repro``'s ``str(dtype)``;
    raw bfloat16 words are ``"bfloat16"``)."""
    return "bfloat16" if arr.dtype == BF16_WORDS else str(arr.dtype)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a checkpoint stores it: a host copy; a bfloat16 tensor
    (which numpy has no type for) as its raw 16-bit words."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16_WORDS)
    return t.numpy()


def _byte_view(arr: np.ndarray) -> np.ndarray:
    """The bytes of ``arr`` (those of ``arr.tobytes()``) as a flat uint8
    array — a view, not a copy, of a C-contiguous array."""
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def _chunk_crcs(u8: np.ndarray) -> list:
    """CRC32 digest per CHUNK_BYTES chunk of a byte view (empty → [])."""
    mv = memoryview(u8)
    return [zlib.crc32(mv[i : i + CHUNK_BYTES]) for i in range(0, len(mv), CHUNK_BYTES)]


def _ranges_to_chunks(ranges, itemsize: int, nbytes: int) -> np.ndarray:
    """Chunk ids covered by half-open ELEMENT ranges ``[(lo, hi), ...]``.

    Dirty hints come in element units (rows, slot extents); the byte scale
    is the key's own itemsize.  Ids are clipped to the chunks that actually
    exist for an ``nbytes``-long buffer.
    """
    r = np.asarray(ranges, dtype=np.int64).reshape(-1, 2)
    n_chunks = (nbytes + CHUNK_BYTES - 1) // CHUNK_BYTES
    if r.shape[0] == 0 or n_chunks == 0:
        return np.empty(0, dtype=np.int64)
    r = r[r[:, 1] > r[:, 0]]
    if r.shape[0] == 0:
        return np.empty(0, dtype=np.int64)
    lo = (r[:, 0] * itemsize) // CHUNK_BYTES
    hi = (r[:, 1] * itemsize - 1) // CHUNK_BYTES  # inclusive
    ids = np.concatenate([np.arange(a, b + 1, dtype=np.int64) for a, b in zip(lo, hi)])
    ids = np.unique(ids)
    return ids[(ids >= 0) & (ids < n_chunks)]


def _read_manifest(step_dir: str) -> dict:
    with open(os.path.join(step_dir, "manifest.json")) as f:
        return json.load(f)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{int(step):010d}")


def save(
    ckpt_dir: str,
    step: int,
    tree: Any,
    *,
    keep: int = 3,
    shard_id: int = 0,
) -> str:
    """Write checkpoint for ``step``; atomic rename; rotate old ones."""
    arrays = {k: _host_array(k, v) for k, v in tree_mod.paths(tree)}
    return save_arrays(ckpt_dir, step, arrays, keep=keep, shard_id=shard_id)


def save_arrays(
    ckpt_dir: str,
    step: int,
    arrays: dict,
    *,
    keep: int = 3,
    shard_id: int = 0,
) -> str:
    """Write a flat ``{key: ndarray}`` checkpoint (the graph-state path).

    Representations hand over their ``state_tree()`` dicts directly.
    ``shard_id`` names the shard file (``shard_{id}.npz``); multi-shard
    owners use :func:`save_arrays_sharded` so every shard commits under ONE
    step manifest and one atomic rename.
    """
    return save_arrays_sharded(ckpt_dir, step, {int(shard_id): arrays}, keep=keep)


def save_arrays_sharded(
    ckpt_dir: str,
    step: int,
    shards: dict,
    *,
    keep: int = 3,
) -> str:
    """Write ``{shard_id: {key: ndarray}}`` — one file per shard, one
    shared step manifest (DESIGN.md §14).

    All shard files land in the same tmp dir, so the atomic-rename commit
    point covers every shard: a step is either durable for all or for none.
    The ``checkpoint.pre_rename`` injection point simulates a crash between
    the tmp-dir write and the commit rename; like a real crash it leaves the
    ``.tmp_ckpt_*`` debris in place (recovery sweeps it via
    :func:`clean_stale`), which is why only the SimulatedCrash branch skips
    cleanup below.
    """
    from ..runtime import faultinject  # lazy: checkpoint stays import-light

    if not shards:
        raise ValueError("save_arrays_sharded: no shards to write")
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=ckpt_dir)
    try:
        blocks = {sid: _write_full_shard(tmp, sid, shards[sid]) for sid in sorted(shards)}
        _commit(ckpt_dir, tmp, final, _manifest(step, "full", blocks))
    except faultinject.SimulatedCrash:
        raise  # crashed writers don't clean up after themselves
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _rotate(ckpt_dir, keep)
    return final


def save_arrays_mesh(
    ckpt_dir: str,
    step: int,
    mesh,
    arrays: dict,
    *,
    keep: int = 3,
    diff: bool = False,
    base_step: Optional[int] = None,
    dirty=None,
) -> str:
    """This rank's part of a sharded step that every rank of ``mesh`` writes.

    The step has :func:`save_arrays_sharded`'s layout (``diff=True``:
    :func:`save_arrays_diff`'s, ``dirty`` being this rank's hint): rank 0
    makes the step's tmp dir, each rank writes its own ``shard_{rank}.npz``
    of ``arrays`` into it, and once every shard is written rank 0 writes the
    manifest, renames the dir into place and rotates.  Every rank calls it
    and returns the step's path, or raises the same error.
    """
    from ..runtime import faultinject  # lazy: checkpoint stays import-light

    final = _step_dir(ckpt_dir, step)

    def prepare():
        base = base_step
        if diff and base is None:
            base = latest_step(ckpt_dir)
            if base is None:
                raise FileNotFoundError(f"save_arrays_diff: no base checkpoint under {ckpt_dir}")
        os.makedirs(ckpt_dir, exist_ok=True)
        return tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=ckpt_dir), base

    tmp, base = mesh.settle(prepare, on=0)[0]

    def write():
        if diff:
            base_man = _read_manifest(_step_dir(ckpt_dir, base))
            return _write_diff_shard(tmp, mesh.rank, arrays, base_man, dirty)
        return _write_full_shard(tmp, mesh.rank, arrays)

    def commit():
        _commit(ckpt_dir, tmp, final,
                _manifest(step, "diff" if diff else "full", dict(enumerate(blocks)), base))
        _rotate(ckpt_dir, keep)

    try:
        blocks = mesh.settle(write)
        mesh.settle(commit, on=0)
    except faultinject.SimulatedCrash:
        raise  # crashed writers don't clean up after themselves
    except BaseException:
        if mesh.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _write_full_shard(tmp: str, sid: int, arrays: dict) -> dict:
    """Write one shard's ``shard_{sid}.npz`` into ``tmp``; its manifest block."""
    arrays = {k: _host_array(k, v) for k, v in arrays.items()}
    np.savez(os.path.join(tmp, f"shard_{sid}.npz"), **arrays)
    return {
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: _dtype_name(v) for k, v in arrays.items()},
        # per-key chunk digests: the anchor future diff steps hash/patch
        # against (§15)
        "chunks": {k: _chunk_crcs(_byte_view(v)) for k, v in arrays.items()},
    }


def _manifest(step: int, kind: str, blocks: dict, base_step: Optional[int] = None) -> dict:
    """A step manifest over ``{shard_id: block}``."""
    manifest = {"step": step, "kind": kind}
    if kind == "diff":
        manifest["base_step"] = int(base_step)
    manifest["n_shards"] = len(blocks)
    manifest["shards"] = {str(sid): blocks[sid] for sid in sorted(blocks)}
    if kind == "full" and len(blocks) == 1:
        # legacy flat fields: single-shard manifests stay readable by
        # pre-§14 restores (and restore() below)
        (only,) = manifest["shards"].values()
        manifest.update(only)
    return manifest


def _commit(ckpt_dir: str, tmp: str, final: str, manifest: dict) -> None:
    """Write the manifest into ``tmp`` and rename it into place."""
    from ..runtime import faultinject

    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    faultinject.fire("checkpoint.pre_rename")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomicity: rename is the commit point


def save_arrays_diff(
    ckpt_dir: str,
    step: int,
    shards: dict,
    *,
    base_step: Optional[int] = None,
    keep: int = 3,
    dirty: Optional[dict] = None,
) -> str:
    """Write a differential step: only chunks changed since ``base_step``.

    ``shards`` is the FULL current state (``{shard_id: {key: ndarray}}``
    — same shape as :func:`save_arrays_sharded`); what shrinks is the
    persisted payload, never the manifest's logical coverage, so every
    diff step is a complete restore point for :func:`restore_arrays_diff`.
    ``base_step`` defaults to the latest existing step (diff-on-diff
    chains are fine; restore walks the chain back to a full base).

    ``dirty`` optionally narrows the work per shard:

    - absent / ``None`` per shard → hash-compare every chunk against the
      base manifest digests (exact, costs one pass over the state);
    - ``"clean"`` → persist nothing for the shard (shapes verified);
    - ``"full"`` → persist the whole shard;
    - ``{key: hint}`` with per-key ``"clean"`` / ``"full"`` / ``None`` /
      an ``[(lo, hi), ...]`` array of half-open ELEMENT ranges — ranged
      keys persist exactly the covered chunks with no hashing.

    Keys whose shape/dtype changed vs the base, or that the base has no
    digests for (legacy manifests), degrade to full persistence of that
    key.  Changed chunks are stored as ``{key}::idx`` (chunk ids) +
    ``{key}::dat`` (raw bytes) npz entries; fully-replaced keys keep
    their plain name.
    """
    from ..runtime import faultinject  # lazy: checkpoint stays import-light

    if not shards:
        raise ValueError("save_arrays_diff: no shards to write")
    if base_step is None:
        base_step = latest_step(ckpt_dir)
    if base_step is None:
        raise FileNotFoundError(f"save_arrays_diff: no base checkpoint under {ckpt_dir}")
    base_man = _read_manifest(_step_dir(ckpt_dir, base_step))
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=ckpt_dir)
    try:
        blocks = {
            sid: _write_diff_shard(tmp, sid, shards[sid], base_man, (dirty or {}).get(sid))
            for sid in sorted(shards)
        }
        _commit(ckpt_dir, tmp, final, _manifest(step, "diff", blocks, base_step))
    except faultinject.SimulatedCrash:
        raise  # crashed writers don't clean up after themselves
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _rotate(ckpt_dir, keep)
    return final


def _write_diff_shard(tmp: str, sid: int, arrays: dict, base_man: dict, shard_hint) -> dict:
    """Write one shard's changed chunks into ``tmp``; its diff manifest block."""
    arrays = {k: _host_array(k, v) for k, v in arrays.items()}
    try:
        base_blk = _shard_manifest(base_man, int(sid), "")
    except FileNotFoundError:
        base_blk = None  # shard count changed: persist fully
    entries, chunks_out, diff_bytes = {}, {}, 0
    for k in sorted(arrays):
        arr = arrays[k]
        u8 = _byte_view(arr)
        base_ok = (
            base_blk is not None
            and k in base_blk.get("chunks", {})
            and base_blk["shapes"].get(k) == list(arr.shape)
            and base_blk["dtypes"].get(k) == _dtype_name(arr)
        )
        if isinstance(shard_hint, dict):
            key_hint = shard_hint.get(k)
        else:
            key_hint = shard_hint  # None / "clean" / "full"
        if not base_ok or (isinstance(key_hint, str) and key_hint == "full"):
            entries[k] = arr
            chunks_out[k] = _chunk_crcs(u8)
            diff_bytes += u8.shape[0]
            continue
        base_crcs = base_blk["chunks"][k]
        if isinstance(key_hint, str) and key_hint == "clean":
            # shape/dtype matched above; carry the base digests
            chunks_out[k] = list(base_crcs)
            continue
        if key_hint is None:  # hash-compare against the base
            crcs = _chunk_crcs(u8)
            ids = np.asarray(
                [i for i, (a, b) in enumerate(zip(crcs, base_crcs)) if a != b],
                dtype=np.int64,
            )
            chunks_out[k] = crcs
        else:  # element ranges: persist exactly the covered chunks
            ids = _ranges_to_chunks(key_hint, max(arr.dtype.itemsize, 1), u8.shape[0])
            crcs = list(base_crcs)
            mv = memoryview(u8)
            for i in ids:
                i = int(i)
                crcs[i] = zlib.crc32(mv[i * CHUNK_BYTES : (i + 1) * CHUNK_BYTES])
            chunks_out[k] = crcs
        if ids.size:
            dat = np.concatenate(
                [u8[int(i) * CHUNK_BYTES : (int(i) + 1) * CHUNK_BYTES] for i in ids]
            )
            entries[f"{k}::idx"] = ids
            entries[f"{k}::dat"] = dat
            diff_bytes += dat.shape[0]
    if entries:
        np.savez(os.path.join(tmp, f"shard_{sid}.npz"), **entries)
    return {
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: _dtype_name(v) for k, v in arrays.items()},
        "chunks": chunks_out,
        "diff_bytes": int(diff_bytes),
    }


def _shard_manifest(manifest: dict, shard_id: int, where: str) -> dict:
    """The {keys, shapes, dtypes} block for one shard of a manifest."""
    per = manifest.get("shards")
    if per is not None:
        blk = per.get(str(shard_id))
        if blk is None:
            raise FileNotFoundError(
                f"checkpoint {where}: no shard {shard_id} in manifest (has {sorted(per)})"
            )
        return blk
    if shard_id != 0:  # pre-§14 manifest: flat fields, single shard
        raise FileNotFoundError(
            f"checkpoint {where}: legacy single-shard manifest has no shard {shard_id}"
        )
    return manifest


def restore_arrays(
    ckpt_dir: str, *, step: Optional[int] = None, shard_id: int = 0
) -> tuple[dict, int]:
    """Manifest-driven flat restore — no ``like`` template required.

    The recovery path has no live object to mirror (the process that
    owned the shapes is gone), so the manifest is the source of truth:
    every key must load with exactly its recorded shape and dtype.
    ``shard_id`` selects one shard file of a sharded step manifest.
    Returns ``({key: ndarray}, step)``.
    """
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    manifest = _read_manifest(d)
    if manifest.get("kind", "full") == "diff":
        shards, step = restore_arrays_diff(ckpt_dir, step=step, only_shard=int(shard_id))
        return shards[int(shard_id)], int(step)
    blk = _shard_manifest(manifest, int(shard_id), d)
    with np.load(os.path.join(d, f"shard_{int(shard_id)}.npz"), allow_pickle=False) as data:
        if set(data.files) != set(blk["keys"]):
            raise ValueError(f"checkpoint {d}: shard {shard_id} npz keys disagree with manifest")
        out = {}
        for k in blk["keys"]:
            v = data[k]
            if list(v.shape) != blk["shapes"][k] or _dtype_name(v) != blk["dtypes"][k]:
                raise ValueError(
                    f"checkpoint {d}: {k} is {v.shape}/{v.dtype}, manifest says "
                    f"{blk['shapes'][k]}/{blk['dtypes'][k]}"
                )
            out[k] = v
    return out, int(step)


def restore_arrays_sharded(ckpt_dir: str, *, step: Optional[int] = None) -> tuple[dict, int]:
    """Restore every shard of a step: ``({shard_id: arrays}, step)``.

    Legacy single-shard manifests come back as ``{0: arrays}``;
    differential steps are resolved through their chain via
    :func:`restore_arrays_diff`.
    """
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    manifest = _read_manifest(d)
    if manifest.get("kind", "full") == "diff":
        return restore_arrays_diff(ckpt_dir, step=step)
    sids = (
        sorted(int(s) for s in manifest["shards"])
        if manifest.get("shards") is not None
        else [0]
    )
    return (
        {s: restore_arrays(ckpt_dir, step=step, shard_id=s)[0] for s in sids},
        int(step),
    )


def _patch_chunks(basev: np.ndarray, ids, dat: np.ndarray, digests, s: int, k: str):
    """A copy of ``basev`` with the chunks ``ids`` replaced by the packed
    bytes ``dat``, each verified against its manifest digest."""
    out = np.array(basev, order="C", copy=True)
    u8 = out.reshape(-1).view(np.uint8)
    mv = memoryview(u8)
    off = 0
    for i in ids:
        i = int(i)
        lo = i * CHUNK_BYTES
        hi = min(lo + CHUNK_BYTES, u8.shape[0])
        n = hi - lo
        u8[lo:hi] = dat[off : off + n]
        off += n
        if digests is not None and zlib.crc32(mv[lo:hi]) != digests[i]:
            raise ValueError(f"diff step {s}: chunk {i} of {k} fails its CRC digest")
    return out


def restore_arrays_diff(
    ckpt_dir: str, *, step: Optional[int] = None,
    only_shard: Optional[int] = None,
) -> tuple[dict, int]:
    """Chain-walking restore: ``({shard_id: arrays}, step)`` for any step.

    Walks ``base_step`` links back to a full checkpoint, loads that base,
    then patches each diff step's persisted chunks forward in order.
    Every patched chunk is verified against the manifest's CRC digest,
    and when the chain actually has diffs the BASE payload is verified
    against its own manifest digests first — patching chunks into a
    silently rotten base would otherwise launder the damage into a
    "successful" restore.  Any failure (missing step, corrupt manifest,
    CRC mismatch, cycle, shape drift) raises BEFORE any state escapes —
    the caller never sees partially patched arrays.  Works on full steps
    too (a chain of length one), so recovery can call this
    unconditionally.

    ``only_shard`` restricts the whole walk to one shard id; other shards
    are neither loaded nor verified.  A shard first materialized by a
    mid-chain diff (a shard-count change) simply has no base to load.
    """
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    chain, s, seen = [], int(step), set()
    while True:
        d = _step_dir(ckpt_dir, s)
        if not os.path.exists(os.path.join(d, "manifest.json")):
            raise FileNotFoundError(
                f"diff chain for step {step} broken: step {s} is missing from {ckpt_dir}"
            )
        try:
            man = _read_manifest(d)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ValueError(
                f"diff chain for step {step}: step {s} manifest is corrupt "
                f"({e}); restore aborted before patching"
            ) from e
        chain.append((s, d, man))
        if man.get("kind", "full") != "diff":
            break
        b = man.get("base_step")
        if b is None or int(b) >= s or s in seen:
            raise ValueError(f"diff chain corrupt at step {s} (base={b})")
        seen.add(s)
        s = int(b)
    chain.reverse()
    base_step, base_dir, base_man = chain[0]
    if only_shard is None:
        shards = {
            sid: dict(arrs)
            for sid, arrs in restore_arrays_sharded(ckpt_dir, step=base_step)[0].items()
        }
    else:
        try:
            arrs, _ = restore_arrays(ckpt_dir, step=base_step, shard_id=int(only_shard))
            shards = {int(only_shard): dict(arrs)}
        except FileNotFoundError:
            if len(chain) == 1:
                raise
            # the shard first appears in a later diff of the chain
            shards = {}
    if len(chain) > 1:
        # base-payload integrity gate: verify the loaded base bytes against
        # the base manifest's own chunk digests before any diff chunk
        # patches into them
        for sid, arrs in shards.items():
            blk = _shard_manifest(base_man, sid, base_dir)
            digests = blk.get("chunks")
            if digests is None:
                continue  # pre-§15 base manifest: nothing to check against
            for k, v in arrs.items():
                want = digests.get(k)
                if want is None:
                    continue
                got = _chunk_crcs(_byte_view(v))
                if got != want:
                    bad = [i for i, (a, b2) in enumerate(zip(want, got)) if a != b2][:4]
                    raise ValueError(
                        f"base step {base_step}: shard {sid} key {k} payload "
                        f"is corrupt (chunks {bad} fail their CRC digests); "
                        f"restore aborted before patching"
                    )
    for s, d, man in chain[1:]:
        for sid_s, blk in man["shards"].items():
            sid = int(sid_s)
            if only_shard is not None and sid != int(only_shard):
                continue
            cur = shards.get(sid, {})
            npz_path = os.path.join(d, f"shard_{sid}.npz")
            with (np.load(npz_path, allow_pickle=False) if os.path.exists(npz_path)
                  else contextlib.nullcontext()) as data:
                out = {}
                for k in blk["keys"]:
                    shape, dt = blk["shapes"][k], blk["dtypes"][k]
                    if data is not None and k in data.files:
                        v = data[k]
                    elif data is not None and f"{k}::idx" in data.files:
                        basev = cur.get(k)
                        if basev is None or list(basev.shape) != shape or _dtype_name(
                            basev
                        ) != dt:
                            raise ValueError(f"diff step {s}: no compatible base value for {k}")
                        v = _patch_chunks(basev, data[f"{k}::idx"], data[f"{k}::dat"],
                                          blk.get("chunks", {}).get(k), s, k)
                    else:
                        v = cur.get(k)
                        if v is None:
                            raise ValueError(
                                f"diff step {s}: {k} carried forward but absent from base"
                            )
                    if list(np.asarray(v).shape) != shape or _dtype_name(v) != dt:
                        raise ValueError(
                            f"diff step {s}: {k} is {np.asarray(v).shape}/{v.dtype},"
                            f" manifest says {shape}/{dt}"
                        )
                    out[k] = v
            shards[sid] = out
        # shard-count changes drop shards absent from the newest manifest
        shards = {int(x): shards[int(x)] for x in man["shards"] if int(x) in shards}
    if only_shard is not None and int(only_shard) not in shards:
        raise FileNotFoundError(
            f"checkpoint step {step}: no shard {only_shard} in the diff "
            f"chain (has {sorted(shards)})"
        )
    return shards, int(step)


def restore_shard_diff(
    ckpt_dir: str, shard_id: int, *, step: Optional[int] = None
) -> tuple[dict, int]:
    """Restore ONE shard's arrays through its diff chain: ``(arrays, step)``.

    Loads and verifies only ``shard_{shard_id}.npz`` files along the chain
    — the other shards' payloads are never read.
    """
    shards, s = restore_arrays_diff(ckpt_dir, step=step, only_shard=int(shard_id))
    return shards[int(shard_id)], s


def clean_stale(ckpt_dir: str) -> list[str]:
    """Sweep ``.tmp_ckpt_*`` debris left by writers that died pre-commit.

    Recovery calls this first: an interrupted checkpoint never renamed
    into place, so its tmp dir is garbage by construction.
    """
    removed = []
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            if name.startswith(".tmp_ckpt_"):
                shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
                removed.append(name)
    return removed


def _rotate(ckpt_dir: str, keep: int) -> None:
    """Drop all but the newest ``keep`` steps — chain-aware: the full
    base (and intermediate diffs) a kept diff step restores through are
    never rotated out from under it."""
    steps = sorted(all_steps(ckpt_dir))
    have = set(steps)
    keep_set = set(steps[-keep:]) if keep > 0 else set()
    frontier = list(keep_set)
    while frontier:
        s = frontier.pop()
        try:
            man = _read_manifest(_step_dir(ckpt_dir, s))
        except (OSError, json.JSONDecodeError):
            continue
        b = man.get("base_step")
        if b is not None and int(b) in have and int(b) not in keep_set:
            keep_set.add(int(b))
            frontier.append(int(b))
    for s in steps:
        if s not in keep_set:
            shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
            os.path.join(ckpt_dir, name, "manifest.json")
        ):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def step_shards(ckpt_dir: str, step: Optional[int] = None) -> tuple[int, int]:
    """``(step, n_shards)`` of ``step`` (the newest by default), read from its
    manifest alone."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return int(step), int(_read_manifest(_step_dir(ckpt_dir, step))["n_shards"])


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, like: Any, *, step: Optional[int] = None) -> tuple[Any, int]:
    """Restore into the structure of ``like``; returns (tree, step).

    Validates manifest keys/shapes against ``like`` first — a structure
    mismatch (code drift vs checkpoint) fails loudly before any device
    allocation.  A tensor leaf of ``like`` comes back as a tensor of its
    dtype on its device (a bfloat16 leaf's stored words reinterpreted bit
    for bit); another leaf with a dtype (a numpy array) as a CPU tensor of
    that dtype; a leaf without one as the stored numpy array.
    """
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    manifest = _read_manifest(d)
    want = dict(tree_mod.paths(like))
    missing = set(want) - set(manifest["keys"])
    extra = set(manifest["keys"]) - set(want)
    if missing or extra:
        raise ValueError(f"checkpoint mismatch: missing={missing} extra={extra}")
    leaves = {}
    with np.load(os.path.join(d, "shard_0.npz"), allow_pickle=False) as data:
        for k, leaf in want.items():
            if list(data[k].shape) != list(np.shape(leaf)):
                raise ValueError(f"shape mismatch for {k}: {data[k].shape} vs {np.shape(leaf)}")
        for k, leaf in want.items():
            v = data[k]
            # ascontiguousarray makes a 0-d array 1-d: keep the stored shape
            if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16 \
                    and v.dtype == BF16_WORDS:
                # the raw words, reinterpreted bit for bit
                v = torch.from_numpy(np.ascontiguousarray(v).reshape(v.shape).view(np.int16)) \
                    .view(torch.bfloat16).to(leaf.device)
            elif isinstance(leaf, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v).reshape(v.shape)).to(
                    device=leaf.device, dtype=leaf.dtype)
            elif hasattr(leaf, "dtype"):
                v = torch.from_numpy(
                    np.ascontiguousarray(v, dtype=leaf.dtype).reshape(v.shape))
            leaves[k] = v
    return tree_mod.unflatten(like, (leaves[k] for k, _ in tree_mod.paths(like))), int(step)


def checkpoint_hook(ckpt_dir: str, every: int, *, keep: int = 3):
    """Training-loop hook: persist state every N steps."""

    def hook(step: int, state):
        if step > 0 and step % every == 0:
            save(ckpt_dir, step, state, keep=keep)
        return state

    return hook
