"""Compiled row parser for fixed-width MTX bodies (the host side of
``io/mtx.py``'s fixed-width path).

The numpy fixed-width path costs ~8 full-matrix passes; this is the same
contract — fold the ids and the scientific weight of every row whose bytes
the caller has already bounds-verified against the row-0 layout — as ONE C
pass over the body.  It is built on demand with whatever ``cc`` the host
has into ``build/`` at the root of the checkout (keyed by a hash of the
source, so a fresh checkout builds once and an edited source rebuilds),
loaded via ctypes, and gated: any failure (no compiler, a host that will
not run it) leaves ``available()`` false and the numpy engine parses
instead.  Both fold the mantissa in float64 and apply the same decade
table, so they round identically to float32 (held bit for bit by the
tests).

``parse_fixed_rows.calls`` counts the calls that parsed rows in C, so a run
can show which parser it used.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

#: ``<checkout>/build`` (this file is ``<checkout>/src/repro_torch/io/``)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

_SOURCE = r"""
#include <stdint.h>

/* Folds only — the caller has already bounds-verified every byte (the
 * numpy masked compare is SIMD and ~10x what gcc emits for the same
 * loop here; the sequential per-row folds are where C wins).  All digit
 * groups fold as independent multiply-accumulates against power tables
 * — a Horner chain (v = v*10 + d) is a serially-dependent multiply per
 * digit and measured ~3x slower. */
static const int64_t IP10[19] = {
    1LL, 10LL, 100LL, 1000LL, 10000LL, 100000LL, 1000000LL, 10000000LL,
    100000000LL, 1000000000LL, 10000000000LL, 100000000000LL,
    1000000000000LL, 10000000000000LL, 100000000000000LL,
    1000000000000000LL, 10000000000000000LL, 100000000000000000LL,
    1000000000000000000LL,
};

/* rc: 0 ok, 2 coordinate out of [1, n_limit].  flags[0] <- 1 when the
 * (src, dst) stream is already lexicographically sorted (CSR order). */
int parse_fixed_rows(
    const uint8_t* restrict body, int64_t nnz, int32_t w,
    int32_t a0, int32_t b0, int32_t a1, int32_t b1,
    int32_t mstart, int32_t mdot, int32_t mend,
    int32_t estart, int32_t eend, int32_t esign_col, int32_t neg_col,
    const double* restrict p10e, int32_t e_bias, int64_t n_limit,
    int64_t* restrict src, int64_t* restrict dst, float* restrict wgt,
    int32_t* restrict flags)
{
    uint64_t nl = (uint64_t)n_limit;
    uint64_t oob = 0, prev_key = 0;
    int32_t sorted = 1;
    /* per-column powers of the mantissa (dot-aware), hoisted once */
    int64_t mpw[80];
    int32_t frac = 0;
    if (mstart >= 0) {
        int32_t nd = 0;
        for (int32_t j = mend - 1; j >= mstart; --j) {
            if (j == mdot) { mpw[j - mstart] = 0; continue; }
            mpw[j - mstart] = IP10[nd < 19 ? nd : 18];
            nd++;
            if (mdot >= 0 && j > mdot) frac++;
        }
    }
    /* two rows per iteration: each row's folds are a serial add chain,
     * so pairing rows gives the OoO core two independent chains */
    int64_t r = 0;
    for (; r + 2 <= nnz; r += 2) {
        const uint8_t* restrict ra = body + (int64_t)r * w;
        const uint8_t* restrict rb = ra + w;
        int64_t sa = 0, da = 0, sb = 0, db = 0;
        for (int32_t j = a0; j < b0; ++j) {
            sa += (int64_t)(ra[j] - '0') * IP10[b0 - 1 - j];
            sb += (int64_t)(rb[j] - '0') * IP10[b0 - 1 - j];
        }
        for (int32_t j = a1; j < b1; ++j) {
            da += (int64_t)(ra[j] - '0') * IP10[b1 - 1 - j];
            db += (int64_t)(rb[j] - '0') * IP10[b1 - 1 - j];
        }
        src[r] = sa; src[r + 1] = sb;
        dst[r] = da; dst[r + 1] = db;
        oob |= ((uint64_t)(sa - 1) >= nl) | ((uint64_t)(da - 1) >= nl)
             | ((uint64_t)(sb - 1) >= nl) | ((uint64_t)(db - 1) >= nl);
        uint64_t ka = ((uint64_t)sa << 32) | (uint64_t)da;
        uint64_t kb = ((uint64_t)sb << 32) | (uint64_t)db;
        sorted &= (ka >= prev_key) & (kb >= ka);
        prev_key = kb;
        if (mstart >= 0) {
            int64_t ma = 0, mb = 0;
            for (int32_t j = mstart; j < mend; ++j) {
                ma += (int64_t)(ra[j] - '0') * mpw[j - mstart];
                mb += (int64_t)(rb[j] - '0') * mpw[j - mstart];
            }
            /* the dot column's power is 0, so its byte contributes 0 */
            int32_t ea = 0, eb = 0;
            for (int32_t j = estart; j < eend; ++j) {
                ea += (int32_t)(ra[j] - '0') * (int32_t)IP10[eend - 1 - j];
                eb += (int32_t)(rb[j] - '0') * (int32_t)IP10[eend - 1 - j];
            }
            if (esign_col >= 0 && ra[esign_col] == '-') ea = -ea;
            if (esign_col >= 0 && rb[esign_col] == '-') eb = -eb;
            int32_t ka = ea - frac + e_bias;
            int32_t kb = eb - frac + e_bias;
            if (ka < 0) ka = 0;
            if (ka > 2 * e_bias) ka = 2 * e_bias;
            if (kb < 0) kb = 0;
            if (kb > 2 * e_bias) kb = 2 * e_bias;
            double va = (double)ma * p10e[ka];
            double vb = (double)mb * p10e[kb];
            wgt[r] = (float)(neg_col >= 0 && ra[neg_col] == '-' ? -va : va);
            wgt[r + 1] =
                (float)(neg_col >= 0 && rb[neg_col] == '-' ? -vb : vb);
        }
    }
    for (; r < nnz; ++r) {
        const uint8_t* restrict row = body + (int64_t)r * w;
        int64_t s = 0, d = 0;
        for (int32_t j = a0; j < b0; ++j)
            s += (int64_t)(row[j] - '0') * IP10[b0 - 1 - j];
        for (int32_t j = a1; j < b1; ++j)
            d += (int64_t)(row[j] - '0') * IP10[b1 - 1 - j];
        src[r] = s;
        dst[r] = d;
        oob |= ((uint64_t)(s - 1) >= nl) | ((uint64_t)(d - 1) >= nl);
        uint64_t key = ((uint64_t)s << 32) | (uint64_t)d;
        sorted &= (key >= prev_key);
        prev_key = key;
        if (mstart >= 0) {
            int64_t mi = 0;
            for (int32_t j = mstart; j < mend; ++j)
                mi += (int64_t)(row[j] - '0') * mpw[j - mstart];
            int32_t e = 0;
            for (int32_t j = estart; j < eend; ++j)
                e += (int32_t)(row[j] - '0') * (int32_t)IP10[eend - 1 - j];
            if (esign_col >= 0 && row[esign_col] == '-') e = -e;
            int32_t k = e - frac + e_bias;
            if (k < 0) k = 0;
            if (k > 2 * e_bias) k = 2 * e_bias;
            double v = (double)mi * p10e[k];
            wgt[r] = (float)(neg_col >= 0 && row[neg_col] == '-' ? -v : v);
        }
    }
    flags[0] = sorted;
    return oob ? 2 : 0;
}
"""

_lock = threading.Lock()
_lib = None
_failed = False


def _so_path() -> Path:
    h = hashlib.sha256(_SOURCE.encode()).hexdigest()[:16]
    return BUILD_DIR / f"cparse-{h}" / "cparse.so"


def _build():
    """Compile the parser with the host cc (once per source); None on any
    failure."""
    so = _so_path()
    if not so.exists():
        _compile(so)
    return _load(so) if so.exists() else None


def _compile(so: Path) -> None:
    tmp = so.parent.with_name(f"{so.parent.name}.tmp{os.getpid()}")
    try:
        tmp.mkdir(parents=True, exist_ok=True)
        src = tmp / "cparse.c"
        tmp_so = tmp / "cparse.so"
        src.write_text(_SOURCE)
        attempts = [
            [cc, "-O3", *extra, "-shared", "-fPIC", "-o", str(tmp_so), str(src)]
            for cc in ("cc", "gcc", "clang")
            for extra in (["-march=native"], [])
        ]
        for cmd in attempts:
            try:
                r = subprocess.run(cmd, capture_output=True, timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                continue
            if r.returncode == 0 and tmp_so.exists():
                so.parent.mkdir(parents=True, exist_ok=True)
                os.replace(tmp_so, so)  # atomic vs concurrent builds
                return
    except OSError:
        return
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _load(so: Path):
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    fn = lib.parse_fixed_rows
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    return fn


def available() -> bool:
    """True once the parser is built and loaded (built on the first call)."""
    global _lib, _failed
    if _lib is not None:
        return True
    if _failed:
        return False
    with _lock:
        if _lib is None and not _failed:
            try:
                _lib = _build()
            except Exception:
                _lib = None
            if _lib is None:
                _failed = True
    return _lib is not None


def parse_fixed_rows(body, nnz, w, ints, flt, p10e, e_bias, n_limit):
    """Per-row digit folds (bytes must already be bounds-verified).

    ``ints`` = ((a0, b0), (a1, b1)) digit column ranges of the id fields;
    ``flt`` = (mstart, mdot, mend, estart, eend, esign_col, neg_col) or
    None for pattern files (every position -1 disables that feature).
    Returns (src, dst, wgt|None, presorted) or None when the parser is
    unavailable; raises ValueError on a 1-based id outside [1, n_limit].
    """
    if not available():
        return None
    body = np.ascontiguousarray(body)
    src = np.empty(nnz, np.int64)
    dst = np.empty(nnz, np.int64)
    flags = np.zeros(1, np.int32)
    if flt is None:
        mstart = mdot = mend = estart = eend = esign_col = neg_col = -1
        wgt = np.empty(1, np.float32)
    else:
        mstart, mdot, mend, estart, eend, esign_col, neg_col = flt
        wgt = np.empty(nnz, np.float32)
    rc = _lib(
        body.ctypes.data, nnz, w,
        ints[0][0], ints[0][1], ints[1][0], ints[1][1],
        mstart, mdot, mend, estart, eend, esign_col, neg_col,
        p10e.ctypes.data, e_bias, n_limit,
        src.ctypes.data, dst.ctypes.data, wgt.ctypes.data,
        flags.ctypes.data,
    )
    with _lock:
        parse_fixed_rows.calls += 1
    if rc == 2:
        raise ValueError("malformed MTX body: coordinate out of range")
    if rc != 0:
        return None
    return src, dst, (wgt if flt is not None else None), bool(flags[0])


parse_fixed_rows.calls = 0
