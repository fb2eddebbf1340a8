"""MTX ingest engine (paper Algorithms 3–5, DESIGN.md §10), PyTorch port.

The paper's loader wins by (a) block-partitioned parallel byte parsing,
(b) per-partition degree counting, (c) shifted-offset CSR fill with no
post-processing pass.  The pipeline, the same as ``repro``'s on the host:

  tokenize   ONE separator-mask pass (``byte > 32``) + shift gives every
             token's [start, end) span; token *count* is validated
             against the header's nnz so truncated or malformed bodies
             raise instead of silently loading a partial graph.
  parse      each field column becomes a small [T, L] byte matrix whose
             digits are folded with one table-gathered power-of-10
             multiply — a constant ~10 vectorized passes total, no
             python per line OR per digit.  Files written by our own
             ``write_mtx`` hit a *fixed-width fast path*: uniform line
             length is detected, the body reshapes to [nnz, W], every
             byte is bounds-checked in one pass, and the per-row folds
             run in the compiled row parser (``io/_cparse.py``), which
             also observes whether the edges are already in CSR order.
  build      ``core/csr.from_coo`` on the target device: on a GPU the
             device build (one sort, skipped for files in CSR order,
             then the ``degree_offsets`` CUDA kernel); on the CPU the
             host packed-key radix sort.  ``load_digraph`` then builds
             the DiGraph arena image.

Files larger than ``mmap_threshold`` stream through ``np.memmap`` in
newline-aligned chunks, so ingest never materializes the file in RAM.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

import numpy as np

from ..core import csr as csr_mod
from ..core import util
from . import _cparse

#: gate for the optional compiled row parser (see io/_cparse.py); the
#: numpy engine below is the always-available reference implementation
USE_C_PARSE = True

_NL = 10  # \n

# power tables: P10I[k] = 10^k (int64), P10F[k] = 10^k (f64) with a zero
# guard slot at index GUARD for masked (non-digit) cells, REP*[k] = the
# repunit 1+10+...+10^(k-1) used to fold the ASCII '0' bias out of a
# digit-matrix dot product in one step.
_GUARD = 20
_P10I = np.zeros(_GUARD + 1, np.int64)
_P10I[:19] = 10 ** np.arange(19, dtype=np.int64)
_P10F = np.zeros(_GUARD + 1, np.float64)
_P10F[:19] = 10.0 ** np.arange(19)
_REPI = np.cumsum(np.concatenate([[0], _P10I[:19]])).astype(np.int64)
_REPF = _REPI.astype(np.float64)
# full-range f64 decade table for applying decimal exponents (underflows
# to 0.0 below ~1e-323, overflows to inf above 1e308 — matching strtod)
_E_BIAS = 350
with np.errstate(over="ignore"):
    _P10E = np.power(10.0, np.arange(-_E_BIAS, _E_BIAS + 1))


@dataclasses.dataclass
class MtxHeader:
    symmetric: bool
    weighted: bool
    rows: int
    cols: int
    nnz: int
    header_end: int  # byte offset where data lines start

    @property
    def n_fields(self) -> int:
        return 3 if self.weighted else 2


def read_header(buf: bytes) -> MtxHeader:
    """readHeader() of Alg 3."""
    pos = 0
    first = buf[: buf.index(b"\n")].decode()
    if not first.startswith("%%MatrixMarket"):
        raise ValueError("not an MTX file")
    toks = first.lower().split()
    weighted = "pattern" not in toks
    symmetric = "symmetric" in toks
    # skip comment lines
    while True:
        end = buf.index(b"\n", pos)
        line = buf[pos : end + 1]
        if not line.startswith(b"%"):
            break
        pos = end + 1
    dims = buf[pos : buf.index(b"\n", pos)].split()
    if len(dims) < 3:
        raise ValueError("malformed MTX size line")
    rows, cols, nnz = int(dims[0]), int(dims[1]), int(dims[2])
    header_end = buf.index(b"\n", pos) + 1
    return MtxHeader(symmetric, weighted, rows, cols, nnz, header_end)


# ---------------------------------------------------------------------------
# tokenizer — one separator-mask pass over the byte buffer
# ---------------------------------------------------------------------------
def _token_spans(body: np.ndarray):
    """Token [start, end) spans: every byte > 32 is token material."""
    num = body > 32
    ts = num.copy()
    ts[1:] &= ~num[:-1]
    te = num.copy()
    te[:-1] &= ~num[1:]
    starts = np.flatnonzero(ts)
    lens = np.flatnonzero(te) + 1 - starts
    return starts, lens


def _field_matrix(body: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """Gather token bytes into a [T, L] matrix (L = longest token).

    Index math runs in int32 when the body allows it (halves the traffic
    of every positional pass downstream) and falls back to int64 for
    bodies >= 2 GiB fed in as one buffer.
    """
    t = starts.shape[0]
    lmax = int(lens.max()) if t else 1
    if lmax > 32:
        raise ValueError("malformed MTX body: token longer than 32 bytes")
    idt = np.int32 if body.shape[0] + 33 < 2**31 else np.int64
    lane = np.arange(lmax, dtype=idt)
    idx = starts.astype(idt)[:, None] + lane
    np.minimum(idx, idt(body.shape[0] - 1), out=idx)
    mat = body[idx]
    inrow = lane < lens.astype(idt)[:, None]
    return mat, inrow, lane


def _parse_int_tokens(body, starts, lens) -> np.ndarray:
    """Vectorized atoi of T tokens -> int64 (digits only; MTX coordinates)."""
    if starts.shape[0] == 0:
        return np.zeros(0, np.int64)
    mat, inrow, lane = _field_matrix(body, starts, lens)
    if not (((mat - np.uint8(48)) < 10) | ~inrow).all():
        raise ValueError("malformed MTX body: non-digit byte in index field")
    if int(lens.max()) > 19:
        raise ValueError("malformed MTX body: integer field overflows int64")
    # an all-digit token's byte at lane j weighs 10^(len-1-j); the repunit
    # correction removes the ASCII '0' bias in the same dot product.
    # Beyond-token lanes clip to -1, which wraps to the table's 0 guard.
    l32 = lens.astype(np.int32)
    w = _P10I[np.clip(l32[:, None] - 1 - lane, -1, 19)]
    return (mat * w).sum(axis=1) - 48 * _REPI[np.minimum(lens, 19)]


def _parse_float_tokens(body, starts, lens) -> np.ndarray:
    """Vectorized strtod of T tokens -> f64 (sign, '.', e/E exponents).

    A well-formed number is ``[sign] digits [. digits] [e [sign] digits]``
    so every digit's rank is *positional arithmetic* — no per-row cumsum
    (numpy's axis-1 cumsum costs more than the rest of the parse
    combined).  Structure bytes are located with argmax, digit weights
    come from one power-table gather, and the whole mantissa folds in a
    single masked dot product.
    """
    if starts.shape[0] == 0:
        return np.zeros(0, np.float64)
    mat, inrow, lane = _field_matrix(body, starts, lens)
    lmax = mat.shape[1]
    isd = ((mat - np.uint8(48)) < 10) & inrow
    ise = ((mat == 101) | (mat == 69)) & inrow
    isdot = (mat == 46) & inrow
    issign = ((mat == 45) | (mat == 43)) & inrow
    if not (isd | ise | isdot | issign | ~inrow).all():
        raise ValueError("malformed MTX body: bad byte in value field")
    l32 = lens.astype(np.int32)
    has_e = ise.any(axis=1)
    epos = np.where(has_e, ise.argmax(axis=1).astype(np.int32), l32)
    hasdot = isdot.any(axis=1)
    dotpos = np.where(hasdot, isdot.argmax(axis=1).astype(np.int32), lmax)
    sgn = issign[:, 0].astype(np.int32)                  # leading sign byte?
    # exponent-part sign byte sits right after 'e'
    es_b = np.take_along_axis(
        mat, np.minimum(epos + 1, lmax - 1)[:, None], axis=1
    )[:, 0]
    esgn = (has_e & ((es_b == 45) | (es_b == 43))).astype(np.int32)
    # structural validation: one dot before 'e', signs only in slot 0 or
    # after 'e', at least one digit on each side
    cntm = epos - sgn - hasdot
    cnte = np.where(has_e, l32 - epos - 1 - esgn, 0)
    sign_ok = issign.copy()
    sign_ok[:, 0] = False
    # only rows WITH an exponent get their e-sign lane cleared; rows
    # without one point at lane 0 (already cleared), so a trailing sign
    # byte on a max-length no-exponent token still flags as malformed
    np.put_along_axis(
        sign_ok,
        np.where(has_e, np.minimum(epos + 1, lmax - 1), 0)[:, None],
        False,
        axis=1,
    )
    if (
        (isdot.sum(axis=1) > 1).any()
        or sign_ok.any()
        or (cntm <= 0).any()
        or (has_e & (cnte <= 0)).any()
        or (hasdot & (dotpos > epos)).any()
        or int(cntm.max(initial=0)) > 19
        or int(cnte.max(initial=0)) > 18
    ):
        raise ValueError("malformed MTX body: unparseable value field")
    # mantissa fold with NO 2-D masking: digit at lane j weighs
    # 10^(cntm-1+sgn - j + (j > dotpos)); lanes past the mantissa go
    # negative and clip to the table's 0 guard.  The sign and dot bytes
    # do pick up a weight — their known contributions are subtracted as
    # per-row scalars afterwards, which is far cheaper than masking every
    # cell of the matrix.
    expo = (cntm - 1 + sgn)[:, None] - lane + (lane > dotpos[:, None])
    d_val = (mat * _P10F[np.clip(expo, -1, 19)]).sum(axis=1)
    frac = np.where(hasdot, epos - dotpos - 1, 0)
    d_val -= 48.0 * _REPF[cntm]                           # ASCII digit bias
    d_val -= np.where(hasdot, 46.0 * _P10F[np.clip(frac - 1, -1, 19)], 0.0)
    d_val -= np.where(
        sgn > 0, mat[:, 0] * _P10F[np.clip(cntm, 0, 19)], 0.0
    )
    exp10 = (-frac).astype(np.int64)
    if has_e.any():
        # exponent fold: weight 10^(cnte + epos + esgn - j) right of the
        # sign byte; everything at or left of it is masked (mantissa
        # lanes would otherwise alias into small positive exponents)
        expo_e = (cnte + epos + esgn)[:, None] - lane
        w_e = _P10I[np.clip(expo_e, -1, 19)]
        w_e *= lane > (epos + esgn)[:, None]
        e_val = (mat * w_e).sum(axis=1) - 48 * _REPI[cnte]
        exp10 += np.where(es_b == 45, -e_val, e_val)
    neg = mat[:, 0] == 45
    scale = _P10E[np.clip(exp10 + _E_BIAS, 0, 2 * _E_BIAS)]
    return np.where(neg, -d_val, d_val) * scale


# ---------------------------------------------------------------------------
# fixed-width fast path (files written by our write_mtx, or any aligned
# writer): the body reshapes to [nnz, W] and fields are column slices
# ---------------------------------------------------------------------------
#: reusable scratch buffers (pow-2 row bucketed, thread-local so the
#: partition-parallel parse never shares one) — the fixed-path parser
#: runs hot in benchmarks and loaders; re-mmapping multi-MB temporaries
#: on every call costs more in page faults than the arithmetic itself
_scratch_tls = threading.local()


def _scratch(tag: str, shape: tuple, dtype) -> np.ndarray:
    cache = getattr(_scratch_tls, "cache", None)
    if cache is None:
        cache = _scratch_tls.cache = {}
    rows = 1 << max(int(shape[0]) - 1, 1).bit_length()
    key = (tag, rows, shape[1:], np.dtype(dtype).str)
    buf = cache.get(key)
    if buf is None:
        buf = cache[key] = np.empty((rows,) + tuple(shape[1:]), dtype)
    return buf[: shape[0]]


class _Fields(list):
    """Parsed field columns + provenance flags from the compiled path.

    ``validated``: ids already range-checked against the header dims;
    ``presorted``: the (src, dst) stream was observed in CSR order.
    """

    validated = False
    presorted = None


def _joined(parts, n_fields: int) -> _Fields:
    """Concatenate parsed parts (partitions or chunks, in file order).

    The joined stream is ``validated`` when every part is, and
    ``presorted`` when every part was observed in CSR order and each
    part's last (src, dst) key is at most the next non-empty part's first
    (False when a part or a seam is out of order, None when a part is
    unobserved).
    """
    out = _Fields(np.concatenate([p[f] for p in parts]) for f in range(n_fields))
    out.validated = all(getattr(p, "validated", False) for p in parts)
    flags = [getattr(p, "presorted", None) for p in parts]
    if False in flags:
        out.presorted = False
    elif None not in flags:
        keyed = [p for p in parts if p[0].shape[0]]
        out.presorted = all(
            (int(a[0][-1]), int(a[1][-1])) <= (int(b[0][0]), int(b[1][0]))
            for a, b in zip(keyed, keyed[1:])
        )
    return out


def _digit_chunks(cols: list[int]):
    """Split a digit-column group into f32-exact dot-product chunks.

    A chunk of <= 6 decimal digits keeps every partial sum of the fold
    below 2^24 (raw ASCII bytes <= 57 x repunit(6) ~ 6.3e6), so its dot
    product with a power vector is exact in float32 — which lets ALL
    digit groups of a fixed-width file fold through ONE sgemm.  Returns
    [(cols, scale10)] where the chunk contributes value * 10^scale10
    (before the ASCII '0' bias is removed).
    """
    out = []
    k = len(cols)
    pos = 0
    while pos < k:
        take = min(6, k - pos)
        out.append((cols[pos : pos + take], k - pos - take))
        pos += take
    return out


def _parse_fixed(body: np.ndarray, nnz: int, n_fields: int,
                 n_limit: Optional[int] = None):
    """Column-sliced parse of a uniform-width body; None when not fixed.

    Layout is derived from row 0, then verified for EVERY row with one
    per-column min/max pass: digit columns must stay in '0'..'9',
    structural columns (separators, '.', 'e', newline) must be constant,
    and sign columns must stay in {' ', '-'} / {'+', '-'}.  Any mismatch
    (ragged ids, shifting layouts) falls back to the general tokenizer.
    All digit folding then happens in a single [nnz, W] @ [W, C] sgemm.
    """
    size = body.shape[0]
    if nnz == 0 or size % nnz:
        return None
    w = size // nnz
    if w < 2 * n_fields or w > 80 or body[w - 1] != _NL:
        return None
    if not (body[w - 1 :: w] == _NL).all():
        return None
    mat = body[: nnz * w].reshape(nnz, w)
    row0 = body[:w]
    spans, t0 = [], None
    for j in range(w):
        if row0[j] > 32 and t0 is None:
            t0 = j
        elif row0[j] <= 32 and t0 is not None:
            spans.append((t0, j))
            t0 = None
    if len(spans) != n_fields:
        return None

    # column classification (from row 0)
    digit_cols: set[int] = set()
    fields = []  # per field: list of (chunk_cols, scale)
    sign_cols: list[int] = []
    esign_col = frac = None
    e_cols: list[int] = []
    neg_col = None
    flt_layout = None  # (mstart, mdot, mend) for the compiled path
    for f, (a, b) in enumerate(spans):
        cols = list(range(a, b))
        if f < 2:
            digit_cols.update(cols)
            fields.append(_digit_chunks(cols))
            continue
        # float field: [sign] d [. ddd] [e [sign] dd]
        if row0[a] == 45:
            neg_col, a = a, a + 1
        elif a > 0:
            neg_col = a - 1
            sign_cols.append(neg_col)
        rel = body[a:b]
        e_at = np.flatnonzero((rel == 101) | (rel == 69))
        if e_at.shape[0] > 1:
            return None
        e_pos = a + int(e_at[0]) if e_at.shape[0] else b
        dot_at = np.flatnonzero(rel[: e_pos - a] == 46)
        if dot_at.shape[0] > 1:
            return None
        dot_pos = a + int(dot_at[0]) if dot_at.shape[0] else e_pos
        mant = [j for j in range(a, e_pos) if j != dot_pos]
        if not mant:
            return None
        digit_cols.update(mant)
        frac = e_pos - dot_pos - 1 if dot_at.shape[0] else 0
        flt_layout = (a, dot_pos, e_pos)
        fields.append(_digit_chunks(mant))
        if e_at.shape[0]:
            es = e_pos + 1
            if es >= b:
                return None
            if row0[es] in (43, 45):
                esign_col = es
                es += 1
            e_cols = list(range(es, b))
            if not e_cols or len(e_cols) > 18:
                return None
            digit_cols.update(e_cols)

    # one whole-matrix bounds pass verifies every row against the row-0
    # layout: digit columns stay in '0'..'9', structural columns constant.
    # (mat - lo) > span with uint8 wraparound is a single masked compare.
    lo = row0.copy()
    span = np.zeros(w, np.uint8)
    for j in digit_cols:
        lo[j], span[j] = 48, 9
    free = [j for j in range(w) if j == neg_col or j in sign_cols
            or j == esign_col]
    for j in free:
        lo[j], span[j] = 0, 255  # two-valued columns checked below
    # flat tiled bounds: broadcasting [nnz, w] against [w] runs one
    # 26-byte SIMD stanza per row (all overhead); tiling lo/span to the
    # full body length (cached per layout) makes each pass ONE long
    # vector op
    nb = nnz * w
    cache = getattr(_scratch_tls, "cache", None)
    if cache is None:
        cache = _scratch_tls.cache = {}
    lkey = (w, lo.tobytes(), span.tobytes())
    if cache.get("bounds_layout") != lkey or cache["bounds_lo"].shape[0] < nb:
        reps = -(-max(nb, 1) // w)
        cache["bounds_lo"] = np.tile(lo, reps)
        cache["bounds_span"] = np.tile(span, reps)
        cache["bounds_layout"] = lkey
    flat = mat.reshape(-1)
    rs = _scratch("resid", (nb,), np.uint8)
    viol = _scratch("viol", (nb,), bool)
    np.subtract(flat, cache["bounds_lo"][:nb], out=rs)
    np.greater(rs, cache["bounds_span"][:nb], out=viol)
    if viol.any():
        return None
    m1 = _scratch("free_m1", (nnz,), bool)
    m2 = _scratch("free_m2", (nnz,), bool)
    for j in free:
        col = mat[:, j]
        allowed = (43, 45) if j == esign_col else (32, 45)
        np.equal(col, allowed[0], out=m1)
        np.equal(col, allowed[1], out=m2)
        np.logical_or(m1, m2, out=m1)
        if not m1.all():
            return None

    # every byte is now verified; the folds run through the compiled
    # row parser when available (numpy does the SIMD-friendly masked
    # compare above, C does the sequential per-row Horner folds — each
    # side doing what it is fastest at), with the sgemm formulation
    # below as the always-available fallback
    if (
        USE_C_PARSE
        and n_limit is not None
        and spans[0][1] - spans[0][0] <= 18
        and spans[1][1] - spans[1][0] <= 18
        and (
            flt_layout is None
            or flt_layout[2] - flt_layout[0] <= 16  # f64-exact mantissa
        )
    ):
        flt = None
        if flt_layout is not None:
            mstart, mdot, mend = flt_layout
            estart, eend = (e_cols[0], e_cols[-1] + 1) if e_cols else (-1, -1)
            flt = (
                mstart, mdot, mend, estart, eend,
                -1 if esign_col is None else esign_col,
                -1 if neg_col is None else neg_col,
            )
        got = _cparse.parse_fixed_rows(
            mat, nnz, w, (spans[0], spans[1]), flt, _P10E, _E_BIAS,
            int(n_limit),
        )
        if got is not None:
            src_c, dst_c, wgt_c, presorted = got
            out = _Fields(
                [src_c, dst_c] + ([wgt_c] if wgt_c is not None else [])
            )
            out.validated = True
            out.presorted = presorted
            return out

    # fold every digit chunk — exponent digits included — with ONE sgemm
    # (f32-exact by construction, see _digit_chunks).  Whole-matrix
    # passes over reusable scratch: sequential streams prefetch well,
    # and scratch reuse (not fresh allocations) is what keeps repeat
    # loads from re-faulting pages.  (A cache-tiled variant was tried
    # and lost — per-tile BLAS dispatch overhead exceeded the DRAM
    # traffic it saved.)
    chunk_list = [c for fchunks in fields for c in fchunks]
    e_chunks = _digit_chunks(e_cols) if e_cols else []
    chunk_list += e_chunks
    wmat = np.zeros((w, len(chunk_list)), np.float32)
    for ci, (cols, _) in enumerate(chunk_list):
        k = len(cols)
        wmat[cols, ci] = 10.0 ** np.arange(k - 1, -1, -1, dtype=np.float32)
    mt = _scratch("matf", (nnz, w), np.float32)
    np.copyto(mt, mat, casting="unsafe")
    folded = np.matmul(
        mt, wmat, out=_scratch("folded", (nnz, len(chunk_list)), np.float32)
    )

    # scalar tail: every [nnz]-sized intermediate lives in scratch and
    # every op writes in place — only the three returned arrays allocate
    # (fresh multi-hundred-KB temporaries re-fault pages on every call
    # once other loaders have churned the allocator)
    def fold_into(fchunks, base, out64):
        # chunks combine as Σ chunk_i · 10^s_i; the per-chunk ASCII '0'
        # biases (48 · repunit) collapse into ONE constant subtracted at
        # the end, so an f-field folds in len(chunks)+1 passes
        bias = 0.0
        for off, (cols, scale) in enumerate(fchunks):
            col = folded[:, base + off]
            bias += 48.0 * float(_REPF[len(cols)]) * float(_P10F[scale])
            # np.float64 scalars force the f64 ufunc loop — a bare python
            # float is NEP-50-weak and would fold the >2^24 digit values
            # in f32
            if off == 0:
                if scale:
                    np.multiply(col, np.float64(_P10F[scale]), out=out64)
                else:
                    np.copyto(out64, col)
            elif scale:
                tmp = _scratch("fold_tmp", (nnz,), np.float64)
                np.multiply(col, np.float64(_P10F[scale]), out=tmp)
                np.add(out64, tmp, out=out64)
            else:
                np.add(out64, col, out=out64)
        if bias:
            np.subtract(out64, np.float64(bias), out=out64)
        return out64

    out = []
    ci = 0
    val = _scratch("fold_val", (nnz,), np.float64)
    mask = _scratch("fold_mask", (nnz,), bool)
    for f, fchunks in enumerate(fields):
        fold_into(fchunks, ci, val)
        ci += len(fchunks)
        if f < 2:
            ints = np.empty(nnz, np.int64)
            np.copyto(ints, val, casting="unsafe")
            out.append(ints)
            continue
        if neg_col is not None:
            np.equal(mat[:, neg_col], 45, out=mask)
            np.negative(val, out=val, where=mask)
        if e_chunks:
            e_val = _scratch("fold_eval", (nnz,), np.float64)
            fold_into(e_chunks, ci, e_val)
            if esign_col is not None:
                np.equal(mat[:, esign_col], 45, out=mask)
                np.negative(e_val, out=e_val, where=mask)
            # decade lookup: exp10 = e_val - frac, biased into the table
            np.add(e_val, float(_E_BIAS - frac), out=e_val)
            np.clip(e_val, 0, 2 * _E_BIAS, out=e_val)
            idx = _scratch("fold_idx", (nnz,), np.int64)
            np.copyto(idx, e_val, casting="unsafe")
            scale64 = _scratch("fold_scale", (nnz,), np.float64)
            np.take(_P10E, idx, out=scale64)
            np.multiply(val, scale64, out=val)
        else:
            np.multiply(val, float(_P10E[_E_BIAS - frac]), out=val)
        # emit float32 directly — the CSR weight dtype — halving the
        # output traffic and sparing the assemble-stage astype
        res = np.empty(nnz, np.float32)
        np.copyto(res, val, casting="unsafe")
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# edgelist assembly (Alg 4)
# ---------------------------------------------------------------------------
#: bodies below this size (32 MiB) parse single-threaded: the partition
#: fan-out is the paper's Alg 4 structure and wins on large bodies, but
#: below this its thread dispatch costs more than it saves on a host with
#: few cores; tests force it down to exercise the path.
_PARALLEL_MIN_BYTES = 1 << 25
_pool = None


def _parse_pool():
    global _pool
    if _pool is None:
        from concurrent.futures import ThreadPoolExecutor

        _pool = ThreadPoolExecutor(max_workers=os.cpu_count() or 1)
    return _pool


def _parse_body(body: np.ndarray, n_fields: int, *, fixed: bool = True,
                nnz_hint: Optional[int] = None, num_partitions: int = 1,
                n_limit: Optional[int] = None):
    """Parse one newline-complete body slice -> list of n_fields columns.

    ``num_partitions`` > 1 block-partitions the byte buffer and parses
    the partitions on a thread pool — the paper's Alg 4 parallel parse;
    numpy releases the GIL inside every pass, so partitions genuinely
    overlap.  Fixed-width bodies split at exact row boundaries, general
    bodies at the nearest newline.
    """
    rho = min(max(int(num_partitions), 1), os.cpu_count() or 1)
    if rho > 1 and body.shape[0] >= _PARALLEL_MIN_BYTES:
        chunks = _partition_body(body, rho, nnz_hint)
        if len(chunks) > 1:
            futs = [
                _parse_pool().submit(
                    _parse_body, body[a:b], n_fields,
                    fixed=fixed, nnz_hint=rows, num_partitions=1,
                    n_limit=n_limit,
                )
                for a, b, rows in chunks
            ]
            return _joined([f.result() for f in futs], n_fields)
    if fixed and nnz_hint:
        got = _parse_fixed(body, nnz_hint, n_fields, n_limit)
        if got is not None:
            return got
    starts, lens = _token_spans(body)
    t = starts.shape[0]
    if t % n_fields:
        raise ValueError(
            f"malformed MTX body: {t} tokens is not a multiple of "
            f"{n_fields} fields"
        )
    rows = t // n_fields
    smat = starts.reshape(rows, n_fields)
    lmat = lens.reshape(rows, n_fields)
    # both index fields parse as one token batch (halves the pass count)
    ii = _parse_int_tokens(
        body,
        np.ascontiguousarray(smat[:, :2]).reshape(-1),
        np.ascontiguousarray(lmat[:, :2]).reshape(-1),
    ).reshape(rows, 2)
    out = [ii[:, 0], ii[:, 1]]
    if n_fields == 3:
        out.append(
            np.ascontiguousarray(
                _parse_float_tokens(
                    body,
                    np.ascontiguousarray(smat[:, 2]),
                    np.ascontiguousarray(lmat[:, 2]),
                )
            )
        )
    return out


def _partition_body(body: np.ndarray, rho: int, nnz_hint: Optional[int]):
    """Split a body into <= rho newline-aligned (start, end, rows) chunks."""
    size = body.shape[0]
    if nnz_hint and size % nnz_hint == 0:
        w = size // nnz_hint
        if w >= 2 and (body[w - 1 :: w] == _NL).all():
            # fixed-width: split at exact row boundaries
            rpc = -(-nnz_hint // rho)
            return [
                (i * rpc * w, min((i + 1) * rpc, nnz_hint) * w,
                 min((i + 1) * rpc, nnz_hint) - i * rpc)
                for i in range(rho)
                if i * rpc < nnz_hint
            ]
    out = []
    pos = 0
    step = -(-size // rho)
    while pos < size:
        end = min(pos + step, size)
        if end < size:
            nl = np.flatnonzero(body[end - 1 : min(end + (1 << 16), size)] == _NL)
            if nl.shape[0] == 0:
                end = size
            else:
                end = end + int(nl[0])
        out.append((pos, end, None))
        pos = end
    return out


def parse_edgelist(buf, header: MtxHeader, *, fixed: bool = True,
                   num_partitions: int = 1):
    """readEdgelist() of Alg 4, vectorized; validates the line count."""
    return _parse_edgelist_full(
        buf, header, fixed=fixed, num_partitions=num_partitions
    )[:3]


def _parse_edgelist_full(buf, header: MtxHeader, *, fixed: bool = True,
                         num_partitions: int = 1):
    """parse_edgelist + the compiled path's presorted observation."""
    data = np.frombuffer(buf, dtype=np.uint8)
    body = data[header.header_end :]
    fields = _parse_body(
        body, header.n_fields, fixed=fixed, nnz_hint=header.nnz,
        num_partitions=num_partitions,
        n_limit=max(header.rows, header.cols),
    )
    if fields[0].shape[0] != header.nnz:
        raise ValueError(
            f"truncated MTX body: header promises {header.nnz} entries, "
            f"parsed {fields[0].shape[0]}"
        )
    return _assemble_edges(fields, header)


def _assemble_edges(fields, header: MtxHeader):
    # 1-based -> 0-based (Alg 4 line 20); the parsed arrays are owned by
    # this call, so the shift happens in place
    src, dst = fields[0], fields[1]
    np.subtract(src, 1, out=src)
    np.subtract(dst, 1, out=dst)
    n = max(header.rows, header.cols)
    # the compiled fold already range-checked against the header dims
    if not getattr(fields, "validated", False) and src.shape[0] and (
        src.min(initial=0) < 0 or dst.min(initial=0) < 0
        or src.max(initial=0) >= n or dst.max(initial=0) >= n
    ):
        raise ValueError("malformed MTX body: coordinate out of range")
    if header.weighted:
        wgt = (
            fields[2]
            if fields[2].dtype == np.float32
            else fields[2].astype(np.float32)
        )
    else:
        wgt = None
    presorted = getattr(fields, "presorted", None)
    if header.symmetric:
        # Alg 4 lines 28-33: add the reverse edge
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if wgt is not None:
            wgt = np.concatenate([wgt, wgt])
        presorted = False if src.shape[0] else presorted
    return src, dst, wgt, presorted


# ---------------------------------------------------------------------------
# loadGraph() (Alg 3): header -> edgelist -> counting-sort CSR
# ---------------------------------------------------------------------------
#: files at least this large stream through np.memmap chunked parsing
MMAP_THRESHOLD = 1 << 28
#: chunk granularity of the memory-mapped reader (newline-aligned)
CHUNK_BYTES = 1 << 26


def _parse_chunked(path: str, header: MtxHeader, *, fixed: bool,
                   chunk_bytes: int, num_partitions: int = 1):
    """Parse a memory-mapped body in newline-aligned chunks.

    Uniform line width is detected from the first line so every chunk
    still takes the fixed-width fast path (with its per-chunk row count
    as the hint), and ``num_partitions`` fans each chunk out across the
    Alg-4 thread pool — huge files are exactly where both matter.
    """
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    size = mm.shape[0]
    nf = header.n_fields
    # uniform-width probe: first line's width must tile the whole body
    w = 0
    if fixed:
        first_nl = np.flatnonzero(
            mm[header.header_end : min(header.header_end + 256, size)] == _NL
        )
        if first_nl.shape[0]:
            cand = int(first_nl[0]) + 1
            if (size - header.header_end) % cand == 0:
                w = cand
    parts: list[list[np.ndarray]] = []
    pos = header.header_end
    while pos < size:
        end = min(pos + chunk_bytes, size)
        if end < size:
            if w:
                end = pos + max((end - pos) // w, 1) * w  # row boundary
                end = min(end, size)
            else:
                tail = np.flatnonzero(mm[pos:end] == _NL)
                if tail.shape[0] == 0:
                    raise ValueError(
                        "malformed MTX body: line exceeds chunk size"
                    )
                end = pos + int(tail[-1]) + 1
        chunk = np.asarray(mm[pos:end])  # one chunk resident at a time
        parts.append(
            _parse_body(
                chunk, nf, fixed=fixed,
                nnz_hint=(end - pos) // w if w else None,
                num_partitions=num_partitions,
                n_limit=max(header.rows, header.cols),
            )
        )
        pos = end
    if not parts:
        return [np.zeros(0, np.int64)] * 2 + (
            [np.zeros(0, np.float64)] if nf == 3 else []
        )
    return _joined(parts, nf)


def load_mtx(
    path_or_bytes,
    *,
    num_partitions: int = 4,
    sort: bool = True,
    engine: str = "auto",
    fixed: bool = True,
    mmap_threshold: int = MMAP_THRESHOLD,
    chunk_bytes: int = CHUNK_BYTES,
    device="cuda",
) -> csr_mod.CSR:
    """loadGraph() of Alg 3: header -> edgelist -> partitioned CSR on
    ``device``.

    ``engine`` selects the csr_build backend (``auto``: the ``cuda``
    device build on a GPU, the ``host`` packed-key radix sort on the CPU;
    see ``core/csr.from_coo``); ``fixed`` gates the fixed-width fast
    path; files >= ``mmap_threshold`` bytes stream through a
    memory-mapped chunked reader instead of one read().
    """
    dev = util.resolve_device(device)
    src = dst = wgt = None
    if isinstance(path_or_bytes, bytes):
        buf = path_or_bytes
    elif isinstance(path_or_bytes, str):
        if os.path.getsize(path_or_bytes) >= mmap_threshold:
            with open(path_or_bytes, "rb") as f:
                head = f.read(1 << 20)  # header + comments live up front
            header = read_header(head)
            fields = _parse_chunked(
                path_or_bytes, header, fixed=fixed,
                chunk_bytes=chunk_bytes, num_partitions=num_partitions,
            )
            if fields[0].shape[0] != header.nnz:
                raise ValueError(
                    f"truncated MTX body: header promises {header.nnz} "
                    f"entries, parsed {fields[0].shape[0]}"
                )
            src, dst, wgt, presorted = _assemble_edges(fields, header)
        else:
            with open(path_or_bytes, "rb") as f:
                buf = f.read()
    else:
        buf = path_or_bytes.read()
    if src is None:
        header = read_header(buf)
        src, dst, wgt, presorted = _parse_edgelist_full(
            buf, header, fixed=fixed, num_partitions=num_partitions
        )
    n = max(header.rows, header.cols)
    return csr_mod.from_coo(
        src, dst, wgt, n=n, num_partitions=num_partitions,
        dedup=False, sort=sort, engine=engine, presorted=presorted,
        device=dev,
    )


def load_digraph(path_or_bytes, *, device="cuda", **kw):
    """File -> DiGraph arena on ``device`` (the paper's t_load target):
    ``load_mtx``, then ``DiGraph.from_csr`` of its CSR."""
    from ..core import digraph as digraph_mod

    c = load_mtx(path_or_bytes, device=device, **kw)
    return digraph_mod.DiGraph.from_csr(c, device=device)


# ---------------------------------------------------------------------------
# writer — canonical fixed-width MTX (valid Matrix Market; the aligned
# layout is what load_mtx's fast path detects)
# ---------------------------------------------------------------------------
def _int_columns(vals: np.ndarray, width: int) -> np.ndarray:
    """Zero-padded decimal digits [T, width] (uint8 ASCII)."""
    return (
        (vals[:, None] // _P10I[width - 1 - np.arange(width)]) % 10 + 48
    ).astype(np.uint8)


#: rows ``write_mtx`` formats in one task: chunks run on the parse thread
#: pool (numpy releases the GIL), a pool's width of them at a time, so the
#: temporaries stay near 0.5 GB a thread
WRITE_CHUNK_ROWS = 1 << 21


def write_mtx(path: str, c: csr_mod.CSR, *, weighted: bool = True) -> None:
    """Vectorized fixed-width writer (no np.savetxt) of a CSR on any
    device, ``WRITE_CHUNK_ROWS`` lines a task, written in order.

    Lines are ``SRC DST [S]D.DDDDDDDDe±EE`` with zero-padded ids and a
    9-significant-digit scientific weight (exact float32 round trip);
    every line has identical width, which both this module's fast path
    and any standards-compliant MTX reader accept.
    """
    o = util.host(c.offsets)
    d = util.host(c.dst)
    w = (
        util.host(c.wgt).astype(np.float32, copy=False)
        if (c.wgt is not None and weighted)
        else None
    )
    src = np.repeat(np.arange(c.n, dtype=np.int64), np.diff(o))
    kind = "real" if weighted else "pattern"
    m = int(c.m)
    wi = max(len(str(int(c.n))), 1)
    with open(path, "wb") as f:
        f.write(
            f"%%MatrixMarket matrix coordinate {kind} general\n".encode()
        )
        f.write(f"{c.n} {c.n} {c.m}\n".encode())
        def lines(a):
            b = min(a + WRITE_CHUNK_ROWS, m)
            wc = None
            if weighted:
                wc = w[a:b] if w is not None else np.ones(b - a, np.float32)
            return _mtx_lines(src[a:b], d[a:b].astype(np.int64), wc, wi)

        starts = range(0, m, WRITE_CHUNK_ROWS)
        wave = os.cpu_count() or 1
        for i in range(0, len(starts), wave):
            futs = [_parse_pool().submit(lines, a) for a in starts[i : i + wave]]
            for fut in futs:
                f.write(fut.result().tobytes())


def _mtx_lines(src: np.ndarray, d: np.ndarray, w, wi: int) -> np.ndarray:
    """The fixed-width lines [rows, width] (uint8) of 0-based ids ``src``,
    ``d`` and weights ``w`` (None: a pattern file) with ``wi``-digit ids."""
    m = src.shape[0]
    if w is not None:
        # decimal decomposition: |w| = mant * 10^e10, mant in [1, 10)
        aw = np.abs(w.astype(np.float64))
        nz = aw > 0
        e10 = np.zeros(m, np.int64)
        e10[nz] = np.floor(np.log10(aw[nz])).astype(np.int64)
        mdig = np.zeros(m, np.int64)
        mdig[nz] = np.rint(aw[nz] / _P10E[np.clip(e10[nz] + _E_BIAS, 0, 2 * _E_BIAS)] * 1e8).astype(np.int64)
        carry = mdig >= 10**9  # 9.99999999 rounded up a decade
        mdig[carry] //= 10
        e10[carry] += 1
        # SRC_wi ' ' DST_wi ' ' sign d . dddddddd e sign ee '\n'
        width = 2 * wi + 2 + 1 + 10 + 4 + 1
        out = np.full((m, width), 32, np.uint8)
        out[:, :wi] = _int_columns(src + 1, wi)
        out[:, wi + 1 : 2 * wi + 1] = _int_columns(d + 1, wi)
        p = 2 * wi + 3  # mantissa start; 2*wi+2 is the sign column
        out[:, p - 1] = np.where(w < 0, 45, 32)
        mcols = _int_columns(mdig, 9)
        out[:, p] = mcols[:, 0]
        out[:, p + 1] = 46
        out[:, p + 2 : p + 10] = mcols[:, 1:]
        out[:, p + 10] = 101
        out[:, p + 11] = np.where(e10 < 0, 45, 43)
        out[:, p + 12 : p + 14] = _int_columns(np.abs(e10), 2)
        out[:, -1] = _NL
    else:
        width = 2 * wi + 2
        out = np.full((m, width), 32, np.uint8)
        out[:, :wi] = _int_columns(src + 1, wi)
        out[:, wi + 1 : 2 * wi + 1] = _int_columns(d + 1, wi)
        out[:, -1] = _NL
    return out
