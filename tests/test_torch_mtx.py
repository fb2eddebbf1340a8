"""MTX loading parity: the port's ``io/mtx`` against ``repro``'s.

Every file goes through both packages' ``load_mtx`` (the port on the CPU,
through its host engine and through its device build with the plain
offsets, ``engine="torch"``), and the CSRs must agree bit for bit; a bad
body must raise the same error in both.  ``write_mtx`` must write the same
bytes, and ``load_digraph`` the same arena state.  The compiled row parser
(``io/_cparse.py``) builds here with the host ``cc``.
"""
import numpy as np
import pytest
import torch

from repro.core import DiGraph as JDiGraph
from repro.core import csr as j_csr
from repro.io import mtx as j_mtx
from repro.io import synthetic as j_syn
from repro_torch.core import DiGraph, csr
from repro_torch.io import _cparse, mtx, synthetic

ENGINES = ("host", "torch")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_csr(a, j):
    assert (a.n, a.m) == (j.n, j.m)
    np.testing.assert_array_equal(_np(a.offsets), _np(j.offsets))
    np.testing.assert_array_equal(_np(a.dst), _np(j.dst))
    assert (a.wgt is None) == (j.wgt is None)
    if a.wgt is not None:
        np.testing.assert_array_equal(_np(a.wgt).view(np.int32), _np(j.wgt).view(np.int32))


def _load_both(path, engine, **kw):
    """The port's CSR, checked bit for bit against ``repro``'s."""
    got = mtx.load_mtx(path, device="cpu", engine=engine, **kw)
    _same_csr(got, j_mtx.load_mtx(path, **kw))
    return got


def _write(tmp_path, body: str, name="g.mtx") -> str:
    p = tmp_path / name
    p.write_text(body)
    return str(p)


def _write_graph(tmp_path, kind, name="g.mtx", weighted=True, **kw):
    """``write_mtx`` of a synthetic graph by both packages: same bytes."""
    c = synthetic.make_graph(kind, device="cpu", **kw)
    p, q = tmp_path / name, tmp_path / f"repro_{name}"
    mtx.write_mtx(str(p), c, weighted=weighted)
    j_mtx.write_mtx(str(q), j_syn.make_graph(kind, **kw), weighted=weighted)
    assert p.read_bytes() == q.read_bytes()
    return str(p), c


TEXT_BODIES = {
    "pattern_symmetric": (
        "%%MatrixMarket matrix coordinate pattern symmetric\n"
        "% a comment line\n4 4 3\n2 1\n3 1\n4 3\n"
    ),
    "scientific": (
        "%%MatrixMarket matrix coordinate real general\n"
        "3 3 2\n1 2 1.5e-2\n3 1 -2.25E+1\n"
    ),
    "ragged_whitespace_and_signs": (
        "%%MatrixMarket matrix coordinate real general\n"
        "% comment\n%% another\n% third\n"
        "4 4 5\n"
        "1 2 1.5\n"
        "  2\t3   -2.25\n"
        "3   4 +3e2\n"
        "4 1 .5\n"
        "1 1 5.\n"
    ),
    "real_symmetric": (
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "5 5 4\n2 1 0.25\n3 3 -1e-3\n5 2 7\n4 1 1.0E+2\n"
    ),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", sorted(TEXT_BODIES))
def test_text_bodies_match_repro(tmp_path, name, engine):
    p = _write(tmp_path, TEXT_BODIES[name])
    for fixed in (True, False):
        _load_both(p, engine, fixed=fixed)
    if name == "pattern_symmetric":
        c = mtx.load_mtx(p, device="cpu", engine=engine)
        assert c.to_edge_sets() == [{1, 2}, {0}, {0, 3}, {2}]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind,weighted", [("social", True), ("road", True),
                                           ("web", False), ("uniform", False)])
def test_round_trip_matches_repro(tmp_path, kind, weighted, engine):
    p, c = _write_graph(tmp_path, kind, weighted=weighted, scale=8, edge_factor=4, seed=2)
    got = _load_both(p, engine)
    np.testing.assert_array_equal(_np(got.offsets), _np(c.offsets))
    np.testing.assert_array_equal(_np(got.dst), _np(c.dst))
    if weighted:
        np.testing.assert_array_equal(_np(got.wgt), _np(c.wgt))
    else:
        assert got.wgt is None


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("chunk_rows", [1, 7, 1000])
def test_write_mtx_in_chunks_matches_repro(tmp_path, monkeypatch, chunk_rows, weighted):
    """The port formats ``WRITE_CHUNK_ROWS`` lines at a time; the bytes are
    ``repro``'s whole-file writer's, a zero-degree tail row included."""
    monkeypatch.setattr(mtx, "WRITE_CHUNK_ROWS", chunk_rows)
    p, c = _write_graph(tmp_path, "social", weighted=weighted, scale=8, edge_factor=4, seed=9)
    assert c.m > chunk_rows
    src = np.repeat(np.arange(c.n), np.diff(c.offsets.numpy()))
    tail = csr.from_coo(src, c.dst.numpy(), c.wgt.numpy(), n=c.n + 3, dedup=False,
                        device="cpu")
    q, r = tmp_path / "tail.mtx", tmp_path / "repro_tail.mtx"
    mtx.write_mtx(str(q), tail, weighted=weighted)
    j_mtx.write_mtx(str(r), j_csr.from_coo(src, c.dst.numpy(), c.wgt.numpy(), n=c.n + 3,
                                           dedup=False), weighted=weighted)
    assert q.read_bytes() == r.read_bytes()
    _same_csr(_load_both(p, "host"), _load_both(str(p), "torch"))


@pytest.mark.parametrize("engine", ENGINES)
def test_general_tokenizer_matches_fixed_path(tmp_path, engine):
    p, c = _write_graph(tmp_path, "social", scale=9, edge_factor=4, seed=3)
    a = _load_both(p, engine)
    b = _load_both(p, engine, fixed=False)
    _same_csr(a, b)


def test_scientific_weights_round_trip(tmp_path):
    vals = np.array([1.5e-2, -2.25e1, 3.25e-30, -4.5e30, 0.0, 1.0, -1.0], np.float32)
    n = vals.shape[0]
    src = np.arange(n)
    dst = (src + 1) % n
    c = csr.from_coo(src, dst, vals, n=n, device="cpu")
    p, q = tmp_path / "e.mtx", tmp_path / "repro_e.mtx"
    mtx.write_mtx(str(p), c)
    j_mtx.write_mtx(str(q), j_csr.from_coo(src, dst, vals, n=n))
    assert p.read_bytes() == q.read_bytes()
    for engine in ENGINES:
        for fixed in (True, False):
            got = _load_both(str(p), engine, fixed=fixed)
            np.testing.assert_array_equal(_np(got.wgt), _np(c.wgt))


BAD_BODIES = {
    "truncated": ("4 4 5\n1 2 1.0\n2 3 1.0\n", True),
    "malformed_token_count": ("4 4 2\n1 2 1.0\n2 3 1.0 7 8\n", False),
    "garbage_byte": ("4 4 2\n1 2 1.0\nx y 1.0\n", False),
    "out_of_range": ("4 4 2\n1 2 1.0\n9 1 1.0\n", True),
    "out_of_range_general_path": ("4 4 2\n1 2 1.0\n9 1 1.0\n", False),
    "zero_coordinate": ("4 4 2\n1 2 1.0\n0 1 1.0\n", True),
    "bad_value": ("4 4 2\n1 2 1.0\n2 1 1.-0\n", False),
}


@pytest.mark.parametrize("name", sorted(BAD_BODIES))
def test_bad_bodies_raise_like_repro(tmp_path, name):
    body, fixed = BAD_BODIES[name]
    p = _write(tmp_path, "%%MatrixMarket matrix coordinate real general\n" + body)
    with pytest.raises(ValueError) as j_err:
        j_mtx.load_mtx(p, fixed=fixed)
    for engine in ENGINES:
        with pytest.raises(ValueError) as err:
            mtx.load_mtx(p, device="cpu", engine=engine, fixed=fixed)
        assert str(err.value) == str(j_err.value)


def test_header_errors_match_repro():
    for buf in (b"%%NotMatrixMarket\n1 1 0\n",
                b"%%MatrixMarket matrix coordinate real general\n3 3\n"):
        with pytest.raises(ValueError) as j_err:
            j_mtx.read_header(buf)
        with pytest.raises(ValueError) as err:
            mtx.read_header(buf)
        assert str(err.value) == str(j_err.value)


@pytest.mark.parametrize("engine", ENGINES)
def test_partition_invariance(tmp_path, engine):
    """Alg 5's partition count must not change the result."""
    p, _ = _write_graph(tmp_path, "road", scale=9, seed=4)
    base = _load_both(p, engine, num_partitions=1)
    _same_csr(_load_both(p, engine, num_partitions=7), base)


@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("rho", [2, 3])
def test_partition_parallel_parse_invariance(tmp_path, monkeypatch, rho, fixed):
    p, _ = _write_graph(tmp_path, "uniform", scale=10, edge_factor=8, seed=5)
    base = _load_both(p, "host", num_partitions=1)
    # force the thread fan-out regardless of body size, in both packages
    monkeypatch.setattr(mtx, "_PARALLEL_MIN_BYTES", 1)
    monkeypatch.setattr(j_mtx, "_PARALLEL_MIN_BYTES", 1)
    _same_csr(_load_both(p, "host", num_partitions=rho, fixed=fixed), base)


def test_compiled_parser_builds_here():
    assert _cparse.available()
    assert _cparse.BUILD_DIR.name == "build"


@pytest.mark.parametrize("use_c", [True, False])
def test_compiled_parser_matches_numpy_folds(tmp_path, monkeypatch, use_c):
    """The compiled folds and the sgemm folds give the same bits, in both
    packages, with negative weights and id range validation."""
    rng = np.random.default_rng(41)
    src, dst = synthetic.uniform_edges(rng, 200, 900)
    w = (rng.uniform(0.5, 1.5, 900) * np.where(rng.random(900) < 0.3, -1, 1)).astype(np.float32)
    c = csr.from_coo(src, dst, w, n=200, device="cpu")
    p = str(tmp_path / "c.mtx")
    mtx.write_mtx(p, c)
    ref = mtx.load_mtx(p, device="cpu")
    monkeypatch.setattr(mtx, "USE_C_PARSE", use_c)
    monkeypatch.setattr(j_mtx, "USE_C_PARSE", use_c)
    before = _cparse.parse_fixed_rows.calls
    _same_csr(_load_both(p, "host"), ref)
    assert (_cparse.parse_fixed_rows.calls > before) == use_c


def _observed_order(path, reader, monkeypatch):
    """The presorted flag of one parse of ``path`` by ``reader``."""
    header = mtx.read_header(open(path, "rb").read(1 << 20))
    if reader == "chunks":
        return mtx._parse_chunked(path, header, fixed=True, chunk_bytes=1 << 12,
                                  num_partitions=1).presorted
    if reader == "chunks_and_partitions":
        monkeypatch.setattr(mtx, "_PARALLEL_MIN_BYTES", 1)
        return mtx._parse_chunked(path, header, fixed=True, chunk_bytes=1 << 13,
                                  num_partitions=3).presorted
    if reader == "partitions":
        monkeypatch.setattr(mtx, "_PARALLEL_MIN_BYTES", 1)
    rho = 3 if reader == "partitions" else 1
    return mtx._parse_edgelist_full(open(path, "rb").read(), header,
                                    num_partitions=rho)[3]


@pytest.mark.parametrize("reader", ["whole", "partitions", "chunks", "chunks_and_partitions"])
def test_compiled_parser_observes_csr_order(tmp_path, monkeypatch, reader):
    """``write_mtx`` files are in CSR order and every reader says so (the
    partitions and chunks join their observations at the seams); a
    shuffled body and one whose halves are swapped are not, and still load
    the same CSR."""
    p, c = _write_graph(tmp_path, "social", scale=8, edge_factor=4, seed=6)
    assert _observed_order(p, reader, monkeypatch) is True
    buf = open(p, "rb").read()
    header = mtx.read_header(buf)
    lines = buf[header.header_end:].splitlines(keepends=True)
    half = len(lines) // 2
    order = np.random.default_rng(6).permutation(len(lines))
    for name, body in (("shuffled", [lines[i] for i in order]),
                       ("swapped", lines[half:] + lines[:half])):
        q = tmp_path / f"{name}.mtx"
        q.write_bytes(buf[: header.header_end] + b"".join(body))
        assert _observed_order(str(q), reader, monkeypatch) is False
        for engine in ENGINES:
            _same_csr(_load_both(str(q), engine), c)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("chunk_bytes", [1 << 12, 999])
def test_mmap_chunked_load_matches_whole_buffer(tmp_path, engine, chunk_bytes):
    p, _ = _write_graph(tmp_path, "web", scale=9, edge_factor=4, seed=7)
    whole = _load_both(p, engine)
    chunked = _load_both(p, engine, mmap_threshold=0, chunk_bytes=chunk_bytes)
    _same_csr(chunked, whole)


def test_mmap_chunked_general_body(tmp_path):
    body = TEXT_BODIES["ragged_whitespace_and_signs"]
    p = _write(tmp_path, body)
    whole = _load_both(p, "host")
    _same_csr(_load_both(p, "host", mmap_threshold=0, chunk_bytes=16), whole)


def test_write_mtx_is_valid_for_foreign_parsers(tmp_path):
    """The fixed-width writer stays plain Matrix Market (python parse)."""
    p, c = _write_graph(tmp_path, "road", scale=8, seed=2)
    src, dst, wgt = [], [], []
    with open(p) as f:
        assert f.readline().startswith("%%MatrixMarket")
        n, _, m = map(int, f.readline().split())
        for line in f:
            a, b, w = line.split()
            src.append(int(a) - 1)
            dst.append(int(b) - 1)
            wgt.append(float(w))
    assert len(src) == c.m == m
    c2 = csr.from_coo(src, dst, np.array(wgt, np.float32), n=n, dedup=False, device="cpu")
    _same_csr(c2, c)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", ["web", "social"])
def test_load_digraph_matches_repro(tmp_path, kind, engine):
    p, _ = _write_graph(tmp_path, kind, scale=9, edge_factor=4, seed=13)
    g = mtx.load_digraph(p, device="cpu", engine=engine)
    j = j_mtx.load_digraph(p)
    a, b = g.state_tree(), j.state_tree()
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], np.asarray(b[key]), err_msg=key)
    direct = DiGraph.from_csr(mtx.load_mtx(p, device="cpu"), device="cpu").state_tree()
    for key in a:
        np.testing.assert_array_equal(a[key], direct[key], err_msg=key)
    h = JDiGraph.from_csr(j_mtx.load_mtx(p), engine="host").state_tree()
    for key in ("dst", "wgt", "slot_rows", "starts", "capacities"):
        np.testing.assert_array_equal(a[key], np.asarray(h[key]), err_msg=key)


def test_load_mtx_reads_bytes_and_file_objects(tmp_path):
    p, c = _write_graph(tmp_path, "uniform", scale=7, edge_factor=4, seed=8)
    data = open(p, "rb").read()
    _same_csr(mtx.load_mtx(data, device="cpu"), c)
    with open(p, "rb") as f:
        _same_csr(mtx.load_mtx(f, device="cpu"), c)


def test_default_device_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p, _ = _write_graph(tmp_path, "uniform", scale=5, edge_factor=2, seed=1)
    for load in (mtx.load_mtx, mtx.load_digraph):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load(p)
