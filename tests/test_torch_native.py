"""The port's host C++ runtime (``batchelor_torch/native``) against its
numpy ``*_plain`` versions and against the JAX package's bindings.

Covers every case of tests/test_native.py. The port builds its own copy of
``libbatchelor.cpp`` into ``batchelor_torch/build/`` and never falls back:
a failed build raises. Integer outputs (pairs, labels, column maps) are
compared exactly; the densified blocks bit for bit; the float value
transforms within 1e-6 (the C++ and numpy evaluate log1p/expm1 in other
orders); the gene statistics within 1e-9 relative (threaded fp64 partial
sums against bincount's order). Against the JAX package's bindings, which
build the same source, the outputs are identical.
"""
import os

import numpy as np
import pytest

import oracle
from batchelor_torch.io.csr import CSRCells
from batchelor_torch.native import bindings as nb
from batchelor_tpu.native import bindings as jb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_native_builds_into_the_port():
    lib = nb.get_lib()
    assert lib.bt_version() == 3
    path = nb._library_path((*nb.GXX_FLAGS, nb.NATIVE_FLAG))
    fallback = nb._library_path(nb.GXX_FLAGS)
    assert path.exists() or fallback.exists()
    assert path.parent == nb.BUILD == nb.Path(REPO) / "batchelor_torch" / "build"
    assert path != fallback and path.name.startswith("libbatchelor-")
    with open(nb.SRC, "rb") as a, open(os.path.join(REPO, "batchelor_tpu", "native",
                                                    "libbatchelor.cpp"), "rb") as b:
        assert a.read() == b.read()


def test_failed_build_raises_with_the_compiler_error(tmp_path, monkeypatch):
    bad = tmp_path / "libbatchelor.cpp"
    bad.write_text('extern "C" int bt_version() { return undeclared_name; }\n')
    monkeypatch.setattr(nb, "SRC", bad)
    monkeypatch.setattr(nb, "BUILD", tmp_path / "build")
    monkeypatch.setattr(nb, "_lib", None)
    with pytest.raises(RuntimeError, match="undeclared_name"):
        nb.get_lib()
    assert not list((tmp_path / "build").glob("*.so"))


def test_mutual_nn_pairs_matches_oracle(rng):
    left = rng.normal(size=(60, 5))
    right = rng.normal(size=(80, 5))
    l2r, _ = oracle.knn(left, right, 12)
    r2l, _ = oracle.knn(right, left, 9)
    first, second = nb.mutual_nn_pairs(l2r, r2l)
    of, os_ = oracle.find_mutual_nn(left, right, 9, 12)
    assert np.array_equal(first, of) and np.array_equal(second, os_)
    for a, b in zip((first, second), nb.mutual_nn_pairs_plain(l2r, r2l)):
        assert np.array_equal(a, b)
    for a, b in zip((first, second), jb.mutual_nn_pairs(l2r, r2l)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n,edges", [
    (7, [[0, 1], [2, 3], [1, 2], [5, 6]]),
    (3, np.empty((0, 2), np.int64)),
    (9, [[8, 0], [3, 8], [4, 4], [6, 5], [2, 7]]),
])
def test_union_find_native(n, edges):
    lab = nb.union_find(n, np.asarray(edges))
    assert np.array_equal(lab, nb.union_find_plain(n, np.asarray(edges)))
    assert np.array_equal(lab, jb.union_find(n, np.asarray(edges)))
    if n == 7:
        assert lab[0] == lab[1] == lab[2] == lab[3] and lab[5] == lab[6]
        assert len({int(lab[0]), int(lab[4]), int(lab[5])}) == 3
        assert lab[0] == 0                       # first-appearance labelling


@pytest.fixture
def csr(rng):
    dense = ((rng.random((30, 15)) < 0.3) * rng.random((30, 15))).astype(np.float32)
    dense[[4, 29]] = 0                          # empty rows, the last one too
    s = CSRCells.from_dense(dense)
    return s.data, s.indices, s.indptr, dense


def test_csr_densify(csr):
    data, indices, indptr, dense = csr
    block = nb.csr_densify(data, indices, indptr, 5, 20, dense.shape[1])
    assert np.array_equal(block, dense[5:20])
    assert np.array_equal(block, nb.csr_densify_plain(data, indices, indptr, 5, 20, 15))
    assert np.array_equal(block, jb.csr_densify(data, indices, indptr, 5, 20, 15))


def test_csr_row_sums(csr):
    data, indices, indptr, dense = csr
    sums = nb.csr_row_sums(data, indptr, dense.shape[0])
    assert np.allclose(sums, dense.astype(np.float64).sum(axis=1), rtol=1e-12, atol=0)
    assert np.array_equal(sums, nb.csr_row_sums_plain(data, indptr, dense.shape[0]))
    assert np.array_equal(sums, jb.csr_row_sums(data, indptr, dense.shape[0]))


def test_csr_select_columns(csr):
    data, indices, indptr, dense = csr
    keep = np.arange(0, 15, 2)
    col_map = np.full(15, -1, dtype=np.int32)
    col_map[keep] = np.arange(keep.shape[0])
    out = nb.csr_select_columns(data, indices, indptr, col_map)
    for ref in (nb.csr_select_columns_plain(data, indices, indptr, col_map),
                jb.csr_select_columns(data, indices, indptr, col_map)):
        for a, b in zip(out, ref):
            assert np.array_equal(a, b)
    assert np.array_equal(nb.csr_densify(*out, 0, dense.shape[0], keep.shape[0]),
                          dense[:, keep])


def test_native_csr_value_transforms_match_numpy(rng):
    n, g = 200, 50
    dense = rng.poisson(2.0, size=(n, g)).astype(np.float32)
    dense *= rng.uniform(size=(n, g)) < 0.4
    s = CSRCells.from_dense(dense)
    sf = rng.uniform(0.5, 2.0, n).astype(np.float32)
    for cos in (False, True):
        fast = nb.csr_lognorm_cosine(s.data, s.indptr, sf, 2.0, cos)
        assert np.allclose(fast, nb.csr_lognorm_cosine_plain(s.data, s.indptr, sf, 2.0, cos),
                           atol=1e-6, rtol=0)
        assert np.array_equal(fast, jb.csr_lognorm_cosine(s.data, s.indptr, sf, 2.0, cos))

    logged = np.log2(dense + 1.0).astype(np.float32)
    sl = CSRCells.from_dense(logged)
    fast = nb.csr_unlog_colsums(sl.data, sl.indices, g, 2.0)
    assert np.allclose(fast, dense.astype(np.float64).sum(0), atol=1e-3)
    assert np.allclose(fast, nb.csr_unlog_colsums_plain(sl.data, sl.indices, g, 2.0),
                       rtol=1e-9, atol=0)
    assert np.array_equal(fast, jb.csr_unlog_colsums(sl.data, sl.indices, g, 2.0))
    scale = rng.uniform(0.1, 1.0, g)
    fastr = nb.csr_rescale_values(sl.data, sl.indices, scale, 2.0)
    assert np.allclose(fastr, nb.csr_rescale_values_plain(sl.data, sl.indices, scale, 2.0),
                       atol=1e-6, rtol=0)
    assert np.array_equal(fastr, jb.csr_rescale_values(sl.data, sl.indices, scale, 2.0))


def test_csr_gene_stats_native_matches_plain_and_dense(rng):
    n, g = 300, 40
    dense = rng.poisson(3.0, size=(n, g)).astype(np.float32)
    dense *= rng.uniform(size=(n, g)) < 0.3
    s = CSRCells.from_dense(dense)
    sf = rng.uniform(0.5, 2.0, n).astype(np.float32)
    fast = nb.csr_gene_stats(s.data, s.indices, s.indptr, sf, g, 2.0)
    plain = nb.csr_gene_stats_plain(s.data, s.indices, s.indptr, sf, g, 2.0)
    jax_side = jb.csr_gene_stats(s.data, s.indices, s.indptr, sf, g, 2.0)
    for a, b, c in zip(fast, plain, jax_side):
        assert np.allclose(a, b, rtol=1e-9, atol=1e-12)
        assert np.array_equal(a, c)
    norm = dense.astype(np.float64) / sf[:, None].astype(np.float64)
    lg = np.log1p(norm) / np.log(2.0)
    assert np.allclose(fast[0], norm.sum(0), atol=1e-6)
    assert np.allclose(fast[1], lg.sum(0), atol=1e-6)
    assert np.allclose(fast[2], (lg * lg).sum(0), atol=1e-6)
