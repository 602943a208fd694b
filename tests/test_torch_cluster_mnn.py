"""The port's clusterMNN (dense path) against the JAX package's, on the CPU
in fp64.

Covers every case of tests/test_cluster_mnn.py except its three CSR tests
(``cluster_mnn_csr`` is not ported yet). Each runs the batchelor_tpu
function and its batchelor_torch counterpart on the same numpy inputs; the
JAX calls cost seconds, so each configuration runs once per module in a
fixture. What is compared, and how closely:
  * centroids 1e-12; union-find labels exactly;
  * cluster_mnn: centroid MNN pairs as sets, ``cluster_meta`` exactly, and
    corrected values in gene space (``corrected @ rotation.T``, which does
    not depend on the signs or the basis of the centroid PCA's
    eigenvectors) within 1e-8 of max |value|;
  * the full-rank centroid PCA keeps pairwise distances within 1e-6;
  * the propagation formula (softmax of -d^2 / sigma^2, sigma the median
    nearest-centroid distance of the restricted cells, an even count of
    them so the median averages the two middle values) within 1e-10 of a
    numpy oracle and of the JAX package's jitted propagation;
  * k-means: partitions equal to JAX's up to relabelling on well-separated
    data (the k-means++ draws differ: ``jax.random`` is not reproduced),
    and JAX's final labels are a fixed point of the port's Lloyd step.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from batchelor_torch import convert
from batchelor_torch.correct import cluster_mnn as tc
from batchelor_torch.ops.pca import multi_batch_pca as t_pca
from batchelor_tpu.correct import cluster_mnn as jc
from batchelor_tpu.ops.pca import multi_batch_pca as j_pca

torch.set_num_threads(2)


def _mock(rng, n=300, g=60, n_types=3, shift=1.0, scale=2.0):
    means = rng.normal(size=(n_types, g)) * scale
    assign1 = rng.integers(0, n_types, n)
    b1 = means[assign1] + rng.normal(size=(n, g))
    assign2 = rng.integers(0, n_types, n)
    b2 = means[assign2] + rng.normal(size=(n, g)) + rng.normal(size=(1, g)) * shift
    return b1, b2, assign1, assign2


def _pair_set(res):
    return [set(map(tuple, i.pairs.tolist())) for i in res.centroid_result.merge_info]


def _gene_space(res):
    return np.asarray(res.corrected) @ np.asarray(res.rotation).T


def _same_cluster_result(j, t, tol=1e-8):
    t = convert.result_to_numpy(t)
    assert _pair_set(j) == _pair_set(t)
    for key in ("cluster", "batch", "meta"):
        assert np.array_equal(np.asarray(j.cluster_meta[key]), t.cluster_meta[key]), key
    assert np.array_equal(np.asarray(j.batch), t.batch)
    assert np.array_equal(np.asarray(j.cluster), t.cluster)
    jg, tg = _gene_space(j), _gene_space(t)
    assert np.abs(jg - tg).max() <= tol * np.abs(jg).max()
    assert np.allclose(np.asarray(j.centers), t.centers, atol=1e-12)


CASES = {
    "two": {},
    "restrict_even": {"restrict": [np.arange(0, 300, 3)[:100], np.arange(1, 300, 2)[:80]]},
    "subset_all": {"subset_row": np.arange(0, 60, 2), "correct_all": True, "cos_norm": False,
                   "batch_names": ["p", "q"]},
}


@pytest.fixture(scope="module")
def mock():
    return _mock(np.random.default_rng(42))


@pytest.fixture(scope="module")
def jax_results(mock):
    b1, b2, c1, c2 = mock
    return {name: jc.cluster_mnn([jnp.asarray(b1), jnp.asarray(b2)], clusters=[c1, c2], **kw)
            for name, kw in CASES.items()}


def test_centroids_match_jax(rng):
    b = rng.normal(size=(50, 10))
    cl = rng.choice([4, 1, 2, 9], 50)
    restrict = [np.arange(0, 50, 2)]
    for r in (None, restrict):
        jcent, jlv = jc._compute_centroids([jnp.asarray(b)], [cl], r)
        tcent, tlv = tc._compute_centroids([torch.from_numpy(b)], [cl], r)
        assert jlv == tlv
        assert np.allclose(np.asarray(jcent[0]), tcent[0].numpy(), atol=1e-12, rtol=0)
    assert tlv[0] == [1, 2, 4, 9]
    for j, lv in enumerate(tlv[0]):
        assert np.allclose(tcent[0][j].numpy(), b[restrict[0]][cl[restrict[0]] == lv].mean(0))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cluster_mnn_matches_jax(case, mock, jax_results):
    b1, b2, c1, c2 = mock
    t = tc.cluster_mnn([b1, b2], clusters=[c1, c2], device="cpu", **CASES[case])
    _same_cluster_result(jax_results[case], t)
    if case == "two":
        # the reference's pseudobulk equivalence (test-cluster-mnn.R:18-30)
        assert np.array_equal(t.cluster_meta["cluster"], [0, 1, 2, 0, 1, 2])
        assert np.array_equal(t.cluster_meta["batch"], np.repeat([0, 1], 3))
        ca = t.corrected.numpy()
        assert ca.shape[0] == 600 and np.isfinite(ca).all()
        assert np.linalg.norm(ca[:300].mean(0) - ca[300:].mean(0)) < 2.0
        assert len(set(t.cluster_meta["meta"].tolist())) < 6
        rec = t.reconstructed()
        assert rec.shape == (60, 600)
        assert np.allclose(rec.materialize().numpy(), _gene_space(convert.result_to_numpy(t)).T)


def test_cluster_mnn_single_matrix_matches_jax(rng, mock):
    b1, b2, c1, c2 = mock
    x = np.concatenate([b1, b2])
    batch = np.repeat(["b", "a"], 300)
    cl = np.concatenate([c1, c2])
    perm = rng.permutation(600)
    kw = dict(min_batch_skip=None, restrict=np.arange(0, 600, 2))
    j = jc.cluster_mnn(jnp.asarray(x[perm]), batch[perm], clusters=cl[perm], **kw)
    t = tc.cluster_mnn(x[perm], batch[perm], clusters=cl[perm], device="cpu", **kw)
    _same_cluster_result(j, t)
    assert list(t.cluster_meta["batch"]) == ["a"] * 3 + ["b"] * 3


def test_full_rank_centroid_pca_preserves_distances(rng):
    # reference test-cluster-mnn.R:32-42
    s = [rng.normal(size=(50, 20)), rng.normal(size=(25, 20)), rng.normal(size=(100, 20))]
    raw = np.concatenate(s)
    dref = np.linalg.norm(raw[:, None] - raw[None, :], axis=-1)
    for method in ("direct", "gram"):
        out = np.concatenate([c.numpy() for c in
                              t_pca(s, d=174, method=method, device="cpu").components])
        assert np.allclose(np.linalg.norm(out[:, None] - out[None, :], axis=-1), dref, atol=1e-6)
    jout = np.concatenate([np.asarray(c) for c in
                           j_pca([jnp.asarray(m) for m in s], d=174, method="gram").components])
    assert np.allclose(np.linalg.norm(jout[:, None] - jout[None, :], axis=-1), dref, atol=1e-6)


def test_propagation_formula_with_an_even_restricted_count(rng):
    proj = rng.normal(size=(41, 6))
    cent = rng.normal(size=(4, 6))
    delta = rng.normal(size=(4, 6))
    restrict = np.arange(1, 41, 3)                   # 14 cells: the median of an even count
    ours = tc._propagate(torch.from_numpy(proj), torch.from_numpy(cent),
                         torch.from_numpy(delta), restrict).numpy()
    d2 = ((proj[:, None] - cent[None]) ** 2).sum(-1)
    sigma = np.median(np.sqrt(d2[restrict].min(1)))
    assert restrict.size % 2 == 0
    assert sigma != np.sort(np.sqrt(d2[restrict].min(1)))[restrict.size // 2 - 1]
    w = np.exp(-d2 / sigma**2 - (-d2 / sigma**2).max(1, keepdims=True))
    w /= w.sum(1, keepdims=True)
    assert np.allclose(ours, proj + w @ delta, atol=1e-10, rtol=0)
    # the JAX package's own propagation (its CSR path's two jitted steps)
    jsigma = jnp.median(jc._min_cent_dist(jnp.asarray(proj[restrict]), jnp.asarray(cent)))
    theirs = jc._propagate_block(jnp.asarray(proj), jnp.asarray(cent), jnp.asarray(delta), jsigma)
    assert np.allclose(ours, np.asarray(theirs), atol=1e-10, rtol=0)
    v = torch.tensor([4.0, 1.0, 3.0, 2.0], dtype=torch.float64)
    assert float(tc._median(v)) == 2.5 and float(tc._median(v[:3])) == 3.0


def test_union_find_matches_jax(rng):
    edges = np.array([[0, 1], [2, 3], [1, 2]])
    comp = tc._union_find(5, edges)
    assert comp[0] == comp[1] == comp[2] == comp[3] != comp[4]
    assert np.array_equal(tc._union_find(3, np.empty((0, 2))), [0, 1, 2])
    for n, m in ((12, 6), (40, 25), (40, 60)):
        e = rng.integers(0, n, size=(m, 2))
        ours = tc._union_find(n, e)
        assert np.array_equal(ours, jc._union_find(n, e))
        assert np.array_equal(ours, jc._union_find_py(n, e))


def test_kmeans_matches_jax_up_to_relabelling(rng):
    pts = np.concatenate([rng.normal(size=(50, 2)) + c
                          for c in ([0, 0], [10, 10], [-10, 8], [9, -9])])
    ours = tc.kmeans_clusters(pts, 4, device="cpu")
    theirs = jc.kmeans_clusters(jnp.asarray(pts), 4)
    # the same partition: a one-to-one map between the labels
    pairs = set(zip(ours.tolist(), theirs.tolist()))
    assert len(pairs) == 4 and len({a for a, _ in pairs}) == 4
    assert all(len(set(ours[i * 50:(i + 1) * 50])) == 1 for i in range(4))
    assert np.array_equal(ours, tc.kmeans_clusters(pts, 4, device="cpu"))   # seeded
    # JAX's labels are a fixed point of the port's Lloyd step
    x = torch.from_numpy(rng.normal(size=(300, 5)))
    jl = jc.kmeans_clusters(jnp.asarray(x.numpy()), 6, seed=3)
    cent = torch.stack([x[torch.from_numpy(jl == c)].mean(0) for c in range(6)])
    moved = tc.lloyd_step(x, cent)
    assert torch.allclose(moved, cent, atol=1e-12, rtol=0)
    assert np.array_equal(torch.argmin(tc._sq_dists(x, moved), 1).numpy(), jl)


def test_cluster_mnn_auto_clusters_match_jax(rng):
    # types far apart: k-means++ then finds them whatever its draws
    b1, b2, c1, c2 = _mock(rng, scale=6.0)
    j = jc.cluster_mnn([jnp.asarray(b1), jnp.asarray(b2)], clusters=3)
    t = convert.result_to_numpy(tc.cluster_mnn([b1, b2], clusters=3, device="cpu"))
    # k-means labels agree up to relabelling in each batch...
    for a, b, c in ((j.cluster[:300], t.cluster[:300], c1), (j.cluster[300:], t.cluster[300:], c2)):
        assert len(set(zip(a.tolist(), b.tolist()))) == len(set(b.tolist())) == 3
        assert len(set(zip(c.tolist(), b.tolist()))) == 3
    # ...and relabelled centroids correct every cell alike
    jg, tg = _gene_space(j), _gene_space(t)
    assert np.abs(jg - tg).max() <= 1e-8 * np.abs(jg).max()
    with pytest.raises(ValueError, match="one entry per batch"):
        tc.cluster_mnn([b1, b2], clusters=[np.zeros(300, int)], device="cpu")
