"""The port's gene-space corrections over CSR stores against the JAX
package's, on the CPU.

Covers tests/test_sparse_gene_space.py except its mesh case (held against
JAX in tests/test_torch_parallel_outofcore.py), the three CSR tests of
tests/test_cluster_mnn.py and the CSR half of
tests/test_diagnostics_api.py::test_blocked_delta_variance_matches_dense.
Each runs the batchelor_tpu function and its batchelor_torch counterpart
(``device="cpu"``) on the same numpy inputs. What is compared, and how
closely:
  * rescale_batches_csr: values within 1e-6 of JAX's (the same C++
    runtime; the averages are fp64), the CSR pattern unchanged, and within
    1e-5 of the port's dense rescale_batches;
  * regress_batches_csr: residuals within 1e-5 of JAX's (both accumulate
    design^T X over fp32 blocks, in other orders; beta by numpy's pinv) and
    within 1e-4 of the port's dense regress_batches, as the JAX test holds
    its own; blocks equal to the full materialization;
  * mnn_correct_csr: identical pairs, corrected within 1e-5 of JAX's and of
    the port's dense mnn_correct (fp32 inputs), with the correct_all result
    on the host;
  * cluster_mnn_csr: identical centroid pairs and ``cluster_meta``,
    corrected within 1e-5 of max |value| in gene space (``corrected @
    rotation.T``, blind to the centroid PCA's signs and bases), and within
    1e-6 of the port's dense cluster_mnn, as JAX's test holds its own;
  * mnn_delta_variance_blocked on CSR stores: within 1e-5 of JAX's (which
    sums each float32 chunk in float32, the port in fp64) and within 1e-10
    of the port's on the dense arrays.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import batchelor_torch as bt
import batchelor_tpu as bj
from batchelor_torch.correct import cluster_mnn as tc
from batchelor_tpu.correct import cluster_mnn as jc
from batchelor_tpu.io.csr import CSRCells as JCSR
from jax_trend import port_trend_in_jax

torch.set_num_threads(2)


def _sparse_logcounts(rng, n, g, density=0.3, scale=1.0):
    x = rng.poisson(scale, size=(n, g)).astype(np.float64)
    x *= rng.uniform(size=(n, g)) < density
    return np.log2(x + 1).astype(np.float32)


def _stores(*mats):
    return [bt.CSRCells.from_dense(m) for m in mats], [JCSR.from_dense(m) for m in mats]


def test_rescale_batches_csr_matches_jax_and_dense(rng):
    b1 = _sparse_logcounts(rng, 60, 40, scale=3.0)
    b2 = _sparse_logcounts(rng, 80, 40, scale=6.0)
    mine, theirs = _stores(b1, b2)
    out = bt.rescale_batches_csr(mine)
    ref = bj.rescale_batches_csr(theirs)
    for s_in, s_out, r in zip(mine, out, ref):
        assert np.array_equal(s_in.indices, s_out.indices)
        assert np.array_equal(s_in.indptr, s_out.indptr)
        assert np.allclose(s_out.data, r.data, atol=1e-6, rtol=0)
    dense = bt.rescale_batches([b1, b2], device="cpu")
    got = np.vstack([s.to_dense() for s in out])
    assert np.allclose(got, dense.corrected.numpy(), atol=1e-5)


def test_rescale_batches_csr_restrict_and_subset(rng):
    b1 = _sparse_logcounts(rng, 50, 30, scale=3.0)
    b2 = _sparse_logcounts(rng, 70, 30, scale=5.0)
    res, sub = [np.arange(0, 50, 2), None], np.arange(10)
    mine, theirs = _stores(b1, b2)
    out = bt.rescale_batches_csr(mine, restrict=res, subset_row=sub)
    ref = bj.rescale_batches_csr(theirs, restrict=res, subset_row=sub)
    got = np.vstack([s.to_dense() for s in out])
    assert got.shape[1] == 10
    assert np.allclose(got, np.vstack([s.to_dense() for s in ref]), atol=1e-6, rtol=0)
    dense = bt.rescale_batches([b1, b2], restrict=res, subset_row=sub, device="cpu")
    assert np.allclose(got, dense.corrected.numpy(), atol=1e-5)
    every = bt.rescale_batches_csr(mine, subset_row=sub, correct_all=True)
    assert every[0].n_genes == 30
    with pytest.raises(ValueError, match="pseudo_count"):
        bt.rescale_batches_csr(mine, pseudo_count=2.0)
    with pytest.raises(ValueError, match="two batches"):
        bt.rescale_batches_csr(mine[:1])


def test_regress_batches_csr_matches_jax_and_dense(rng):
    b1 = _sparse_logcounts(rng, 40, 25)
    b2 = _sparse_logcounts(rng, 50, 25)
    mine, theirs = _stores(b1, b2)
    op = bt.regress_batches_csr(mine, block_rows=16, device="cpu")
    ref = bj.regress_batches_csr(theirs, block_rows=16)
    assert op.shape == (90, 25)
    full = op.materialize()
    assert np.allclose(full, ref.materialize(), atol=1e-5, rtol=0)
    assert np.allclose(op.beta, ref.beta, atol=1e-5, rtol=0)
    dense = bt.regress_batches([b1, b2], device="cpu")
    assert np.allclose(full, dense.corrected.numpy(), atol=1e-4)
    assert np.allclose(op.block(10, 30), full[10:30])
    blocks = [blk for blk, _ in op.blocks(block_rows=13)]
    assert np.allclose(np.vstack(blocks), full)


def test_regress_batches_csr_restrict_keep_design(rng):
    b1 = _sparse_logcounts(rng, 40, 20)
    b2 = _sparse_logcounts(rng, 50, 20)
    res = [np.arange(0, 40, 2), np.arange(25)]
    mine, theirs = _stores(b1, b2)
    op = bt.regress_batches_csr(mine, restrict=res, keep=[0], block_rows=16, device="cpu")
    ref = bj.regress_batches_csr(theirs, restrict=res, keep=[0], block_rows=16)
    assert np.allclose(op.materialize(), ref.materialize(), atol=1e-5, rtol=0)
    dense = bt.regress_batches([b1, b2], restrict=res, keep=[0], device="cpu")
    assert np.allclose(op.materialize(), dense.corrected.numpy(), atol=1e-4)
    design = np.stack([np.ones(90), rng.normal(size=90)], 1)
    op = bt.regress_batches_csr(mine, design=design, block_rows=32, device="cpu")
    ref = bj.regress_batches_csr(theirs, design=design, block_rows=32)
    assert np.allclose(op.materialize(), ref.materialize(), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="one row per cell"):
        bt.regress_batches_csr(mine, design=design[:10], device="cpu")


@pytest.fixture(scope="module")
def classic_inputs():
    """Log-counts times a uniform jitter: distances between discrete
    log-counts tie exactly, and the two packages break kNN ties apart."""
    rng = np.random.default_rng(42)
    b1, b2 = (_sparse_logcounts(rng, n, 30, density=0.6)
              * rng.uniform(0.5, 1.5, size=(n, 30)).astype(np.float32) for n in (50, 60))
    return b1, b2 + np.float32(0.5), np.arange(15)


@pytest.mark.parametrize("correct_all", [False, True])
def test_mnn_correct_csr_matches_jax(classic_inputs, correct_all):
    b1, b2, sub = classic_inputs
    mine, theirs = _stores(b1, b2)
    kw = dict(subset_row=sub, correct_all=correct_all, var_adj=False)
    out = bt.mnn_correct_csr(mine, device="cpu", **kw)
    ref = bj.mnn_correct_csr(theirs, **kw)
    assert isinstance(out.corrected, np.ndarray) == correct_all   # out_on_host
    got = out.corrected if correct_all else out.corrected.numpy()
    assert got.shape == (110, 30 if correct_all else 15)
    assert np.allclose(got, np.asarray(ref.corrected), atol=1e-5, rtol=0)
    assert np.array_equal(out.merge_info[0].pairs, ref.merge_info[0].pairs)
    dense = bt.mnn_correct([b1, b2], device="cpu", **kw)
    assert np.allclose(got, dense.corrected.numpy(), atol=1e-5, rtol=0)


def test_mnn_correct_csr_without_subset(classic_inputs):
    b1, b2, _ = classic_inputs
    mine, _ = _stores(b1, b2)
    out = bt.mnn_correct_csr(mine, block_rows=32, var_adj=False, device="cpu")
    dense = bt.mnn_correct([b1, b2], var_adj=False, device="cpu")
    assert torch.equal(out.corrected, dense.corrected)


def _cluster_logcounts(rng, n, g, lam=0.6):
    return np.log1p(rng.poisson(lam, size=(n, g))).astype(np.float32)


def _gene_space(res):
    return np.asarray(res.corrected) @ np.asarray(res.rotation).T


def _same_cluster(mine, theirs):
    a = [set(map(tuple, i.pairs.tolist())) for i in mine.centroid_result.merge_info]
    b = [set(map(tuple, i.pairs.tolist())) for i in theirs.centroid_result.merge_info]
    assert a == b
    for key in ("cluster", "batch", "meta"):
        assert np.array_equal(mine.cluster_meta[key], np.asarray(theirs.cluster_meta[key])), key
    assert np.array_equal(mine.cluster, np.asarray(theirs.cluster))
    want = _gene_space(theirs)
    got = mine.corrected.numpy() @ mine.rotation.numpy().T
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_cluster_mnn_csr_matches_jax_and_dense(rng):
    x1 = _cluster_logcounts(rng, 240, 50)
    x2 = _cluster_logcounts(rng, 180, 50) + np.float32(0.1)
    c1, c2 = rng.integers(0, 3, 240), rng.integers(0, 3, 180)
    mine, theirs = _stores(x1, x2)
    out = tc.cluster_mnn_csr(mine, clusters=[c1, c2], block_rows=64, device="cpu")
    ref = jc.cluster_mnn_csr(theirs, clusters=[c1, c2], block_rows=64)
    _same_cluster(out, ref)
    dense = tc.cluster_mnn([x1, x2], clusters=[c1, c2], device="cpu")
    np.testing.assert_allclose(out.corrected.numpy(), dense.corrected.numpy(),
                               atol=1e-6, rtol=1e-6)
    assert np.array_equal(out.cluster_meta["meta"], dense.cluster_meta["meta"])


def test_cluster_mnn_csr_subset_restrict(rng):
    x1 = _cluster_logcounts(rng, 150, 40)
    x2 = _cluster_logcounts(rng, 120, 40) + np.float32(0.2)
    c1, c2 = rng.integers(0, 2, 150), rng.integers(0, 2, 120)
    sub = np.arange(0, 40, 2)
    r1 = np.sort(rng.choice(150, 100, replace=False))
    kw = dict(clusters=[c1, c2], subset_row=sub, correct_all=True, restrict=[r1, None],
              batch_names=["a", "b"])
    mine, theirs = _stores(x1, x2)
    out = tc.cluster_mnn_csr(mine, block_rows=32, device="cpu", **kw)
    ref = jc.cluster_mnn_csr(theirs, block_rows=32, **kw)
    _same_cluster(out, ref)
    assert list(out.batch[:1]) == ["a"] and out.rotation.shape == (40, out.corrected.shape[1])
    dense = tc.cluster_mnn([x1, x2], device="cpu", **kw)
    np.testing.assert_allclose(out.corrected.numpy(), dense.corrected.numpy(),
                               atol=1e-6, rtol=1e-6)


def test_cluster_mnn_csr_kmeans_matches_dense(rng):
    means = rng.normal(size=(2, 30)) * 3
    mats = [np.abs(means[np.repeat([0, 1], n // 2)] + rng.normal(size=(n, 30)) * 0.3
                   ).astype(np.float32) for n in (80, 60)]
    out = tc.cluster_mnn_csr([bt.CSRCells.from_dense(m) for m in mats], clusters=2,
                             device="cpu")
    dense = tc.cluster_mnn(mats, clusters=2, device="cpu")
    for b in range(2):
        lo, hi = (0, 80) if b == 0 else (80, 140)
        pairs = set(zip(out.cluster[lo:hi].tolist(), dense.cluster[lo:hi].tolist()))
        assert len(pairs) == 2                 # the same partition, up to relabelling
    assert torch.isfinite(out.corrected).all()


def test_cluster_mnn_csr_input_validation(rng):
    x1 = _cluster_logcounts(rng, 50, 20)
    with pytest.raises(ValueError, match="two batches"):
        tc.cluster_mnn_csr([bt.CSRCells.from_dense(x1)], clusters=[np.zeros(50)],
                           device="cpu")
    with pytest.raises(ValueError, match="CSRCells"):
        tc.cluster_mnn_csr([x1, x1], clusters=[np.zeros(50)] * 2, device="cpu")
    x2 = _cluster_logcounts(rng, 40, 19)
    with pytest.raises(ValueError, match="same genes"):
        tc.cluster_mnn_csr([bt.CSRCells.from_dense(x1), bt.CSRCells.from_dense(x2)],
                           clusters=[np.zeros(50), np.zeros(40)], device="cpu")
    with pytest.raises(ValueError, match="one entry per batch"):
        tc.cluster_mnn_csr([bt.CSRCells.from_dense(x1)] * 2, clusters=[np.zeros(50)],
                           device="cpu")


@pytest.mark.parametrize("cos_norm", [True, False])
def test_blocked_delta_variance_csr_matches_jax_and_dense(rng, cos_norm):
    b1 = rng.poisson(3.0, size=(70, 40)).astype(np.float32)
    b2 = rng.poisson(5.0, size=(90, 40)).astype(np.float32)
    b1[rng.uniform(size=b1.shape) < 0.5] = 0
    p0 = np.stack([rng.integers(0, 70, 50), 70 + rng.integers(0, 90, 50)], axis=1)
    p1 = np.stack([rng.integers(0, 70, 33), 70 + rng.integers(0, 90, 33)], axis=1)
    mine, theirs = _stores(b1, b2)
    kw = dict(cos_norm=cos_norm, chunk_pairs=16, subset_row=np.arange(0, 40, 3))
    csr = bt.mnn_delta_variance_blocked(mine, [p0, p1], device="cpu", **kw)
    with port_trend_in_jax():
        ref = bj.mnn_delta_variance_blocked(theirs, [p0, p1], **kw)
    dense = bt.mnn_delta_variance_blocked([b1, b2], [p0, p1], device="cpu", **kw)
    for f in ("mean", "total", "trend", "adjusted"):
        assert np.allclose(getattr(csr, f), getattr(ref, f), atol=1e-5, rtol=0), f
        assert np.allclose(getattr(csr, f), getattr(dense, f), atol=1e-10, rtol=0), f
