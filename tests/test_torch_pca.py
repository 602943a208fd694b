"""The port's cosine normalization, multi-batch PCA and LowRankOp against
the JAX package's, on the CPU in fp64.

Mirrors tests/test_pca.py. Each case runs batchelor_tpu's function and the
port's (device="cpu") on the same numpy inputs. Eigenvector signs are fixed
by neither library, so each port column is flipped to the sign of JAX's
before components and rotations are compared (1e-8); centers and variances
agree to 1e-10 relative. The randomized method draws its start block from
jax.random in the JAX package and from a seeded torch generator in the
port: with JAX's block passed in the results agree to 1e-8; with the port's
own block the subspaces agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batchelor_torch import LowRankOp, cosine_norm, multi_batch_pca, pca_to_numpy
from batchelor_torch.ops import pca as tpca
from batchelor_tpu.ops import cosine_norm as jcos
from batchelor_tpu.ops import pca as jpca
from batchelor_tpu.ops.lowrank import LowRankOp as JLowRankOp

torch.set_num_threads(2)


def signs(want: np.ndarray, got: np.ndarray) -> np.ndarray:
    """Per-column sign that turns ``got``'s columns toward ``want``'s."""
    s = np.sign(np.sum(np.asarray(want) * np.asarray(got), axis=0))
    s[s == 0] = 1.0
    return s


def jax_start(g: int, n: int, d: int) -> np.ndarray:
    """The start block the JAX package's randomized method draws for a
    (n, g) scaled matrix: (min(g, n), min(d + 16, min(g, n)))."""
    m = min(g, n)
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (m, min(d + 16, m)), jnp.float64))


def assert_pca_same(jres, tres, atol=1e-8):
    tres = pca_to_numpy(tres)
    s = signs(jres.rotation, tres.rotation)
    assert np.allclose(np.asarray(jres.rotation), tres.rotation * s, atol=atol, rtol=0)
    assert len(jres.components) == len(tres.components)
    for a, b in zip(jres.components, tres.components):
        assert np.allclose(np.asarray(a), b * s, atol=atol, rtol=0)
    assert np.allclose(np.asarray(jres.centers), tres.centers, rtol=1e-10, atol=1e-14)
    if jres.var_explained is None:
        assert tres.var_explained is None and tres.var_total is None
    else:
        assert np.allclose(jres.var_explained, tres.var_explained, rtol=1e-10, atol=0)
        assert tres.var_total == pytest.approx(jres.var_total, rel=1e-10)
    assert jres.batch_names == tres.batch_names


def _mats(rng, g=40):
    return [rng.normal(size=(60, g)), rng.normal(size=(90, g)) + 1.0,
            rng.normal(size=(70, g)) - 0.5]


@pytest.mark.parametrize("mode", ["matrix", "l2norm", "all"])
@pytest.mark.parametrize("subset", [False, True])
def test_cosine_norm_matches_jax(mode, subset, rng):
    x = rng.normal(size=(50, 30)) * 3.0
    x[4] = 0.0                                      # zero norm: the 1e-8 floor
    sub = np.arange(0, 30, 3) if subset else None
    want = jcos.cosine_norm(jnp.asarray(x), mode=mode, subset_row=sub)
    got = cosine_norm(torch.from_numpy(x), mode=mode, subset_row=sub)
    want = want if mode == "all" else (want,)
    got = got if mode == "all" else (got,)
    for a, b in zip(want, got):
        assert np.allclose(np.asarray(a), b.numpy(), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        cosine_norm(torch.from_numpy(x), mode="nope")


def test_weight_vector_modes():
    cases = [([10, 20], None, None), ([10, 20], True, None), ([10, 20], False, None),
             ([10, 20], [2.0, 3.0], None), ([10, 20, 5], [0, [1, 2]], None),
             ([1, 2, 3, 4], [["a", "b"], ["c", ["d"]]], ["a", "b", "c", "d"])]
    for ncells, weights, names in cases:
        want = jpca.construct_weight_vector(ncells, weights, names)
        got = tpca.construct_weight_vector(ncells, weights, names)
        assert np.array_equal(want, got)
    assert np.allclose(tpca.construct_weight_vector([10, 20, 5], [0, [1, 2]]), [0.5, 0.25, 0.25])
    for bad in ([1.0], [0, [0, 1]]):
        with pytest.raises(ValueError):
            tpca.construct_weight_vector([10, 20, 5], bad)


PCA_CASES = {
    "plain": dict(d=8),
    "subset": dict(d=6, subset_row=np.arange(0, 40, 2)),
    "all_genes": dict(d=6, subset_row=np.arange(0, 40, 2), get_all_genes=True),
    "variance": dict(d=8, get_variance=True, batch_names=["x", "y", "z"]),
    "tree_weights": dict(d=8, weights=[0, [1, 2]]),
    "false_weights": dict(d=8, weights=False, get_variance=True),
    "d_none": dict(d=None, get_variance=True),
    "d_none_all_genes": dict(d=None, subset_row=np.arange(0, 40, 4), get_all_genes=True),
    "wide": dict(d=10, genes=120),                  # G > sum N: the cell-side Gram
}


# the direct SVD on the cases where its path differs (each JAX call costs ~1 s)
PCA_RUNS = [(case, "gram") for case in sorted(PCA_CASES)] + [
    (case, "direct") for case in ("all_genes", "variance", "wide")]


@pytest.mark.parametrize("case,method", PCA_RUNS)
def test_multi_batch_pca_matches_jax(case, method, rng):
    kw = dict(PCA_CASES[case])
    mats = _mats(rng, kw.pop("genes", 40))
    if case == "wide":
        mats = [m[:30] for m in mats]
    want = jpca.multi_batch_pca([jnp.asarray(m) for m in mats], method=method, **kw)
    got = multi_batch_pca(mats, method=method, device="cpu", **kw)
    assert_pca_same(want, got)


@pytest.mark.parametrize("genes", [40, 120])
def test_randomized_with_jax_start_matches_jax(genes, rng):
    mats = [m[:, :genes] for m in _mats(rng, genes)]
    n = sum(m.shape[0] for m in mats)
    want = jpca.multi_batch_pca([jnp.asarray(m) for m in mats], d=8, method="randomized")
    got = multi_batch_pca(mats, d=8, method="randomized", device="cpu",
                          start=jax_start(genes, n, 8))
    assert_pca_same(want, got)
    with pytest.raises(ValueError):
        multi_batch_pca(mats, d=8, method="randomized", device="cpu", start=np.zeros((3, 3)))


def test_randomized_own_start_spans_jax_subspace(rng):
    """Low-rank data plus weak noise: the top-5 subspace is well separated,
    so both start blocks converge to it; the largest principal angle
    between the port's and JAX's rotations is below 1e-6."""
    basis = rng.normal(size=(5, 60)) * 10.0
    mats = [rng.normal(size=(n, 5)) @ basis + 0.05 * rng.normal(size=(n, 60)) + shift
            for n, shift in ((120, 0.0), (150, 1.0))]
    want = np.asarray(jpca.multi_batch_pca([jnp.asarray(m) for m in mats], d=5,
                                           method="randomized").rotation)
    got = multi_batch_pca(mats, d=5, method="randomized", device="cpu").rotation.numpy()
    assert np.allclose(got.T @ got, np.eye(5), atol=1e-10)
    sin_max = np.linalg.norm(want - got @ (got.T @ want), 2)
    assert sin_max <= 1e-6
    # the port's start block is the same on every device: a CPU generator, seed 0
    a = tpca._start_block(7, 3, torch.float64, torch.device("cpu"))
    assert torch.equal(a, tpca._start_block(7, 3, torch.float64, torch.device("cpu")))


def test_lowrank_op_matches_jax(rng):
    left, right = rng.normal(size=(30, 6)), rng.normal(size=(45, 6))
    j, t = JLowRankOp(jnp.asarray(left), jnp.asarray(right)), LowRankOp(
        torch.from_numpy(left), torch.from_numpy(right))
    other = rng.normal(size=(45, 3))
    for op_j, op_t in ((j, t), (j.T, t.T)):
        assert op_j.shape == op_t.shape and op_t.ndim == 2
        for rows, cols in ((None, None), ([3, 1], slice(2, 20, 3)), (slice(None, 5), [0])):
            assert np.allclose(np.asarray(op_j.block(rows, cols)),
                               op_t.block(rows, cols).numpy(), atol=1e-12)
        assert np.allclose(np.asarray(op_j[2]), op_t[2].numpy(), atol=1e-12)
        assert np.allclose(np.asarray(op_j[1, 4]), op_t[1, 4].numpy(), atol=1e-12)
        assert np.allclose(np.asarray(op_j.row_sums()), op_t.row_sums().numpy(), atol=1e-10)
        assert np.allclose(np.asarray(op_j.col_sums()), op_t.col_sums().numpy(), atol=1e-10)
        assert np.allclose(np.asarray(op_j), np.asarray(op_t), atol=1e-12)
    assert np.allclose(np.asarray(j @ other), (t @ other).numpy(), atol=1e-10)
    assert np.allclose(np.asarray(other.T @ j.T), (t.T.__rmatmul__(other.T)).numpy(), atol=1e-10)
    assert np.allclose((t @ t.T).numpy(), left @ right.T @ right @ left.T, atol=1e-9)
