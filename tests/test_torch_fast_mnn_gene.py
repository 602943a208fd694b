"""The port's fast_mnn (from gene space) against the JAX package's, on the
CPU in fp64.

Mirrors the fast_mnn cases of tests/test_fast_mnn.py. Each case runs
batchelor_tpu.fast_mnn and batchelor_torch.fast_mnn (device="cpu") on the
same numpy inputs. PCA eigenvector signs are fixed by neither library, and a
column's sign flips the same column of the corrected coordinates (kNN
distances do not see it), so each port column is turned to the sign of
JAX's rotation column first. Then every merge step's pairs are identical,
corrected and rotation agree to 1e-8, lost_var and batch_size to 1e-8, and
labels and names are identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batchelor_torch import fast_mnn as t_fast_mnn
from batchelor_torch import reduced_mnn as t_reduced_mnn
from batchelor_torch import result_to_numpy
from batchelor_tpu.correct.fast_mnn import fast_mnn as j_fast_mnn
from test_torch_pca import jax_start, signs

torch.set_num_threads(2)

N1, N2, G = 100, 150, 60


def _assert_same(jres, tres):
    tres = result_to_numpy(tres)
    s = signs(jres.rotation, tres.rotation)
    assert np.allclose(np.asarray(jres.rotation), tres.rotation * s, atol=1e-8, rtol=0)
    assert np.allclose(np.asarray(jres.corrected), tres.corrected * s, atol=1e-8, rtol=0)
    assert np.allclose(np.asarray(jres.centers), tres.centers, atol=1e-12, rtol=0)
    assert np.array_equal(np.asarray(jres.batch), np.asarray(tres.batch))
    assert len(jres.merge_info) == len(tres.merge_info)
    for a, b in zip(jres.merge_info, tres.merge_info):
        assert list(a.left) == list(b.left) and list(a.right) == list(b.right)
        assert np.array_equal(a.pairs, b.pairs)
        assert a.skipped == b.skipped
        assert abs(a.batch_size - b.batch_size) <= 1e-8
        assert np.allclose(a.lost_var, b.lost_var, atol=1e-8, rtol=0, equal_nan=True)
    if jres.var_explained is None:
        assert tres.var_explained is None
    else:
        assert np.allclose(jres.var_explained, tres.var_explained, rtol=1e-10, atol=0)
        assert tres.var_total == pytest.approx(jres.var_total, rel=1e-10)
    for name in ("batch_names", "cell_names", "gene_names"):
        a, b = getattr(jres, name), getattr(tres, name)
        assert (a is None and b is None) or np.array_equal(np.asarray(a), np.asarray(b))


def _batches(rng):
    return [rng.normal(size=(N1, G)) - 1, rng.normal(size=(N2, G)) + 1]


def _case(name, rng):
    """(inputs, kwargs) of one case, covering the fast_mnn cases of
    tests/test_fast_mnn.py. Each JAX fast_mnn call costs seconds on the
    CPU, so options that do not interact share a case."""
    b1, b2 = _batches(rng)
    if name == "basic_names_variance":            # basic, names, get_variance
        cells = [[f"a{i}" for i in range(N1)], [f"b{i}" for i in range(N2)]]
        return [b1, b2], {"d": 10, "k": 20, "get_variance": True, "weights": [1.0, 2.0],
                          "batch_names": ["first", "second"], "cell_names": cells,
                          "gene_names": [f"g{i}" for i in range(G)]}
    if name == "single_randomized":               # single_vs_multi, svd_method
        combined = np.concatenate([b1, b2])
        batch = np.repeat([0, 1], [N1, N2])
        shuffle = rng.permutation(N1 + N2)
        return combined[shuffle], {"batch": batch[shuffle], "d": 10,
                                   "svd_method": "randomized"}
    if name == "correct_all":
        return [b1, b2], {"d": 10, "subset_row": np.arange(0, G, 2), "correct_all": True,
                          "gene_names": [f"g{i}" for i in range(G)]}
    if name == "d_none_prop_k":                   # d_none, prop_k
        return [b1[:, :12], b2[:, :12]], {"d": None, "cos_norm": False, "k": 5, "prop_k": 0.1}
    raise KeyError(name)


CASES = ["basic_names_variance", "single_randomized", "correct_all", "d_none_prop_k"]


@pytest.mark.parametrize("name", CASES)
def test_fast_mnn_matches_jax(name, rng):
    inputs, kw = _case(name, rng)
    tkw = dict(kw)
    if kw.get("svd_method") == "randomized":
        tkw["svd_start"] = jax_start(G, N1 + N2, 10)
    jin = [jnp.asarray(b) for b in inputs] if isinstance(inputs, list) else jnp.asarray(inputs)
    jres = j_fast_mnn(jin, **kw)
    tres = t_fast_mnn(inputs, device="cpu", **tkw)
    _assert_same(jres, tres)
    if name == "basic_names_variance":
        # reconstructed: the lazy rotation @ corrected.T; column signs cancel
        op = tres.reconstructed()
        assert op.shape == (G, N1 + N2)
        want = np.asarray(jres.reconstructed(rows=[0, 5], cols=slice(0, 7)))
        got = tres.reconstructed(rows=[0, 5], cols=slice(0, 7)).numpy()
        assert np.allclose(want, got, atol=1e-8)
        assert np.allclose(np.asarray(op), tres.rotation.numpy() @ tres.corrected.numpy().T)


def test_fast_mnn_single_equals_list_and_names_follow_subset(rng):
    """Inside the port: the single-matrix form returns the list form's
    corrected values in input order (tests/test_fast_mnn.py
    test_fast_mnn_single_vs_multi), and gene names follow the subset."""
    b1, b2 = _batches(rng)
    shuffle = rng.permutation(N1 + N2)
    ref = t_fast_mnn([b1, b2], d=10, device="cpu")
    out = t_fast_mnn(np.concatenate([b1, b2])[shuffle], batch=np.repeat([0, 1], [N1, N2])[shuffle],
                     d=10, device="cpu")
    s = signs(ref.rotation.numpy(), out.rotation.numpy())
    assert np.allclose(out.corrected.numpy() * s, ref.corrected.numpy()[shuffle], atol=1e-8)
    genes = np.array([f"g{i}" for i in range(G)], dtype=object)
    sub = t_fast_mnn([b1, b2], d=5, subset_row=np.arange(0, G, 3), gene_names=genes,
                     device="cpu")
    assert np.array_equal(sub.gene_names, genes[::3]) and sub.rotation.shape == (20, 5)


def test_fast_mnn_argument_errors(rng, tmp_path):
    b1, b2 = _batches(rng)
    with pytest.raises(ValueError):
        t_fast_mnn([b1], device="cpu")
    with pytest.raises(ValueError):
        t_fast_mnn(np.concatenate([b1, b2]), device="cpu")
    with pytest.raises(ValueError):
        t_fast_mnn([b1, b2], d=10, batch_names=["x", "x"], device="cpu")
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "merge_meta.json").write_text('{"version": 2, "completed": 0}')
    with pytest.raises(ValueError, match="checkpoint version"):
        t_fast_mnn([b1, b2], checkpoint_dir=str(ckpt), device="cpu")
    with pytest.raises(ValueError):
        t_reduced_mnn([b1[:, :5], b2[:, :5]], device="cpu").reconstructed()
