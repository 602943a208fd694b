"""The port's correction math against the JAX package's, on the CPU in fp64
(tolerance 1e-10)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from batchelor_torch.ops import correction as tc
from batchelor_tpu.ops import correction as jc
from batchelor_tpu.ops.knn import query_knn as j_query_knn

torch.set_num_threads(2)

T = torch.from_numpy


def _close(j, t, atol=1e-10):
    t = t.numpy() if isinstance(t, torch.Tensor) else t
    assert np.allclose(np.asarray(j), t, atol=atol, rtol=0)


def test_average_correction_matches_jax(rng):
    ref = rng.normal(size=(100, 10))
    cur = rng.normal(size=(80, 10))
    mnn1 = rng.integers(0, 100, size=250)
    mnn2 = rng.integers(0, 80, size=250)
    javg, jsec = jc.average_correction(jnp.asarray(ref), mnn1, jnp.asarray(cur), mnn2)
    tavg, tsec = tc.average_correction(T(ref), mnn1, T(cur), mnn2)
    assert np.array_equal(jsec, tsec)
    _close(javg, tavg)


@pytest.mark.parametrize("kind", ["random", "identical", "zeros"])
def test_batch_magnitude_matches_jax(kind, rng):
    c = {"random": rng.normal(size=(50, 8)) + 2.0,
         "identical": np.tile(rng.normal(size=(1, 8)), (30, 1)),
         "zeros": np.zeros((10, 8))}[kind]
    j = float(jc.batch_magnitude(jnp.asarray(c)))
    t = tc.batch_magnitude(T(c))
    assert t.dim() == 0
    assert abs(j - float(t)) <= 1e-10


@pytest.mark.parametrize("restricted", [False, True])
def test_center_along_batch_vector_matches_jax(restricted, rng):
    m = rng.normal(size=(60, 12))
    v = rng.normal(size=12)
    res = np.arange(0, 60, 3) if restricted else None
    j = jc.center_along_batch_vector(jnp.asarray(m), jnp.asarray(v), res)
    t = tc.center_along_batch_vector(T(m), T(v), res)
    _close(j, t)


def test_orthogonalize_other_matches_jax(rng):
    m = rng.normal(size=(40, 6))
    vecs = [rng.normal(size=6), rng.normal(size=6)]
    res = np.arange(0, 40, 2)
    j = jc.orthogonalize_other(jnp.asarray(m), res, [jnp.asarray(v) for v in vecs])
    t = tc.orthogonalize_other(T(m), res, [T(v) for v in vecs])
    _close(j, t)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_per_batch_var_matches_jax(dtype, rng):
    # offset batches: the mean-shifted form keeps fp32 accurate
    data = (rng.normal(size=(70, 6)) * 0.1 + 50.0).astype(dtype)
    origin = np.repeat([4, 1, 2], [20, 30, 20])
    index = [1, 2, 4]
    j = jc.per_batch_var(jnp.asarray(data), index, origin)
    labels = np.searchsorted(index, origin)
    counts = np.bincount(labels, minlength=len(index))
    ssd = tc.per_batch_var(T(data), torch.from_numpy(labels), torch.from_numpy(counts))
    t = tc.batch_var(ssd.numpy(), counts)
    assert t.dtype == np.float64
    atol = 1e-10 if dtype == np.float64 else 1e-6
    assert np.allclose(j, t, atol=atol, rtol=0)
    one = torch.ones(1, dtype=torch.long)
    single = tc.batch_var(tc.per_batch_var(T(data[:1]), one - 1, one).numpy(), [1])
    assert single.tolist() == [0.0]


def _neighbours(rng, k=11):
    query = rng.normal(size=(90, 5))
    pts = rng.normal(size=(40, 5))
    idx, dist = j_query_knn(jnp.asarray(query), jnp.asarray(pts), k)
    return np.array(idx), np.array(dist)


def test_tricube_weights_matches_jax(rng):
    _, dist = _neighbours(rng)
    dist = dist.copy()
    dist[::5, -3:] = np.inf            # mask-excluded neighbours
    _close(jc.tricube_weights(jnp.asarray(dist)), tc.tricube_weights(T(dist)))
    zero = np.zeros((4, 3))
    _close(jc.tricube_weights(jnp.asarray(zero)), tc.tricube_weights(T(zero)))


@pytest.mark.parametrize("bandwidth", [False, True])
def test_tricube_average_matches_jax(bandwidth, rng):
    vals = rng.normal(size=(40, 7))
    idx, dist = _neighbours(rng)
    bw = np.abs(rng.normal(size=90)) + 4.0 if bandwidth else None
    j = jc.tricube_average(jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(dist),
                           ndist=3.0, bandwidth=None if bw is None else jnp.asarray(bw))
    t = tc.tricube_average(T(vals), T(idx), T(dist), ndist=3.0,
                           bandwidth=None if bw is None else T(bw))
    assert torch.isfinite(t).all()
    _close(j, t)


@pytest.mark.parametrize("k", [3, 20])
def test_tricube_weighted_correction_matches_jax(k, rng):
    cur = rng.normal(size=(30, 6))
    in_mnn = np.arange(0, 30, 2)
    corr = rng.normal(size=(15, 6))
    j = jc.tricube_weighted_correction(jnp.asarray(cur), jnp.asarray(corr), in_mnn, k=k)
    t = tc.tricube_weighted_correction(T(cur), T(corr), in_mnn, k=k)
    _close(j, t)
