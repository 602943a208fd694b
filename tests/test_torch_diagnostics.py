"""The port's trend fit, variance model, HVG selection and diagnostics
against the JAX package's, on the CPU in fp64.

Covers the dense cases of tests/test_diagnostics_api.py that are not about
the dispatch API or the pipelines (those are in test_torch_api.py): each
runs the batchelor_tpu function and its batchelor_torch counterpart on the
same numpy inputs. Tolerances: the trend fit is the same host numpy code
but for the floor the JAX package puts under its smoothed log-ratio, and
must agree bit for bit where that floor does not bind and to 1e-12 of the
JAX package's curve and smoother without it; the comparisons downstream of
the trend run the JAX package on the port's trend (``jax_trend.py``): the
variance model and delta variance 1e-10 (fp64 reductions in another
order); the HVG ranking exactly; the abundance
p-values and variances 1e-12 (``torch.special.gammaincc`` against
``jax.scipy.special.gammaincc``); the blocked delta variance 1e-5 against
the JAX package's (which sums each float32 chunk in float32; the port sums
it in fp64) and 1e-5 against the port's dense one, as the JAX test holds
its two forms.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from batchelor_torch.correct import diagnostics as td
from batchelor_torch.ops import stats as ts
from batchelor_tpu.correct import diagnostics as jd
from batchelor_tpu.correct.fast_mnn import fast_mnn as j_fast_mnn
from batchelor_tpu.ops import stats as js
from jax_trend import port_trend_in_jax

torch.set_num_threads(2)

FIELDS = ("mean", "total", "trend", "adjusted")


@pytest.fixture(scope="module")
def delta_inputs():
    """Two batches whose gene 5 has an inconsistent batch effect, and the
    JAX package's fast_mnn pairs between them (one JAX call per module)."""
    rng = np.random.default_rng(42)
    b1 = rng.normal(size=(100, 30))
    b2 = rng.normal(size=(100, 30))
    b2[:, 5] += rng.normal(scale=4.0, size=100)
    res = j_fast_mnn([jnp.asarray(b1), jnp.asarray(b2)], d=10)
    pairs = [i.pairs for i in res.merge_info]
    return b1, b2, pairs + [pairs[0][::3]]         # and a second, smaller step


def _same_table(j, t, tol):
    for f in FIELDS:
        assert np.allclose(getattr(j, f), getattr(t, f), atol=tol, rtol=0, equal_nan=True), f
    assert len(j.per_step) == len(t.per_step)
    for a, b in zip(j.per_step, t.per_step):
        for f in FIELDS:
            assert np.allclose(a[f], b[f], atol=tol, rtol=0, equal_nan=True), f


def _held_to_jax(x, y, q, **kw):
    """The port's parametric trend at ``q`` against the JAX package's: bit
    for bit where the JAX package's floor of the smoothed log-ratio does not
    bind, and everywhere to 1e-12 of the JAX package's curve times exp of
    its smoother run on the log-ratio lifted clear of that floor (the
    smoother is linear in y). Returns how many queries the floor held up."""
    ours, floored = td.fit_trend_var(x, y, **kw)(q), jd.fit_trend_var(x, y, **kw)(q)
    pos = (x > 0) & (y > 0)
    curve = jd._fit_parametric_curve(x[pos], y[pos])
    ratio = np.log(y[pos] / curve(x[pos]))
    lift = 100.0 * (1.0 + np.ptp(ratio))
    lifted = jd.fit_trend_var(x[pos], ratio + lift, parametric=False, **kw)(q)
    assert (lifted > 0).all()
    assert np.allclose(ours, curve(q) * np.exp(lifted - lift), rtol=1e-12, atol=0), kw
    free = ours >= curve(q)
    assert np.array_equal(ours[free], floored[free]), kw
    assert (ours[~free] < floored[~free]).all(), kw
    return int((~free).sum())


def test_fit_trend_var_is_the_jax_code(rng):
    x = np.linspace(0.5, 5, 200)
    y = 2 * x + rng.normal(scale=0.05, size=200)
    q = np.array([1.0, 2.5, 4.0])
    held = _held_to_jax(x, y, q)
    assert np.allclose(td.fit_trend_var(x, y)(q), 2 * q, rtol=0.1)
    # the scran shape y = a x / (x^n + b), its hump and its decay past the data
    a, b, n = 3.0, 2.0, 2.0
    x = np.exp(rng.uniform(np.log(0.05), np.log(8.0), size=400))
    y = a * x / (x**n + b) * np.exp(rng.normal(scale=0.15, size=400))
    q = np.concatenate([np.exp(np.linspace(np.log(0.1), np.log(6.0), 25)), [20.0, 40.0]])
    for kw in ({}, {"span": 0.5}):
        held += _held_to_jax(x, y, q, **kw)
    # the trend falls below its curve somewhere, as scran's may
    assert held > 0
    assert np.array_equal(td.fit_trend_var(x, y, parametric=False)(q),
                          jd.fit_trend_var(x, y, parametric=False)(q))
    assert np.allclose(td.fit_trend_var(x, y)(q[:25]), a * q[:25] / (q[:25]**n + b), rtol=0.15)
    # degenerate inputs fall back to the smoother, or to a constant
    x3, y3 = np.array([1.0, 2.0, 3.0]), np.array([0.5, -0.1, 0.4])
    assert np.array_equal(td.fit_trend_var(x3, y3)(np.array([1.5])),
                          jd.fit_trend_var(x3, y3)(np.array([1.5])))
    assert np.allclose(td.fit_trend_var(x3[:1], y3[:1])(np.array([2.0, 9.0])), 0.5)


def test_model_gene_var_and_hvgs_match_jax(rng):
    x = rng.normal(size=(200, 50))
    x[:, 7] *= 5                     # a highly variable gene
    for block in (None, np.repeat([1, 0], 100)[rng.permutation(200)]):
        with port_trend_in_jax():
            j = js.model_gene_var(jnp.asarray(x), block=block)
        t = ts.model_gene_var(x, block=block, device="cpu")
        for f in ("mean", "total", "tech", "bio"):
            assert np.allclose(getattr(j, f), getattr(t, f), atol=1e-10, rtol=0), f
        for kw in ({"n": 5}, {"n": 50}, {"prop": 0.1}, {"var_threshold": 0.05}):
            assert np.array_equal(js.get_top_hvgs(j, **kw), ts.get_top_hvgs(t, **kw)), kw
        assert 7 in ts.get_top_hvgs(t, n=5).tolist()
    parts = [ts.model_gene_var(x[:100], device="cpu"), ts.model_gene_var(x[100:], device="cpu")]
    with port_trend_in_jax():
        jparts = [js.model_gene_var(jnp.asarray(x[:100])), js.model_gene_var(jnp.asarray(x[100:]))]
    j, t = js.combine_var(jparts), ts.combine_var(parts)
    for f in ("mean", "total", "tech", "bio"):
        assert np.allclose(getattr(j, f), getattr(t, f), atol=1e-10, rtol=0), f


@pytest.mark.parametrize("kw", [{}, {"cos_norm": True},
                                {"subset_row": np.arange(0, 30, 3)},
                                {"subset_row": np.arange(0, 30, 3), "compute_all": True,
                                 "cos_norm": True, "trend_span": 0.5}])
def test_mnn_delta_variance_matches_jax(kw, delta_inputs):
    b1, b2, pairs = delta_inputs
    with port_trend_in_jax():
        j = jd.mnn_delta_variance([jnp.asarray(b1), jnp.asarray(b2)], pairs, **kw)
    t = td.mnn_delta_variance([b1, b2], pairs, device="cpu", **kw)
    _same_table(j, t, 1e-10)
    if not kw:
        assert t.adjusted.shape == (30,) and np.argmax(t.adjusted) == 5
        one = [pairs[0][:1]]          # a step of one pair has no variance
        for fn, mats in ((jd.mnn_delta_variance, [jnp.asarray(b1), jnp.asarray(b2)]),
                         (td.mnn_delta_variance, [b1, b2])):
            with pytest.raises(ValueError, match=">= 2 MNN pairs"):
                fn(mats, one, **({} if fn is jd.mnn_delta_variance else {"device": "cpu"}))


@pytest.mark.parametrize("kw", [{"cos_norm": True},
                                {"subset_row": np.arange(0, 30, 3)},
                                {"subset_row": np.arange(0, 30, 3), "compute_all": True}])
def test_blocked_delta_variance_matches_jax_and_dense(kw, rng):
    b1 = rng.poisson(3.0, size=(70, 30)).astype(np.float32)
    b2 = rng.poisson(5.0, size=(90, 30)).astype(np.float32)
    p0 = np.stack([rng.integers(0, 70, 50), 70 + rng.integers(0, 90, 50)], axis=1)
    p1 = np.stack([rng.integers(0, 70, 33), 70 + rng.integers(0, 90, 33)], axis=1)
    # chunks smaller than the pair counts, one of them short
    with port_trend_in_jax():
        j = jd.mnn_delta_variance_blocked([b1, b2], [p0, p1], chunk_pairs=16, **kw)
    t = td.mnn_delta_variance_blocked([b1, b2], [p0, p1], chunk_pairs=16, device="cpu", **kw)
    _same_table(j, t, 1e-5)
    dense = td.mnn_delta_variance([b1.astype(np.float64), b2.astype(np.float64)], [p0, p1],
                                  device="cpu", **kw)
    for f in FIELDS:
        assert np.allclose(getattr(dense, f), getattr(t, f), atol=1e-5), f
    with pytest.raises(TypeError, match="dense"):
        td.mnn_delta_variance_blocked([b1.tolist(), b2], [p0], device="cpu")


def test_cluster_abundance_test_matches_jax(rng):
    tables = [np.array([[50.0, 50.0], [50, 50]]),
              np.array([[50.0, 50.0], [50, 50], [95, 5]]),
              rng.integers(1, 400, size=(12, 5)).astype(np.float64)]
    for tab in tables:
        ours = td.cluster_abundance_test(tab, device="cpu")
        assert np.allclose(ours, jd.cluster_abundance_test(tab), atol=1e-12, rtol=0)
    assert (td.cluster_abundance_test(tables[0], device="cpu") > 0.999).all()
    assert td.cluster_abundance_test(tables[1], device="cpu")[2] < 1e-5
    # from label vectors, levels unsorted in the input
    x = rng.choice([3, 1, 7, 5], size=400)
    batch = rng.choice(["b", "a", "c"], size=400)
    ours = td.cluster_abundance_test(x, batch, device="cpu")
    assert ours.shape == (4,)
    assert np.allclose(ours, jd.cluster_abundance_test(x, batch), atol=1e-12, rtol=0)
    x2, batch2 = np.repeat([0, 1], [40, 40]), np.tile([0, 1], 40)
    assert (td.cluster_abundance_test(x2, batch2, device="cpu") > 0.9).all()


def test_cluster_abundance_var_matches_jax(rng):
    tab = np.array([[100.0, 100], [100, 10]])
    ours = td.cluster_abundance_var(tab, device="cpu")
    assert np.allclose(ours, jd.cluster_abundance_var(tab), atol=1e-12, rtol=0)
    assert ours[1] > ours[0]
    x = rng.choice([2, 0, 1], size=300)
    batch = rng.choice([9, 4], size=300)
    for pc in (10.0, 1.0):
        assert np.allclose(td.cluster_abundance_var(x, batch, pseudo_count=pc, device="cpu"),
                           jd.cluster_abundance_var(x, batch, pseudo_count=pc),
                           atol=1e-12, rtol=0)
