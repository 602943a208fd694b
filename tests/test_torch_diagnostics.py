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


def _stable_local_linear(x, y, span):
    """The host smoother with tied means in a stable order, the order the
    tensor fit sorts them in (numpy's default sort leaves ties in no set
    order)."""
    order = np.argsort(x, kind="stable")
    return td._sorted_local_linear(x[order], y[order], td._window(span, x.size))


def _trend_case(case):
    """(means, variances, kwargs, queries) of one branch of the trend fit:
    fp32 log-count moments with tied means (distinct variances among them),
    and queries inside, outside and beyond the data, non-finite ones too."""
    rng = np.random.default_rng(63)
    lam = np.exp(rng.normal(size=600))
    logs = np.log1p(rng.poisson(lam, size=(200, 600))).astype(np.float32)
    x, y = logs.mean(0).astype(np.float64), logs.var(0, ddof=1).astype(np.float64)
    kw = {"span": 0.5} if case == "span" else {"parametric": case != "not_parametric"}
    if case == "few_positive":
        x[3:] = -x[3:]
    elif case == "one_finite":
        x[1:] = np.nan
    elif case == "none_finite":
        y[:] = np.inf
    elif case == "non_finite_moments":
        x[::7], y[::11], y[::13] = np.nan, np.inf, 0.0
    q = np.concatenate([x, [0.0, -1.0, 1e-6, 200.0, np.nan, np.inf, -np.inf]])
    return x, y, kw, q


TREND_CASES = ["parametric", "not_parametric", "span", "few_positive", "one_finite", "none_finite",
               "non_finite_moments"]


@pytest.mark.parametrize("case", TREND_CASES)
def test_fit_trend_var_of_arrays_and_cpu_tensors_is_the_host_code(case):
    """Arrays and CPU tensors take the host numpy, bit for bit, as one host
    fit of the recorder's."""
    import batchelor_torch as bt

    x, y, kw, q = _trend_case(case)
    want = td.fit_trend_var(x, y, **kw)(q)
    rec = bt.MetricsRecorder()
    with rec.activate():
        got = td.fit_trend_var(torch.from_numpy(x), torch.from_numpy(y), **kw)(torch.from_numpy(q))
    assert isinstance(got, np.ndarray) and np.array_equal(got, want)
    assert rec.counters == {"trend/host_fits": 1.0}
    fit = rec.records[0]
    assert fit["name"] == "trend/fit" and fit["attrs"]["path"] == "host"
    assert fit["attrs"]["genes"] == x.size


@pytest.mark.parametrize("case", TREND_CASES)
def test_tensor_trend_fit_matches_the_host(case):
    """The card's steps (the grids as batched evaluations, the stable sort,
    the degenerate branches) on CPU tensors, with the plain smoother,
    against the host numpy with ties in the same stable order: within
    1e-12 of the host trend's largest value."""
    from unittest import mock

    x, y, kw, q = _trend_case(case)
    with mock.patch.object(td, "_local_linear", _stable_local_linear):
        want = td.fit_trend_var(x, y, **kw)(q)
    fit = td._fit_trend_tensors(torch.from_numpy(x), torch.from_numpy(y), kw.get("span", 0.3),
                                kw.get("parametric", True))
    got = fit(torch.from_numpy(q))
    assert got.dtype == torch.float64 and got.shape == q.shape
    got = got.numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-12 * max(np.abs(want).max(), 1e-300), case


@pytest.mark.parametrize("seed", range(4))
def test_first_strict_min_is_the_host_loop(seed):
    rng = np.random.default_rng(seed)
    v = rng.choice([0.5, 1.0, 2.0, np.inf, np.nan], size=(50, 9))
    v[0, 0] = np.nan                          # a NaN first stays
    v[1, :3] = np.inf                         # the first of equal infinities
    for row in v:
        best = None
        for i, s in enumerate(row):
            if best is None or s < row[best]:
                best = i
        assert int(td._first_strict_min(torch.from_numpy(row))) == best, row


@pytest.mark.parametrize("block", [None, "two"])
def test_model_gene_var_keeps_its_types_and_numbers(block, rng):
    """On the CPU: mean and total in the input's float32, tech and bio in
    float64, each bit for bit the host fit on the moments' arrays."""
    x = np.log1p(rng.poisson(np.exp(rng.normal(size=80)), size=(150, 80))).astype(np.float32)
    block = None if block is None else np.repeat([1, 0], 75)[rng.permutation(150)]
    got = ts.model_gene_var(x, block=block, device="cpu")
    parts = []
    for idx in ([np.arange(150)] if block is None else [np.nonzero(block == b)[0] for b in (0, 1)]):
        sub = torch.from_numpy(x[idx])
        mean = sub.mean(0).numpy()
        total = torch.var(sub, dim=0, correction=1).numpy()
        tech = td.fit_trend_var(mean, total)(mean)
        parts.append(ts.GeneVarResult(mean=mean, total=total, tech=tech, bio=total - tech))
    want = ts.combine_var(parts)
    for f, dtype in (("mean", np.float32), ("total", np.float32), ("tech", np.float64),
                     ("bio", np.float64)):
        assert getattr(got, f).dtype == dtype and np.array_equal(getattr(got, f), getattr(want, f)), f


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
