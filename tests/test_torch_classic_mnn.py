"""The port's classic mnnCorrect against the JAX package's, on the CPU in fp64.

Mirrors every case of tests/test_classic_mnn.py: each runs the
batchelor_tpu function and its batchelor_torch counterpart on the same
numpy inputs (made from the seeded ``rng``). Tolerances: the smoothing
kernel 1e-8 (1e-6 in the underflow regime), the variance adjustment 1e-6,
bio spans 1e-8 up to the sign of each column, and mnn_correct's corrected
values 1e-8 with identical pairs in every merge step; the out_on_host case
runs in fp32 and holds 1e-5, as the JAX test does.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from batchelor_torch import mnn_correct as t_mnn_correct
from batchelor_torch.ops import shift_variance as t_sv
from batchelor_torch.ops.gaussian_kernel import smooth_gaussian_kernel as t_smooth
from batchelor_torch.ops.svd import get_bio_span as t_span
from batchelor_torch.ops.svd import get_bio_span_pair as t_span_pair
from batchelor_torch.ops.svd import subtract_bio as t_subtract
from batchelor_tpu.correct.classic_mnn import mnn_correct as j_mnn_correct
from batchelor_tpu.ops import shift_variance as j_sv
from batchelor_tpu.ops.gaussian_kernel import smooth_gaussian_kernel as j_smooth
from batchelor_tpu.ops.svd import get_bio_span as j_span

torch.set_num_threads(2)

T = torch.from_numpy


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_result(jres, tres, atol=1e-8):
    assert np.allclose(np.asarray(jres.corrected), _np(tres.corrected), atol=atol, rtol=0)
    assert np.array_equal(np.asarray(jres.batch), np.asarray(tres.batch))
    assert len(jres.merge_info) == len(tres.merge_info)
    for a, b in zip(jres.merge_info, tres.merge_info):
        assert list(a.left) == list(b.left) and list(a.right) == list(b.right)
        assert np.array_equal(a.pairs, b.pairs)


@pytest.mark.parametrize("extreme", [False, True])
def test_smooth_gaussian_kernel_matches_jax(extreme, rng):
    if extreme:       # strong underflow regime: distances >> sigma
        data = rng.normal(size=(30, 5)) * 100
        index = np.arange(0, 30, 3)
        averaged = rng.normal(size=(10, 5))
    else:
        data = rng.normal(size=(60, 12))
        index = np.sort(rng.choice(60, size=15, replace=False))
        averaged = rng.normal(size=(15, 12))
    ours = t_smooth(T(averaged), index, T(data), 0.1).numpy()
    theirs = np.asarray(j_smooth(jnp.asarray(averaged), index, jnp.asarray(data), 0.1))
    tol = 1e-6 if extreme else 1e-8
    assert np.isfinite(ours).all()
    assert np.allclose(ours, theirs, atol=tol, rtol=0)
    assert np.allclose(ours, oracle.smooth_gaussian_kernel(averaged, index, data, 0.1),
                       atol=tol, rtol=0)


@pytest.mark.parametrize("restricted", [False, True])
def test_adjust_shift_variance_matches_jax(restricted, rng):
    if restricted:
        d1, d2 = rng.normal(size=(30, 6)), rng.normal(size=(25, 6)) + 0.5
        corr, sigma = rng.normal(size=(25, 6)), 0.5
        kw = {"restrict1": np.arange(0, 30, 2), "restrict2": np.arange(0, 25, 3)}
    else:
        d1, d2 = rng.normal(size=(40, 8)), rng.normal(size=(35, 8)) + 1
        corr, sigma, kw = rng.normal(size=(35, 8)), 0.1, {}
    theirs = np.asarray(j_sv.adjust_shift_variance(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(corr), sigma, **kw))
    # block_rows=7 puts the query cells in several blocks, one of them short
    for rows in (None, 7):
        ours = t_sv.adjust_shift_variance(T(d1), T(d2), T(corr), sigma, block_rows=rows,
                                          **kw).numpy()
        assert np.allclose(ours, theirs, atol=1e-6, rtol=0)
    expected = np.maximum(oracle.adjust_shift_variance(d1, d2, corr, sigma, **kw), 1.0)
    assert np.allclose(ours, expected[:, None] * corr, atol=1e-6, rtol=0)


def _columns_up_to_sign(a, b, atol):
    for j in range(b.shape[1]):
        assert np.allclose(a[:, j], b[:, j], atol=atol) or np.allclose(a[:, j], -b[:, j], atol=atol)


@pytest.mark.parametrize("shape", [(25, 40), (45, 20)])
def test_bio_span_matches_svd_and_jax(shape, rng):
    x = rng.normal(size=shape)
    span = t_span(T(x), 3).numpy()
    _, _, vt = np.linalg.svd(x - x.mean(axis=0), full_matrices=False)
    _columns_up_to_sign(span, vt[:3].T, 1e-8)
    _columns_up_to_sign(span, np.asarray(j_span(jnp.asarray(x), 3)), 1e-8)


def test_bio_span_subset_row_matches_jax(rng):
    x1, x2 = rng.normal(size=(30, 24)), rng.normal(size=(18, 24))
    sub = np.arange(0, 24, 3)
    p1, p2 = t_span_pair(T(x1), T(x2), 2, subset_row=sub)
    for x, p in ((x1, p1), (x2, p2)):
        theirs = np.asarray(j_span(jnp.asarray(x), 2, subset_row=sub))
        _columns_up_to_sign(p.numpy(), theirs, 1e-8)
    corr = rng.normal(size=(7, 24))
    ours = t_subtract(T(corr), p1, p2, subset_row=sub).numpy()
    from batchelor_tpu.ops.svd import subtract_bio as j_subtract
    j1 = j_span(jnp.asarray(x1), 2, subset_row=sub)
    j2 = j_span(jnp.asarray(x2), 2, subset_row=sub)
    # projecting out a column is the same for either of its signs
    theirs = np.asarray(j_subtract(jnp.asarray(corr), j1, j2, subset_row=sub))
    assert np.allclose(ours, theirs, atol=1e-10, rtol=0)


def test_subtract_bio_removes_components(rng):
    x = rng.normal(size=(30, 20))
    span = t_span(T(x), 4)
    corr = rng.normal(size=(10, 20))
    out = t_subtract(T(corr), span, span).numpy()
    assert np.allclose(out @ span.numpy(), 0.0, atol=1e-8)
    theirs = j_span(jnp.asarray(x), 4)
    from batchelor_tpu.ops.svd import subtract_bio as j_subtract
    assert np.allclose(out, np.asarray(j_subtract(jnp.asarray(corr), theirs, theirs)),
                       atol=1e-10, rtol=0)


def _two(rng):
    # one shape pair for every two-batch case keeps the JAX side's
    # compilations few
    return [rng.normal(size=(60, 40)), rng.normal(size=(50, 40)) + 1]


def _classic_case(name, rng):
    """(inputs, kwargs) of one mnn_correct case, mirroring
    tests/test_classic_mnn.py."""
    if name == "basic":
        return _two(rng), {}
    if name == "subset_row":
        return _two(rng), {"subset_row": np.arange(0, 40, 2)}
    if name == "correct_all":
        return _two(rng), {"subset_row": np.arange(0, 40, 2), "correct_all": True, "svd_dim": 2}
    if name == "no_cos_norm":
        return _two(rng), {"cos_norm_in": False, "cos_norm_out": False, "var_adj": False}
    if name == "cos_norm_in_only":
        # var_adj off: on unnormalized out-values at sigma = 0.1 the kernel
        # weights underflow to one-hot rows, and a cell at the top of its
        # batch crosses exactly at the total weight, where the two packages
        # round the total differently (the port takes the cumsum's own)
        return _two(rng), {"cos_norm_out": False, "var_adj": False}
    if name == "restrict_prop_k":
        return _two(rng), {"restrict": [np.arange(40), np.arange(10, 50)], "prop_k": 0.3,
                           "k": 5}
    three = [rng.normal(size=(40, 40)) + s for s in (0.0, 1.0, 2.0)]
    if name == "merge_order":
        return three, {"merge_order": [2, 1, 0]}
    if name == "auto_merge":
        return three, {"auto_merge": True, "batch_names": ["a", "b", "c"]}
    raise KeyError(name)


# svd_dim runs in the correct_all and single-input cases
@pytest.mark.parametrize("name", ["basic", "subset_row", "correct_all",
                                  "no_cos_norm", "cos_norm_in_only", "merge_order",
                                  "auto_merge", "restrict_prop_k"])
def test_mnn_correct_matches_jax(name, rng):
    inputs, kw = _classic_case(name, rng)
    jres = j_mnn_correct([jnp.asarray(b) for b in inputs], **kw)
    tres = t_mnn_correct(inputs, device="cpu", **kw)
    _same_result(jres, tres)
    if name == "basic":       # the first batch is the untouched reference
        assert np.allclose(tres.corrected[:60].numpy(), oracle.cosine_norm(inputs[0]),
                           atol=1e-10)
    if name == "correct_all":
        assert tres.corrected.shape[1] == 40


def _one_minus_prob2(data2, corr, sigma2):
    """1 - prob2 of each cell of the corrected batch in the variance
    adjustment (the weighted share of its batch that projects strictly above
    it along its correction vector), in fp64 as a sum over those cells, so
    it is not lost to the cancellation in 1 - prob2."""
    g = corr / np.sqrt((corr * corr).sum(1))[:, None]
    proj = g @ data2.T
    own = np.diag(proj)
    gram = data2 @ data2.T
    sq = np.diag(gram)
    dist2 = sq[:, None] + sq[None, :] - 2 * gram - (own[:, None] - proj) ** 2
    lp = -np.maximum(dist2, 0.0) / sigma2
    np.fill_diagonal(lp, 0.0)
    w = np.exp(lp - lp.max(1, keepdims=True))
    above = proj > own[:, None]
    np.fill_diagonal(above, False)
    return (w * above).sum(1) / w.sum(1)


@pytest.mark.parametrize("seed", range(12))
def test_mnn_correct_unnormalized_output_variance_adjustment(seed):
    """``cos_norm_out=False`` with ``var_adj`` at the default sigma = 0.1:
    the variance adjustment runs on raw output values, where the kernel
    weights underflow to one-hot rows. A cell whose 1 - prob2 is below fp64
    resolution has prob2 = 1 in fp64 and crosses at its batch's total
    weight, which the two packages sum in other orders; such cells are
    counted, and each corrected row there must still be its input plus its
    correction vector scaled by at least 1. Every other row, the first
    batch's and any resolved cell's, agrees within 1e-8."""
    from batchelor_torch.correct.classic_mnn import _compute_correction_vectors
    from batchelor_torch.ops.cosine_norm import cosine_norm

    rng = np.random.default_rng(seed)
    a1 = rng.normal(5, 1, size=(60, 30))
    a2 = rng.normal(7, 1, size=(70, 30))
    jres = j_mnn_correct([jnp.asarray(a1), jnp.asarray(a2)], cos_norm_out=False)
    tres = t_mnn_correct([a1, a2], cos_norm_out=False, device="cpu")
    pairs = tres.merge_info[0].pairs
    assert np.array_equal(pairs, jres.merge_info[0].pairs)
    # the out-space correction both packages scale (distances in cosine space)
    corr = _compute_correction_vectors(T(a1), T(a2), pairs[:, 0], pairs[:, 1] - 60,
                                       cosine_norm(T(a2)), 0.1).numpy()
    unresolved = _one_minus_prob2(a2, corr, 0.1) <= np.finfo(np.float64).eps
    j, t = np.asarray(jres.corrected), tres.corrected.numpy()
    held = np.concatenate([np.ones(60, bool), ~unresolved])
    assert np.allclose(t[held], j[held], atol=1e-8, rtol=0)
    differ = np.abs(t[60:] - j[60:]).max(1) > 1e-8
    assert not (differ & ~unresolved).any()
    for res in (t, j):
        delta = res[60:][differ] - a2[differ]
        c = corr[differ]
        scale = (delta * c).sum(1) / (c * c).sum(1)
        assert (scale >= 1 - 1e-12).all()
        assert np.allclose(delta, scale[:, None] * c, atol=1e-8, rtol=0)
    print(f"seed {seed}: {int(unresolved.sum())} of 70 cells below fp64 resolution, "
          f"{int(differ.sum())} of them differ")


def test_mnn_correct_single_vs_multi(rng):
    b1 = rng.normal(size=(50, 30))
    b2 = rng.normal(size=(70, 30)) + 1
    ref = t_mnn_correct([b1, b2], svd_dim=2, device="cpu")
    combined = np.concatenate([b1, b2])
    batch = np.repeat([0, 1], [50, 70])
    shuffle = rng.permutation(120)
    out = t_mnn_correct(combined[shuffle], batch=batch[shuffle], svd_dim=2, device="cpu",
                        cell_names=[f"c{i}" for i in range(120)])
    theirs = j_mnn_correct(jnp.asarray(combined[shuffle]), batch=batch[shuffle], svd_dim=2)
    assert np.allclose(out.corrected.numpy(), ref.corrected.numpy()[shuffle], atol=1e-8)
    _same_result(theirs, out)
    assert list(out.cell_names[:2]) == ["c0", "c1"]


def test_mnn_correct_out_on_host_matches_device(rng):
    b1 = rng.normal(size=(60, 40)).astype(np.float32)
    b2 = (rng.normal(size=(50, 40)) + 1).astype(np.float32)
    sub = np.arange(0, 40, 2)
    kw = dict(subset_row=sub, correct_all=True, svd_dim=2, var_adj=True)
    dev = t_mnn_correct([b1, b2], device="cpu", **kw)
    host = t_mnn_correct([b1, b2], device="cpu", out_on_host=True, **kw)
    theirs = j_mnn_correct([b1, b2], out_on_host=True, **kw)
    assert isinstance(host.corrected, np.ndarray)
    np.testing.assert_allclose(host.corrected, dev.corrected.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(host.corrected, theirs.corrected, atol=1e-5, rtol=1e-5)
    for a, b, c in zip(host.merge_info, dev.merge_info, theirs.merge_info):
        assert np.array_equal(a.pairs, b.pairs) and np.array_equal(a.pairs, c.pairs)
    with pytest.raises(ValueError, match="out_on_host"):
        t_mnn_correct([b1, b2], out_on_host=True, device="cpu")
    # a subset that is every gene leaves in == out: nothing stays on the host
    full = t_mnn_correct([b1, b2], subset_row=np.arange(40), correct_all=True,
                         out_on_host=True, device="cpu")
    assert torch.equal(full.corrected, t_mnn_correct([b1, b2], device="cpu").corrected)


def test_radix_quantile_matches_jax_and_sorted_cumsum(rng):
    C, N = 16, 3000
    proj = rng.normal(size=(C, N)).astype(np.float32)
    valid = rng.uniform(size=(C, N)) < 0.9
    w = np.where(valid, rng.uniform(0, 1, size=(C, N)).astype(np.float32), 0.0)
    w = w.astype(np.float32)
    frac = rng.uniform(0.05, 0.95, size=C).astype(np.float32)
    target = frac * w.sum(axis=1, dtype=np.float32)
    q = t_sv._ref_quantile_radix(T(proj), T(w), T(valid), T(target)).numpy()
    for c in range(C):
        key = np.where(valid[c], proj[c], np.inf)
        order = np.argsort(key, kind="stable")
        cum = np.cumsum(w[c][order])
        pos = np.searchsorted(cum, float(target[c]) - 1e-12)
        expected = key[order][min(pos, N - 1)]
        span = proj[c][valid[c]].max() - proj[c][valid[c]].min()
        assert abs(q[c] - expected) <= span * 2 ** -20, (c, q[c], expected)
    theirs = np.asarray(j_sv._ref_quantile_radix(
        jnp.asarray(proj), jnp.asarray(w), jnp.asarray(valid), jnp.asarray(target)))
    span = np.where(valid, proj, -np.inf).max(1) - np.where(valid, proj, np.inf).min(1)
    assert (np.abs(q - theirs) <= span * 2 ** -20).all()

    # exact ties: duplicated values return the tied value exactly
    vals = np.repeat(rng.normal(size=50), 60).astype(np.float32)[None, :]
    tt = torch.tensor([100.0, 1500.0, 2999.0, 3000.0])
    qt = t_sv._ref_quantile_radix(T(np.tile(vals, (4, 1))), torch.ones(4, 3000),
                                  torch.ones(4, 3000, dtype=torch.bool), tt).numpy()
    svals = np.sort(vals[0])
    for i, t in enumerate([100, 1500, 2999, 3000]):
        assert qt[i] == svals[t - 1]

    # no crossing -> max valid projection
    qn = t_sv._ref_quantile_radix(T(proj), T(w), T(valid), T(w.sum(1) * 2.0)).numpy()
    assert np.allclose(qn, np.max(np.where(valid, proj, -np.inf), axis=1))


def test_adjust_shift_variance_radix_large_n1_matches_jax(rng):
    # the JAX test holds these against the O(N^2) oracle; here the port is
    # held against the JAX function at the same tolerances
    n1 = 16500
    d1 = rng.normal(size=(n1, 8))
    d2 = rng.normal(size=(48, 8)) + 0.5
    corr = rng.normal(size=(48, 8))
    for method, tol in (("radix", 1e-5), ("sort", 1e-6)):
        ours = t_sv.adjust_shift_variance(T(d1), T(d2), T(corr), 0.5,
                                          quantile_method=method).numpy()
        theirs = np.asarray(j_sv.adjust_shift_variance(
            jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(corr), 0.5, quantile_method=method))
        np.testing.assert_allclose(ours, theirs, atol=tol, rtol=tol)


def test_adjust_shift_variance_radix_path_matches_sort(rng):
    d1 = rng.normal(size=(500, 10))
    d2 = rng.normal(size=(400, 10)) + 0.5
    corr = rng.normal(size=(400, 10))
    ref = t_sv.adjust_shift_variance(T(d1), T(d2), T(corr), 0.5).numpy()
    out = t_sv.adjust_shift_variance(T(d1), T(d2), T(corr), 0.5,
                                     quantile_method="radix").numpy()
    np.testing.assert_allclose(out, ref, atol=1e-10, rtol=1e-10)
    theirs = np.asarray(j_sv.adjust_shift_variance(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(corr), 0.5, quantile_method="radix"))
    np.testing.assert_allclose(out, theirs, atol=1e-10, rtol=1e-10)
    with pytest.raises(ValueError, match="quantile_method"):
        t_sv.adjust_shift_variance(T(d1), T(d2), T(corr), 0.5, quantile_method="bogus")
