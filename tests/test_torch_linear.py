"""The port's residual operator, normalization and linear engines against the
JAX package's, on the CPU in fp64.

Covers every case of tests/test_linear.py and tests/test_normalization.py:
each runs the batchelor_tpu function and its batchelor_torch counterpart on
the same numpy inputs (made from the seeded ``rng``). Tolerances: 1e-10
absolute on corrected values, residuals, size factors and log-counts (the
same fp64 arithmetic in another order), and 1e-8 on the PCs of
``regress_batches(d=...)`` after aligning the sign of each column. The
pseudo-inverse is held against ``jnp.linalg.pinv`` on a rank-deficient
design, where ``torch.linalg.pinv``'s own default cut-off would keep a
direction that JAX drops.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from batchelor_torch import convert
from batchelor_torch.correct import linear as tl
from batchelor_torch.ops import normalization as tn
from batchelor_torch.ops import residual as tr
from batchelor_tpu.correct import linear as jl
from batchelor_tpu.ops import normalization as jn
from batchelor_tpu.ops import residual as jr

torch.set_num_threads(2)

TOL = 1e-10
T = torch.from_numpy


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_linear(j, t, tol=TOL):
    t = convert.result_to_numpy(t)
    assert np.allclose(np.asarray(j.corrected), t.corrected, atol=tol, rtol=0)
    assert np.array_equal(np.asarray(j.batch), t.batch)
    for f in ("cell_names", "gene_names"):
        a, b = getattr(j, f), getattr(t, f)
        assert (a is None and b is None) or list(a) == list(b)


def _counts(rng, n, g, scale=1.0):
    return rng.poisson(lam=scale * rng.gamma(2.0, 1.0, size=(1, g)), size=(n, g)).astype(
        np.float64
    )


# ------------------------------------------------------------------ linear


def test_rescale_batches_matches_jax(rng):
    b1 = np.log2(rng.poisson(5.0, size=(40, 30)) + 1.0)
    b2 = np.log2(rng.poisson(10.0, size=(50, 30)) + 1.0)
    b2[:, 3] = 0.0                               # a gene absent from batch 2: scale 0/0
    _same_linear(jl.rescale_batches([jnp.asarray(b1), jnp.asarray(b2)]),
                 tl.rescale_batches([b1, b2], device="cpu"))
    restrict = [np.arange(0, 40, 2), None]
    kw = dict(restrict=restrict, subset_row=np.arange(5, 25), log_base=10.0,
              pseudo_count=0.5, batch_names=["x", "y"])
    _same_linear(jl.rescale_batches([jnp.asarray(b1), jnp.asarray(b2)], **kw),
                 tl.rescale_batches([b1, b2], device="cpu", **kw))


def test_rescale_batches_single_matches_jax(rng):
    b1 = np.abs(rng.normal(size=(30, 20)))
    b2 = np.abs(rng.normal(size=(35, 20)))
    combined = np.concatenate([b1, b2])
    batch = np.repeat([0, 1], [30, 35])
    shuffle = rng.permutation(65)
    j = jl.rescale_batches(combined[shuffle], batch=batch[shuffle])
    t = tl.rescale_batches(combined[shuffle], batch=batch[shuffle], device="cpu")
    _same_linear(j, t)
    ref = tl.rescale_batches([b1, b2], device="cpu")
    assert np.allclose(_np(t.corrected), _np(ref.corrected)[shuffle], atol=TOL)


@pytest.mark.parametrize("case", ["plain", "restrict", "keep", "subset", "subset_all"])
def test_regress_batches_matches_jax(case, rng):
    b1 = rng.normal(size=(40, 25)) + 5
    b2 = rng.normal(size=(60, 25)) - 3
    kw = {"plain": {}, "restrict": {"restrict": [np.arange(20), np.arange(20, 60)]},
          "keep": {"keep": [0]},
          "subset": {"subset_row": np.arange(0, 25, 2), "gene_names": [f"g{i}" for i in range(25)]},
          "subset_all": {"subset_row": np.arange(0, 25, 2), "correct_all": True}}[case]
    j = jl.regress_batches([jnp.asarray(b1), jnp.asarray(b2)], **kw)
    t = tl.regress_batches([b1, b2], device="cpu", **kw)
    _same_linear(j, t)
    if case == "plain":      # one-way design: residuals are batch-mean-centred values
        out = _np(t.corrected)
        assert np.allclose(out[:40], b1 - b1.mean(0), atol=1e-8)
        assert np.allclose(out[40:], b2 - b2.mean(0), atol=1e-8)
    if case == "keep":       # batch 0's coefficient is kept: its cells unchanged
        assert np.allclose(_np(t.corrected)[:40], b1, atol=1e-8)


def test_regress_batches_custom_design_and_pca_matches_jax(rng):
    b = rng.normal(size=(50, 12))
    batch = np.repeat([0, 1], 25)[rng.permutation(50)]
    design = np.asarray(jr.one_hot_design(batch))
    assert np.array_equal(tr.one_hot_design(batch).numpy(), design)
    j = jl.regress_batches(b, batch=batch, design=jnp.asarray(design), d=4)
    t = tl.regress_batches(b, batch=batch, design=design, d=4, device="cpu")
    _same_linear(j, t)
    jp, tp = np.asarray(j.corrected_pcs), _np(t.corrected_pcs)
    assert tp.shape == (50, 4)
    sign = np.sign(np.sum(jp * tp, axis=0))
    assert np.allclose(tp * sign, jp, atol=1e-8, rtol=0)


def test_residual_op_lazy_matmul_matches_jax(rng):
    x = rng.normal(size=(40, 15))
    batch = np.repeat([0, 1], 20)
    jop = jr.ResidualOp.fit(jnp.asarray(x), jr.one_hot_design(batch), keep=[1],
                            restrict=np.arange(0, 40, 3))
    top = tr.ResidualOp.fit(T(x), tr.one_hot_design(batch), keep=[1],
                            restrict=np.arange(0, 40, 3))
    assert np.array_equal(jop.drop, top.drop)
    assert np.allclose(np.asarray(jop.beta), top.beta.numpy(), atol=TOL)
    dense = top.materialize().numpy()
    assert np.allclose(np.asarray(jop.materialize()), dense, atol=TOL)
    v = rng.normal(size=(15, 3))
    assert np.allclose(top.matmul(v).numpy(), dense @ v, atol=1e-8)
    assert np.allclose(top.matmul(v).numpy(), np.asarray(jop.matmul(jnp.asarray(v))), atol=TOL)
    u = rng.normal(size=(5, 40))
    assert np.allclose(top.rmatmul(u).numpy(), u @ dense, atol=1e-8)
    assert np.allclose(top.rmatmul(u).numpy(), np.asarray(jop.rmatmul(jnp.asarray(u))), atol=TOL)


def test_pinv_cutoff_matches_jax_on_a_rank_deficient_design(rng):
    # singular values 1, 0.5 and 3 max(M, N) eps: above torch.linalg.pinv's
    # default cut-off (max(M, N) eps), at or below JAX's (10 max(M, N) eps)
    u, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    v, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    a = u @ np.diag([1.0, 0.5, 3 * 3 * np.finfo(np.float64).eps]) @ v.T
    want = np.asarray(jnp.linalg.pinv(jnp.asarray(a)))
    assert np.allclose(tr.pinv(T(a)).numpy(), want, atol=1e-12, rtol=0)
    assert not np.allclose(torch.linalg.pinv(T(a)).numpy(), want, atol=1e-6)
    # a design with an intercept and a collinear one-hot: D'D is singular
    batch = np.repeat([0, 1, 2], [10, 12, 8])
    design = np.concatenate([np.ones((30, 1)), np.asarray(jr.one_hot_design(batch))], 1)
    x = rng.normal(size=(30, 6)) + batch[:, None]
    j = jl.regress_batches(x, batch=batch, design=jnp.asarray(design))
    t = tl.regress_batches(x, batch=batch, design=design, device="cpu")
    _same_linear(j, t)
    assert np.allclose(np.asarray(j.residual_op.beta), t.residual_op.beta.numpy(), atol=TOL)


def test_no_correct_matches_jax(rng):
    b1 = rng.normal(size=(10, 5))
    b2 = rng.normal(size=(12, 5))
    kw = dict(batch_names=["a", "b"], cell_names=[[f"a{i}" for i in range(10)], None],
              gene_names=[f"g{i}" for i in range(5)], subset_row=[4, 0, 2])
    j = jl.no_correct([jnp.asarray(b1), jnp.asarray(b2)], **kw)
    t = tl.no_correct([b1, b2], device="cpu", **kw)
    _same_linear(j, t)
    assert list(t.batch) == ["a"] * 10 + ["b"] * 12
    x, batch = np.concatenate([b1, b2]), np.tile([1, 0], 11)
    _same_linear(jl.no_correct(x, batch), tl.no_correct(x, batch, device="cpu"))


# ----------------------------------------------------------- normalization


def test_scuttle_primitives_match_jax(rng):
    x = _counts(rng, 30, 50)
    sf = np.linspace(0.5, 2.0, 30)
    sub = np.arange(0, 50, 3)
    for s in (None, sub):
        assert np.allclose(tn.library_size_factors(T(x), s).numpy(),
                           np.asarray(jn.library_size_factors(jnp.asarray(x), s)), atol=TOL)
        assert np.allclose(tn.calculate_average(T(x), T(sf), s).numpy(),
                           np.asarray(jn.calculate_average(jnp.asarray(x), jnp.asarray(sf), s)),
                           atol=TOL)
    for center, base in ((False, 2.0), (True, 10.0)):
        kw = dict(pseudo_count=0.5, log_base=base, center=center)
        assert np.allclose(tn.log_norm_counts(T(x), T(sf), **kw).numpy(),
                           np.asarray(jn.log_norm_counts(jnp.asarray(x), jnp.asarray(sf), **kw)),
                           atol=TOL)
    small = np.array([[4.0, 8.0], [2.0, 2.0]])
    assert np.allclose(tn.log_norm_counts(T(small), T(np.array([2.0, 1.0]))).numpy(),
                       np.log2(np.array([[2.0, 4.0], [2.0, 2.0]]) + 1))


def _same_norm(j, t):
    if isinstance(j.logcounts, (list, tuple)):
        assert len(j.logcounts) == len(t.logcounts)
        pairs = list(zip(j.logcounts, t.logcounts)) + list(zip(j.size_factors, t.size_factors))
    else:
        pairs = [(j.logcounts, t.logcounts), (j.size_factors, t.size_factors)]
    for a, b in pairs:
        assert np.allclose(np.asarray(a), _np(b), atol=TOL, rtol=0)


def test_exact_scaling_recovery_matches_jax(rng):
    x = _counts(rng, 50, 100, scale=5.0) + 1.0
    mats = [x, 2 * x, 3 * x]
    j = jn.multi_batch_norm([jnp.asarray(m) for m in mats], min_mean=0.0)
    t = tn.multi_batch_norm(mats, min_mean=0.0, device="cpu")
    _same_norm(j, t)
    assert np.allclose(_np(t.logcounts[0]), _np(t.logcounts[2]), atol=1e-8)
    assert np.allclose(_np(t.size_factors[1]), 2 * _np(t.size_factors[0]), rtol=1e-8)


def test_rescale_order_invariance_matches_jax(rng):
    a = [_counts(rng, 30, 80, 2.0), _counts(rng, 40, 80, 5.0), _counts(rng, 20, 80, 1.0)]
    for order in ([0, 1, 2], [2, 1, 0]):
        mats = [a[i] for i in order]
        kw = dict(min_mean=0.5, subset_row=np.arange(60), normalize_all=order[0] == 2)
        _same_norm(jn.multi_batch_norm([jnp.asarray(m) for m in mats], **kw),
                   tn.multi_batch_norm(mats, device="cpu", **kw))
    sfs = [np.linspace(0.5, 1.5, m.shape[0]) for m in a]
    _same_norm(jn.multi_batch_norm([jnp.asarray(m) for m in a], size_factors=sfs),
               tn.multi_batch_norm(a, size_factors=sfs, device="cpu"))


def test_min_mean_filter_matches_jax(rng):
    x = _counts(rng, 30, 60, 5.0) + 1.0
    y = 2 * x
    tiny = rng.uniform(0, 0.01, size=(30, 10))
    xa, ya = np.concatenate([x, tiny], 1), np.concatenate([y, tiny * 5], 1)
    for u, v in ((x, y), (xa, ya)):
        avgs = [u.mean(0), v.mean(0)]
        j = jn.rescale_size_factors([jnp.asarray(a) for a in avgs],
                                    [jnp.ones(30), jnp.ones(30)], min_mean=1.0)
        host = tn.rescale_size_factors(avgs, [np.ones(30), np.ones(30)], min_mean=1.0)
        dev = tn.rescale_size_factors([T(a) for a in avgs],
                                      [torch.ones(30, dtype=torch.float64)] * 2, min_mean=1.0)
        for a, b, c in zip(j, host, dev):
            assert isinstance(b, np.ndarray) and isinstance(c, torch.Tensor)
            assert np.allclose(np.asarray(a), b, rtol=1e-12) and np.allclose(b, c.numpy(), rtol=0)
    with pytest.raises(ValueError, match="not finite"):
        tn.rescale_size_factors([np.zeros(5), np.ones(5)], [np.ones(3)] * 2, min_mean=0.0)


def test_single_input_matches_jax(rng):
    x1 = _counts(rng, 40, 80, scale=5.0) + 1.0
    x2 = x1 * rng.uniform(1.5, 2.5, size=(1, 80))
    x3 = x1 * rng.uniform(2.5, 3.5, size=(1, 80))
    combined = np.concatenate([x1, x2, x3], axis=0)
    perm = rng.permutation(120)
    batch = np.repeat([3, 1, 2], 40)[perm]
    shuffled = combined[perm]
    for kw in ({"preserve_single": False}, {}, {"subset_row": np.arange(20)},
               {"size_factors": np.linspace(0.8, 1.2, 120)}):
        j = jn.multi_batch_norm(jnp.asarray(shuffled), batch=batch, **kw)
        t = tn.multi_batch_norm(shuffled, batch=batch, device="cpu", **kw)
        _same_norm(j, t)
    # fragments follow the sorted levels and equal the list call
    frags = tn.multi_batch_norm(combined, batch=np.repeat([3, 2, 1], 40),
                                preserve_single=False, device="cpu")
    lists = tn.multi_batch_norm([x1, x2, x3], device="cpu")
    for a, b in zip(frags.logcounts, lists.logcounts[::-1]):
        assert np.allclose(_np(a), _np(b), atol=1e-12)
    with pytest.raises(ValueError, match="batch"):
        tn.multi_batch_norm(x1, device="cpu")
    with pytest.raises(ValueError, match="one entry per cell"):
        tn.multi_batch_norm(shuffled, batch=batch, size_factors=np.ones(3), device="cpu")
