"""The port's fused merge step and its merge_math helpers against the JAX
package's, on the CPU in fp64.

Each case runs the batchelor_tpu function and its batchelor_torch
counterpart on the same numpy inputs (made from the seeded ``rng``).
Tolerances: the helpers 1e-12, merge_step_body 1e-10, fused_merge_step 1e-8
against both JAX's fused step and the port's reduced_mnn (as
tests/test_fused.py holds JAX's), with identical pair sets; the masked
"chunked" search 1e-5 in its fp32 distances with identical indices.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from batchelor_torch import fused_merge_step as t_fused
from batchelor_torch import reduced_mnn as t_reduced_mnn
from batchelor_torch.ops import correction as t_corr
from batchelor_torch.ops import merge_math as t_mm
from batchelor_torch.ops.knn import query_knn as t_query_knn
from batchelor_tpu.correct.fused import fused_merge_step as j_fused
from batchelor_tpu.ops import correction as j_corr
from batchelor_tpu.ops import merge_math as j_mm
from batchelor_tpu.ops.knn import query_knn as j_query_knn

torch.set_num_threads(2)

T = torch.from_numpy


def _close(ours, theirs, atol):
    assert np.allclose(ours.numpy(), np.asarray(theirs), atol=atol, rtol=0)


def _pairs(rng, n1=40, n2=30, k2=6):
    l2r = np.stack([rng.permutation(n2)[:k2] for _ in range(n1)])
    mutual = rng.uniform(size=(n1, k2)) < 0.4
    return l2r, mutual


@pytest.mark.parametrize("lo,n_seg", [(0, 30), (7, 12)])
def test_pair_segment_sums_matches_jax(lo, n_seg, rng):
    l_rows = rng.normal(size=(40, 5))
    l2r, mutual = _pairs(rng)
    ours = t_corr.pair_segment_sums(T(l_rows), T(l2r), T(mutual), n_seg, lo=lo)
    theirs = j_corr.pair_segment_sums(jnp.asarray(l_rows), jnp.asarray(l2r),
                                      jnp.asarray(mutual), n_seg, lo=lo)
    for a, b in zip(ours, theirs):
        _close(a, b, 1e-12)
    # the window drops pairs outside it: counts add up to the pairs inside
    inside = mutual & (l2r >= lo) & (l2r < lo + n_seg)
    assert float(ours[1].sum()) == inside.sum()


def test_center_along_and_batch_vector_stats_match_jax(rng):
    shard = rng.normal(size=(50, 6))
    mask = rng.uniform(size=50) < 0.7
    v = rng.normal(size=6)
    v /= np.linalg.norm(v)
    ours = t_mm.center_along(T(shard), T(mask), T(v))
    theirs = j_mm.center_along(jnp.asarray(shard), jnp.asarray(mask), jnp.asarray(v))
    for a, b in zip(ours, theirs):
        _close(a, b, 1e-12)
    avg = rng.normal(size=(30, 6))
    involved = rng.uniform(size=30) < 0.5
    for inv in (involved, np.zeros(30, bool)):          # also no involved cell at all
        ours = t_mm.batch_vector_stats(T(avg), T(inv))
        theirs = j_mm.batch_vector_stats(jnp.asarray(avg), jnp.asarray(inv))
        for a, b in zip(ours, theirs):
            _close(a, b, 1e-12)


def test_replay_extras_skips_zero_rows(rng):
    shard = rng.normal(size=(50, 6))
    mask = rng.uniform(size=50) < 0.7
    extras = rng.normal(size=(4, 6))
    extras[1] = 0.0
    extras[3] = 0.0
    ours = t_mm.replay_extras(T(shard), T(mask), T(extras))
    _close(ours, j_mm.replay_extras(jnp.asarray(shard), jnp.asarray(mask),
                                    jnp.asarray(extras)), 1e-12)
    # zero rows are no-ops: the table without them gives the same shard
    _close(ours, t_mm.replay_extras(T(shard), T(mask), T(extras[[0, 2]])).numpy(), 1e-12)


def test_perbatch_var_matches_jax(rng):
    shard = rng.normal(size=(60, 5)) + rng.normal(size=(1, 5)) * 10
    origin = rng.integers(0, 4, 60)
    origin[origin == 3] = 2                    # batch 3 empty
    valid = np.ones(60, bool)
    valid[-7:] = False                         # pad rows
    ours = t_mm.perbatch_var(T(shard), T(origin), T(valid), 4)
    _close(ours, j_mm.perbatch_var(jnp.asarray(shard), jnp.asarray(origin),
                                   jnp.asarray(valid), 4), 1e-12)


def test_merge_step_body_with_var_matches_jax(rng):
    n1, n2, d = 70, 60, 8
    left = rng.normal(size=(n1, d))
    right = rng.normal(size=(n2, d)) + 1
    lvalid = np.ones(n1, bool)
    lvalid[-5:] = False                        # pads
    rvalid = np.ones(n2, bool)
    rvalid[-4:] = False
    lres = np.ones(n1, bool)
    lres[::7] = False                          # restriction
    rres = np.ones(n2, bool)
    lorigin = np.where(np.arange(n1) < 30, 0, 1)
    rorigin = np.full(n2, 2)
    lextras = rng.normal(size=(3, d))
    lextras[2] = 0.0
    rextras = rng.normal(size=(2, d))
    args = (left, right, lvalid, rvalid, lres, rres, lorigin, rorigin, lextras, rextras)
    kw = dict(k1=10, k2=12, tricube_k=9, ndist=3.0, min_batch_skip=0.0, nb=3, with_var=True)
    ours = t_mm.merge_step_body(*[T(a) for a in args], **kw)
    theirs = j_mm.merge_step_body(*[jnp.asarray(a) for a in args], **kw)
    assert len(ours) == len(theirs) == 9
    for i, (a, b) in enumerate(zip(ours, theirs)):
        if i in (5, 6):       # mutual mask and l2r
            assert np.array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b, 1e-10)


def _pair_set(mask, targets):
    rows, cols = np.nonzero(mask)
    return set(zip(rows.tolist(), targets[rows, cols].tolist()))


def test_fused_matches_jax_and_reduced_mnn(rng):
    b1 = rng.normal(size=(300, 20))
    b2 = rng.normal(size=(250, 20)) + 1
    ours = t_fused(b1, b2, 20, 20, device="cpu")
    theirs = j_fused(jnp.asarray(b1), jnp.asarray(b2), 20, 20)
    for name in ("left", "right", "overall", "batch_size"):
        _close(getattr(ours, name), getattr(theirs, name), 1e-8)
    assert int(ours.n_pairs) == int(theirs.n_pairs)
    assert np.array_equal(ours.pair_mask.numpy(), np.asarray(theirs.pair_mask))
    assert np.array_equal(ours.pair_targets.numpy(), np.asarray(theirs.pair_targets))
    # and the port's host engine on the same inputs
    ref = t_reduced_mnn([b1, b2], k=20, device="cpu")
    _close(torch.cat([ours.left, ours.right]), ref.corrected.numpy(), 1e-8)
    assert int(ours.n_pairs) == ref.merge_info[0].pairs.shape[0]
    assert abs(float(ours.batch_size) - ref.merge_info[0].batch_size) <= 1e-10
    theirs_pairs = {(l, r - 300) for l, r in map(tuple, ref.merge_info[0].pairs.tolist())}
    assert _pair_set(ours.pair_mask.numpy(), ours.pair_targets.numpy()) == theirs_pairs


def test_tricube_degenerate_fewer_involved_than_k(rng):
    """Fewer MNN-involved cells than the tricube k: the masked search plus
    tricube_weights (the fused step's form) equals the host engine, which
    shrinks k to the involved count (reference R/fastMNN.R:599-608)."""
    cur = rng.normal(size=(50, 8))
    involved = np.array([3, 10, 17, 25, 33, 44])       # 6 involved << k=20
    avg_compact = rng.normal(size=(6, 8))
    host = t_corr.tricube_weighted_correction(T(cur), T(avg_compact), involved, k=20)
    mask = np.zeros(50, dtype=bool)
    mask[involved] = True
    idx, dist = t_query_knn(T(cur), T(cur), 20, data_mask=T(mask), device="cpu")
    assert not bool(torch.isfinite(dist).all())        # truly degenerate
    j_idx, j_dist = j_query_knn(jnp.asarray(cur), jnp.asarray(cur), 20,
                                data_mask=jnp.asarray(mask))
    fin = np.isfinite(np.asarray(j_dist))
    assert np.array_equal(torch.isfinite(dist).numpy(), fin)
    assert np.array_equal(idx.numpy()[fin], np.asarray(j_idx)[fin])
    avg_full = torch.zeros(50, 8, dtype=torch.float64)
    avg_full[T(involved)] = T(avg_compact)
    w = t_corr.tricube_weights(dist)
    fusedlike = T(cur) + torch.einsum("nk,nkd->nd", w, avg_full[idx])
    _close(fusedlike, host.numpy(), 1e-10)
    assert bool(torch.isfinite(fusedlike).all())


def test_fused_skip_behaviour(rng):
    b1 = rng.normal(size=(200, 10))
    b2 = rng.normal(size=(200, 10))
    out = t_fused(b1, b2, 20, 20, min_batch_skip=0.5, device="cpu")
    assert float(out.batch_size) < 0.5
    assert np.allclose(out.left.numpy(), b1, atol=1e-12)
    assert np.allclose(out.right.numpy(), b2, atol=1e-12)
    theirs = j_fused(jnp.asarray(b1), jnp.asarray(b2), 20, 20, min_batch_skip=0.5)
    assert abs(float(out.batch_size) - float(theirs.batch_size)) <= 1e-12


@pytest.mark.parametrize("n_valid", [6, 90])
def test_chunked_masked_search_matches_jax(n_valid, rng):
    """The fused tricube search's regime: most data rows masked, and with
    6 valid rows fewer than k, so +inf distances fill the rest."""
    q = rng.normal(size=(70, 16)).astype(np.float32)
    x = rng.normal(size=(300, 16)).astype(np.float32)
    mask = np.zeros(300, bool)
    mask[rng.choice(300, n_valid, replace=False)] = True
    idx, dist = t_query_knn(T(q), T(x), 20, data_mask=T(mask), method="chunked", device="cpu")
    j_idx, j_dist = j_query_knn(jnp.asarray(q), jnp.asarray(x), 20,
                                data_mask=jnp.asarray(mask), method="chunked")
    fin = np.isfinite(np.asarray(j_dist))
    assert fin.sum() == 70 * min(20, n_valid)
    assert np.array_equal(torch.isfinite(dist).numpy(), fin)
    assert np.array_equal(idx.numpy()[fin], np.asarray(j_idx)[fin])
    assert mask[idx.numpy()[fin]].all()
    assert np.allclose(dist.numpy()[fin], np.asarray(j_dist)[fin], atol=1e-5, rtol=0)
