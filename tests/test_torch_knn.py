"""The port's query_knn against the JAX package's, on the CPU.

Mirrors tests/test_knn_backends.py and the kNN cases of tests/test_knn.py:
the same inputs go through batchelor_tpu.ops.knn.query_knn (its two-pass
paths run the Pallas kernels in interpret mode) and the port's query_knn
with device="cpu". Indices must be identical where the JAX test asserts
identity; distances agree to 1e-5 in fp32 and 1e-10 in fp64.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from batchelor_torch.ops.knn import query_knn as t_query_knn
from batchelor_tpu.ops.knn import query_knn as j_query_knn

torch.set_num_threads(2)


def _both(q, x, k, **kw):
    jr = j_query_knn(jnp.asarray(q), jnp.asarray(x), k, **kw)
    tr = t_query_knn(q, x, k, device="cpu", **kw)
    return (np.asarray(jr.indices), np.asarray(jr.distances),
            tr.indices.numpy(), tr.distances.numpy())


def _assert_identical(q, x, k, atol, **kw):
    ji, jd, ti, td = _both(q, x, k, **kw)
    assert np.array_equal(ji, ti)
    assert np.allclose(jd, td, atol=atol, rtol=0)


def _near_tie_ray(rng):
    """Data on a ray at radii 10 + i*1e-3, queries at radius 9: score gaps
    ~2e-3 against magnitudes ~100 (test_chunked_selection_precision)."""
    u = rng.normal(size=8)
    u /= np.linalg.norm(u)
    radii = 10.0 + 1e-3 * rng.permutation(1024)
    x = (radii[:, None] * u[None, :]).astype(np.float32)
    q = np.tile((9.0 * u).astype(np.float32), (16, 1))
    return q, x


def _case(name, rng):
    """(q, x, k, kwargs, atol) of one identity case."""
    if name == "exact_fp64":                      # test_query_knn_matches_oracle
        return rng.normal(size=(57, 8)), rng.normal(size=(203, 8)), 7, {}, 1e-10
    if name == "exact_crosses_tiles":             # test_query_knn_crosses_tiles
        return rng.normal(size=(11, 3)), rng.normal(size=(9000, 3)), 4, {}, 1e-10
    if name == "exact_fp32":
        return (rng.normal(size=(64, 12)).astype(np.float32),
                rng.normal(size=(700, 12)).astype(np.float32), 6, {}, 1e-5)
    if name == "chunked_small":                   # test_chunked_matches_exact_small
        return (rng.normal(size=(40, 10)), rng.normal(size=(300, 10)), 5,
                {"method": "chunked"}, 1e-5)
    if name == "chunked_hierarchical":            # test_chunked_hierarchical_exact
        return (rng.normal(size=(300, 24)), rng.normal(size=(4000, 24)), 20,
                {"method": "chunked"}, 1e-5)
    if name == "chunked_fewer_chunks_than_k":     # test_chunked_fewer_chunks_than_k
        return (rng.normal(size=(64, 8)), rng.normal(size=(1200, 8)), 20,
                {"method": "chunked"}, 1e-5)
    if name == "chunked_selection_precision":
        q, x = _near_tie_ray(rng)
        return q, x, 4, {"method": "chunked"}, 1e-5
    if name == "chunked_six_pass":
        q, x = _near_tie_ray(rng)
        return q, x, 4, {"method": "chunked", "exact_selection": True}, 1e-5
    if name == "auto_small":                      # test_auto_dispatch
        return rng.normal(size=(50, 6)), rng.normal(size=(300, 6)), 5, {"method": "auto"}, 1e-10
    if name == "squared":
        return (rng.normal(size=(30, 5)), rng.normal(size=(90, 5)), 3,
                {"squared": True}, 1e-10)
    raise KeyError(name)


CASES = ["exact_fp64", "exact_crosses_tiles", "exact_fp32", "chunked_small",
         "chunked_hierarchical", "chunked_fewer_chunks_than_k",
         "chunked_selection_precision", "chunked_six_pass", "auto_small", "squared"]


@pytest.mark.parametrize("name", CASES)
def test_query_knn_matches_jax(name, rng):
    q, x, k, kw, atol = _case(name, rng)
    _assert_identical(q, x, k, atol, **kw)


@pytest.mark.parametrize("method", ["exact", "chunked"])
def test_query_knn_mask_matches_jax(method, rng):
    # test_chunked_respects_mask / test_query_knn_masked
    q = rng.normal(size=(16, 6))
    x = rng.normal(size=(256, 6))
    mask = np.zeros(256, dtype=bool)
    mask[:150] = True
    _assert_identical(q, x, 4, 1e-5, data_mask=mask, method=method)
    ref = t_query_knn(q, x[:150], 4, device="cpu", method=method)
    out = t_query_knn(q, x, 4, n_data_valid=150, device="cpu", method=method)
    assert torch.equal(ref.indices, out.indices)


def test_query_knn_self_neighbour(rng):
    x = rng.normal(size=(40, 5))
    idx, dist = t_query_knn(x, x, 1, device="cpu")
    assert np.array_equal(idx.numpy()[:, 0], np.arange(40))
    # a self-distance is the square root of the fp64 cancellation residue of
    # |q|^2 + |x|^2 - 2 q.x (~1e-16 * |x|^2), so ~1e-8, not exactly 0
    assert np.allclose(dist.numpy(), 0.0, atol=1e-6)


def test_bf16_high_recall_matches_jax_selection(rng):
    """bf16 selection: the port and JAX return the same neighbours (identical
    bf16 products), near-perfect recall against the exact search, and exact
    fp32 distances where the selection agrees (test_bf16_high_recall)."""
    q = rng.normal(size=(64, 8)).astype(np.float32)
    x = rng.normal(size=(2048, 8)).astype(np.float32)
    ji, jd, ti, td = _both(q, x, 8, method="bf16")
    assert np.array_equal(ji, ti)
    assert np.allclose(jd, td, atol=1e-5)
    ref = t_query_knn(q, x, 8, device="cpu", method="exact")
    ri = ref.indices.numpy()
    recall = np.mean([len(set(a) & set(b)) / 8 for a, b in zip(ri.tolist(), ti.tolist())])
    assert recall > 0.9
    agree = ri == ti
    assert np.allclose(ref.distances.numpy()[agree], td[agree], atol=1e-5)


def test_approx_is_exact_alias(rng):
    q = rng.normal(size=(20, 5))
    x = rng.normal(size=(100, 5))
    a = t_query_knn(q, x, 4, method="approx", device="cpu")
    e = t_query_knn(q, x, 4, method="exact", device="cpu")
    assert torch.equal(a.indices, e.indices)
    with pytest.raises(ValueError):
        t_query_knn(q, x, 4, method="annoy", device="cpu")


def test_two_pass_query_pieces_match_single_piece(rng):
    """A small max_bytes splits the queries into pieces (and the rescore into
    tiles); the result equals the single-piece search."""
    q = rng.normal(size=(1200, 8)).astype(np.float32)
    x = rng.normal(size=(2600, 8)).astype(np.float32)
    ref = t_query_knn(q, x, 5, method="chunked", device="cpu")
    c32 = 3072 // 32
    out = t_query_knn(q, x, 5, method="chunked", device="cpu",
                      max_bytes=3 * 4 * c32 * 512)      # one QT-sized piece each
    assert torch.equal(ref.indices, out.indices)
    assert torch.equal(ref.distances, out.distances)
    only = t_query_knn(q, x, 5, method="chunked", device="cpu", indices_only=True)
    assert only.distances is None and torch.equal(only.indices, ref.indices)


@pytest.mark.parametrize("c32", [3136, 8448, 196608])
def test_select_subchunks_matches_jax_both_regimes(c32, rng):
    """Sub-chunk selection from the same pass-1 maxima: the flat regime
    (C32 <= 8192) and the 128-chunk -> sub-chunk hierarchy with -inf chunk
    padding (8448 sub-chunks = 2112 chunks, padded to 2176). The k-distinct
    argument makes the hierarchy's choice equal the flat top-k. 196608
    sub-chunks (6.3M data rows) give a chunk top-k over 49,152 columns, as
    wide as a search over that many rows makes it; a few queries keep it
    quick."""
    from batchelor_torch.ops import knn_cuda
    from batchelor_tpu.ops import knn_pallas

    nq = 8 if c32 > 10000 else 512
    # negative like real scores, so a padding chunk that is not -inf would win
    m_t = (-np.abs(rng.normal(size=(c32, nq))) - 1.0).astype(np.float32)
    want = np.asarray(knn_pallas._select_subchunks(jnp.asarray(m_t), 20, interpret=True)).T
    got = knn_cuda._select_subchunks(torch.from_numpy(m_t), 20).numpy()
    assert np.array_equal(want, got)
    flat = np.argsort(-m_t.T, axis=1, kind="stable")[:, :20]
    assert np.array_equal(np.sort(got, axis=1), np.sort(flat, axis=1))
