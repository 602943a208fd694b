"""Kernel K1 (chunk_max_scores): the port's plain version against the JAX kernel.

Both sides get the same padded operands with the norms folded in, as
``_pass1_operands`` builds them. The JAX side runs
batchelor_tpu.ops.knn_pallas.chunk_max_scores in interpret mode, as its own
tests do. The products are the same bf16-split products; only the order of
the fp32 sums differs, so each entry must agree within 2^-20 of the largest
|score| of its query column (sub-chunks of masked rows carry the 1e30
sentinel and are held to 2^-20 of their own magnitude).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from batchelor_torch.ops import knn_cuda
from batchelor_tpu.ops import knn_pallas

torch.set_num_threads(2)

TOL = 2.0 ** -20


def _within_bound(got: np.ndarray, want: np.ndarray) -> bool:
    sentinel = np.abs(want) > 1e29
    scale = np.where(sentinel, 0.0, np.abs(want)).max(axis=0, keepdims=True)
    diff = np.abs(got - want)
    ok_real = diff <= TOL * np.broadcast_to(scale, diff.shape)
    ok_sentinel = diff <= TOL * np.abs(want)
    return bool(np.where(sentinel, ok_sentinel, ok_real).all())


@pytest.mark.parametrize("mode", ["fp32", "six_pass", "bf16"])
@pytest.mark.parametrize("d0", [50, 100])
def test_chunk_max_plain_matches_jax_kernel(mode, d0, rng):
    nq, nd = 600, 2000
    query = rng.normal(size=(nq, d0)).astype(np.float32)
    data = (rng.normal(size=(nd, d0)) + 0.5).astype(np.float32)
    valid = np.ones(nd, bool)
    valid[700:800] = False
    q, x = knn_cuda._pass1_operands(
        torch.from_numpy(query), torch.from_numpy(data), torch.from_numpy(valid),
        bf16=mode == "bf16",
    )
    assert q.shape == (1024, 64 if d0 <= 62 else 128) and x.shape == (2048, q.shape[1])
    six = mode == "six_pass"
    got = knn_cuda.chunk_max_scores(q, x, six_pass=six).numpy()
    jq, jx = (jnp.asarray(t.float().numpy()) for t in (q, x))
    if mode == "bf16":
        jq, jx = jq.astype(jnp.bfloat16), jx.astype(jnp.bfloat16)
    want = np.asarray(knn_pallas.chunk_max_scores(jq, jx, interpret=True, six_pass=six))
    assert got.shape == want.shape == (2048 // 32, 1024)
    assert _within_bound(got, want)


@pytest.mark.parametrize("c32", [96, 8448])
def test_select_subchunks_same_ids_for_both_layouts(c32, rng):
    """On the card the bf16 kernel returns its (C32, nq) maxima as the .t()
    view of a query-major matrix, the fp32 modes a contiguous data-major one;
    the selection gives the same ids for both, in the flat regime (C32 = 96)
    and through the 128-chunk hierarchy (C32 = 8448)."""
    nq = 16
    m = rng.normal(size=(c32, nq)).astype(np.float32)
    m[7] = m[5]                                   # ties between sub-chunks
    m[40:44] = m[0:4]                             # and between whole chunks
    data_major = torch.from_numpy(m)
    query_major = torch.from_numpy(np.ascontiguousarray(m.T)).t()
    assert query_major.t().is_contiguous() and not query_major.is_contiguous()
    assert torch.equal(query_major, data_major)
    got = knn_cuda._select_subchunks(query_major, 20)
    want = knn_cuda._select_subchunks(data_major, 20)
    assert got.shape == (nq, 20) and torch.equal(got, want)


def test_pass1_operands_fold_norms(rng):
    """The folded columns carry (dn_hi, dn_lo) and (-0.5, -0.5), and masked or
    padding rows carry the finite sentinel 1e30."""
    data = rng.normal(size=(40, 7)).astype(np.float32)
    valid = np.ones(40, bool)
    valid[3] = False
    q, x = knn_cuda._pass1_operands(torch.zeros(5, 7), torch.from_numpy(data),
                                    torch.from_numpy(valid))
    dn = x[:, -2].double() + x[:, -1].double()
    want = np.square(data.astype(np.float64)).sum(1)
    assert np.allclose(dn[:40][valid].numpy(), want[valid], rtol=1e-6)
    assert float(dn[3]) == pytest.approx(1e30, rel=1e-6)
    assert torch.all(dn[40:] > 1e29)
    assert torch.all(q[:, -2:] == -0.5)
    assert torch.equal(x[:, -2], x[:, -2].to(torch.bfloat16).float())


def test_chunk_max_rejects_unpadded_input():
    with pytest.raises(ValueError):
        knn_cuda.chunk_max_scores(torch.zeros(100, 64), torch.zeros(1024, 64))
    with pytest.raises(TypeError):
        knn_cuda.chunk_max_scores(torch.zeros(128, 64), torch.zeros(128, 64, dtype=torch.float64))
