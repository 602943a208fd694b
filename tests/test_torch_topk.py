"""Kernel K2 (topk_rows): the port's plain version against the JAX kernel.

The JAX side runs batchelor_tpu.ops.topk_pallas.topk_rows in interpret mode,
as its own tests do; values and indices must be identical. The CUDA kernel
itself is held against the same plain version on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax import lax

from batchelor_torch.ops import topk_cuda
from batchelor_torch.ops.topk_cuda import select_topk, topk_rows, topk_rows_plain
from batchelor_tpu.ops.topk_pallas import topk_rows as j_topk_rows

torch.set_num_threads(2)


def _case(name, rng):
    if name == "random":
        return rng.normal(size=(300, 512)).astype(np.float32), 13
    if name == "all_zero_ties":
        return np.zeros((16, 256), np.float32), 5
    if name == "duplicated_maxima":
        y = np.zeros((4, 128), np.float32)
        y[:, 10] = 7.0
        y[:, 90] = 7.0
        return y, 3
    if name == "uneven_rows":
        return rng.normal(size=(77, 384)).astype(np.float32), 9
    # the main path's widths: flat sub-chunk selection at 2 x 100k cells
    # (W = 3136) and the running merge of the tiled search (W = 20 + 8192),
    # with planted ties and -inf pad columns; and the chunk top-k of a
    # two-pass search over ~6.3M data rows (W = 50,000), wider than a row
    # in an SM's shared memory
    w = int(name.split("_")[1])
    x = rng.normal(size=(12 if w < 10000 else 5, w)).astype(np.float32)
    x[:, [7, 100, w - 40]] = 5.0
    x[:, w - 30:] = -np.inf
    return x, 20


CASES = ["random", "all_zero_ties", "duplicated_maxima", "uneven_rows",
         "width_3136", "width_8212", "width_50000"]


@pytest.mark.parametrize("name", CASES)
def test_topk_plain_matches_jax_kernel(name, rng):
    x, k = _case(name, rng)
    jv, ji = j_topk_rows(jnp.asarray(x), k, interpret=True)
    tv, ti = topk_rows(torch.from_numpy(x), k)
    assert ti.dtype == torch.int32
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert np.array_equal(np.asarray(ji), ti.numpy())
    lv, li = lax.top_k(jnp.asarray(x), k)
    assert np.array_equal(np.asarray(li), ti.numpy())


def test_topk_fewer_finite_than_k_follows_lax_top_k():
    """Reference-side defect pinned: with fewer than k entries above -inf the
    JAX kernel repeats column 0; the port gives distinct columns, as
    lax.top_k does."""
    x = np.full((3, 128), -np.inf, np.float32)
    x[:, 7] = 2.0
    x[:, 5] = 1.0
    jv, ji = j_topk_rows(jnp.asarray(x), 4, interpret=True)
    tv, ti = topk_rows(torch.from_numpy(x), 4)
    lv, li = lax.top_k(jnp.asarray(x), 4)
    assert np.array_equal(np.asarray(ji), np.tile([7, 5, 0, 0], (3, 1)))
    assert np.array_equal(ti.numpy(), np.tile([7, 5, 0, 1], (3, 1)))
    assert np.array_equal(ti.numpy(), np.asarray(li))
    assert np.array_equal(tv.numpy(), np.asarray(lv))


def test_topk_cpu_uses_plain_version_without_launch(rng):
    x = torch.from_numpy(rng.normal(size=(9, 70)).astype(np.float32))
    before = topk_rows.launches
    v, i = topk_rows(x, 6)
    pv, pi = topk_rows_plain(x, 6)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert topk_rows.launches == before
    with pytest.raises(ValueError):
        topk_rows(x, 71)
    with pytest.raises(ValueError):
        topk_rows(x[0], 3)


def test_select_topk_fp64_and_large_k_take_the_stable_sort(rng):
    x = rng.normal(size=(5, 200))
    x[:, 3] = x[:, 150] = 9.0
    for arr, k in ((x, 10), (x.astype(np.float32), 80)):
        t = torch.from_numpy(arr)
        v, i = select_topk(t, k)
        lv, li = lax.top_k(jnp.asarray(arr), k)
        assert np.array_equal(i.numpy(), np.asarray(li))
        assert np.array_equal(v.numpy(), np.asarray(lv))
    assert topk_cuda.MAX_K == 64
