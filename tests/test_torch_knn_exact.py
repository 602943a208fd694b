"""K5's host side without a card: where the exact search engages it, how
the data rows split into ranges, and that a CPU search counts no fused
search. The kernel itself is held against ``_knn_tiled`` in
``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

import batchelor_torch as bt
from batchelor_torch.ops import knn_exact_cuda
from batchelor_torch.ops.knn import query_knn
from batchelor_torch.ops.knn_exact_cuda import MAX_SCRATCH_BYTES, plan_ranges, takes

CUDA = torch.device("cuda")


@pytest.mark.parametrize("device,dtype,k,d,want", [
    (CUDA, torch.float32, 20, 50, True),
    (CUDA, torch.float32, 1, 2, True),
    (CUDA, torch.float32, 64, 128, True),
    (CUDA, torch.float16, 20, 50, True),          # promotes to fp32, as _knn_tiled does
    (CUDA, torch.float64, 20, 50, False),
    (CUDA, torch.float32, 65, 50, False),
    (CUDA, torch.float32, 20, 129, False),
    (torch.device("cpu"), torch.float32, 20, 50, False),
])
def test_k5_takes_the_card_fp32_k64_d128_searches(device, dtype, k, d, want):
    assert takes(device, dtype, k, d) is want


@pytest.mark.parametrize("nq,nd,k,slots", [
    (47_250, 330_750, 20, 264), (330_750, 47_250, 20, 264), (47_250, 36_000, 20, 132),
    (10_727, 23_000, 20, 264), (1_022, 10_727, 20, 264), (100, 12_000, 20, 132),
    (77, 100, 64, 132), (5, 1, 1, 132), (200_000, 1_000_000, 64, 132),
])
def test_plan_ranges_covers_the_tiles_once(nq, nd, k, slots):
    ranges, per = plan_ranges(nq, nd, k, slots)
    tiles = -(-nd // 128)
    assert 1 <= ranges <= tiles and per >= 1
    assert (ranges - 1) * per < tiles <= ranges * per       # no empty range
    assert ranges == 1 or ranges * nq * k * 8 <= MAX_SCRATCH_BYTES


def test_plan_ranges_splits_only_where_queries_fill_the_card_thinly():
    # scIB's smallest batch against the rest: 8 CTAs of queries on 264 slots
    assert plan_ranges(1_022, 23_000, 20, 264)[0] > 8
    # many waves of query CTAs: one range
    assert plan_ranges(330_750, 47_250, 20, 264) == (1, 370)
    # 370 query CTAs are 1.4 waves of 264: more ranges even out the waves
    ranges, per = plan_ranges(47_250, 330_750, 20, 264)
    waves = -(-370 * ranges // 264)
    assert ranges > 1 and waves * (per + 4) < 2 * (2584 + 4)


def test_cpu_exact_search_counts_no_fused_search():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(30, 6)).astype(np.float32)
    x = rng.normal(size=(200, 6)).astype(np.float32)
    before = knn_exact_cuda.knn_exact.launches
    rec = bt.MetricsRecorder()
    with rec.activate():
        res = query_knn(q, x, 5, method="exact", device="cpu")
    assert res.indices.shape == (30, 5)
    assert knn_exact_cuda.knn_exact.launches == before
    counters = rec.summary()["counters"]
    assert counters["knn/exact/searches"] == 1.0
    assert "knn/exact/fused" not in counters
