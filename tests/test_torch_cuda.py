"""Kernel checks that need a CUDA card: edge cases chip_smoke.py does not reach.

Skipped without a card. On the card (no JAX there, so without the suite's
conftest):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Each kernel is held against its plain version on the same card tensors:
K2 exactly, K1 and K4 within 2^-20 of the query column's max |score|, K3
within 2^-20 of the query row's max |score|, with the same -inf entries,
K5 against ``_knn_tiled``: the same neighbours wherever the k-th and the
(k+1)-th scores are not near-equal, distances within 1e-5 of the scores'
terms, exact ties to the lower row bit for bit; K6 and the card's trend fit
against the host's numpy within 1e-10 (fp64 sums in another order).
"""
import numpy as np
import pytest
import torch

from batchelor_torch.ops import knn_cuda, knn_exact_cuda, pass1_cuda, rescore_cuda, topk_cuda
from batchelor_torch.ops.knn import _knn_tiled, query_knn

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(7)


@pytest.mark.parametrize("n,w,k", [(3, 20, 20), (5, 40, 4), (77, 384, 9), (300, 512, 13),
                                   (64, 20000, 64)])
def test_topk_rows_kernel_matches_plain(n, w, k, card):
    # k = 64 keeps two list entries a lane
    x = torch.randn(n, w, device="cuda", generator=card)
    x[:, 1] = x[:, w - 1] = 3.0
    x[::2, w // 2:] = float("-inf")
    before = topk_cuda.topk_rows.launches
    v, i = topk_cuda.topk_rows(x, k)
    pv, pi = topk_cuda.topk_rows_plain(x, k)
    torch.cuda.synchronize()
    assert topk_cuda.topk_rows.launches == before + 1
    assert torch.equal(v, pv) and torch.equal(i, pi)


def _k2_rows(n, w, k, gen):
    """n rows of width w that cycle through seven kinds: normal with planted
    ties, all equal, fewer finite entries than k, all -inf, ascending, a
    merge row (k sorted high values, then a tile holding a copy of the k-th)
    and normal with an -inf pad."""
    x = torch.randn(n, w, device="cuda", generator=gen)
    for r in range(n):
        kind = r % 7
        if kind == 0:
            x[r, [w // 3, w // 2, w - 1]] = 3.0
        elif kind == 1:
            x[r] = 1.5
        elif kind in (2, 3):
            x[r] = float("-inf")
            if kind == 2:
                few = torch.randperm(w, device="cuda", generator=gen)[:(k - 1) // 2]
                x[r, few] = torch.randn(few.numel(), device="cuda", generator=gen)
        elif kind == 4:
            x[r] = torch.arange(w, device="cuda", dtype=torch.float32)
        elif kind == 5:
            m = min(k, w)
            x[r, :m] = 10.0 - 0.25 * torch.arange(m, device="cuda", dtype=torch.float32)
            x[r, w - 1] = x[r, m - 1]
        else:
            x[r, w - w // 4:] = float("-inf")
    return x


@pytest.mark.parametrize("n,w,k", [
    (n, w, k)
    for n, w in ((13, 1), (13, 31), (13, 33), (13, 640), (13, 3136), (13, 8205), (13, 8212),
                 (8, 60000), (7, 250000))
    for k in (1, 20, 64) if k <= w])
def test_topk_rows_kernel_on_any_width(n, w, k, card):
    # widths below, at and past a 32-column step; W = 8205 (13 + 8192) starts
    # rows off a 16-byte boundary; 60,000 and 250,000 columns are wider than
    # a row in an SM's shared memory (the old kernel's cap, 46,284). n = 13
    # and 7 leave the last CTA's eight warps partly without a row.
    x = _k2_rows(n, w, k, card)
    before = topk_cuda.topk_rows.launches
    v, i = topk_cuda.topk_rows(x, k)
    pv, pi = topk_cuda.topk_rows_plain(x, k)
    torch.cuda.synchronize()
    assert topk_cuda.topk_rows.launches == before + 1
    assert torch.equal(v, pv) and torch.equal(i, pi)


def test_topk_rows_kernel_rejects_what_it_cannot_take(card):
    x = torch.randn(4, 100, device="cuda", generator=card)
    with pytest.raises(TypeError):
        topk_cuda.topk_rows(x.double(), 3)
    with pytest.raises(ValueError):
        topk_cuda.topk_rows(x, 65)
    with pytest.raises(ValueError):
        topk_cuda.topk_rows(x.T, 3)


@pytest.mark.parametrize("mode", ["bf16", "fp32", "six_pass"])
@pytest.mark.parametrize("d0", [50, 100, 200])
def test_chunk_max_kernel_matches_plain(mode, d0, card):
    # dpad 64, 128 and 256: one, two and four 64-feature steps
    query = torch.randn(300, d0, device="cuda", generator=card)
    data = torch.randn(3000, d0, device="cuda", generator=card) + 0.5
    valid = torch.ones(3000, dtype=torch.bool, device="cuda")
    valid[1000:1100] = False
    q, x = knn_cuda._pass1_operands(query, data, valid, bf16=mode == "bf16")
    assert q.shape[1] == {50: 64, 100: 128, 200: 256}[d0]
    six = mode == "six_pass"
    got = knn_cuda.chunk_max_scores(q, x, six)
    want = knn_cuda.chunk_max_scores_plain(q, x, six)
    torch.cuda.synchronize()
    sentinel = want.abs() > 1e29
    scale = torch.where(sentinel, want.abs(), torch.where(sentinel, 0.0, want.abs()).amax(0))
    assert bool(((got - want).abs() <= 2.0 ** -20 * scale).all())


@pytest.mark.parametrize("dp,d0", [(64, 50), (128, 100), (256, 200), (512, 400)])
@pytest.mark.parametrize("nd", [128, 384, 3072])
@pytest.mark.parametrize("nq", [128, 640])
def test_chunk_max_bf16_kernel_on_ragged_tiles(dp, d0, nd, nq, card):
    # the bf16 kernel's data tiles hold 256 rows: nd = 128 and 384 leave a
    # last tile half past nd (read as zeros, which score 0 and must never be
    # stored); nq = 640 is 5 pairs of 64-query tiles, which the split of the
    # queries over the SMs does not divide evenly; dp = 512 streams the data
    # tile's k-blocks beside the query k-blocks instead of keeping it.
    # Queries lie apart from the data, as on the main path, so each column's
    # max |s| reaches the size of the summed terms (|x|^2 ~ 1.25 d0): with 3
    # sub-chunks of queries amid the data it can fall to ~8 against terms of
    # ~31, where any fp32 order of the sums misses 2^-20 of it
    query = 0.5 * torch.randn(nq, d0, device="cuda", generator=card)
    data = torch.randn(nd, d0, device="cuda", generator=card) + 0.5
    data[40] = data[33]                      # a tie inside sub-chunk 1
    data[nd - 1] = data[nd - 20]             # and inside the last sub-chunk
    valid = torch.ones(nd, dtype=torch.bool, device="cuda")
    valid[64:96] = False                     # sub-chunk 2: sentinel rows only
    valid[nd - 5] = False
    q, x = knn_cuda._pass1_operands(query, data, valid, bf16=True)
    assert q.shape[1] == dp
    q, x = q[:nq], x[:nd]
    before = knn_cuda.chunk_max_scores.launches
    got = knn_cuda.chunk_max_scores(q, x)
    want = knn_cuda.chunk_max_scores_plain(q, x)
    torch.cuda.synchronize()
    assert knn_cuda.chunk_max_scores.launches == before + 1
    assert got.shape == (nd // 32, nq) and got.t().is_contiguous()
    assert bool(torch.isfinite(got).all()) and bool((got[2] < -1e29).all())
    _within_column_bound(got, want)


@pytest.mark.parametrize("method", ["exact", "chunked", "bf16"])
def test_query_knn_card_matches_cpu(method, card):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(500, 24)).astype(np.float32)
    x = rng.normal(size=(6000, 24)).astype(np.float32)
    gpu = query_knn(q, x, 20, method=method)
    cpu = query_knn(q, x, 20, method=method, device="cpu")
    agree = (gpu.indices.cpu() == cpu.indices).float().mean().item()
    assert agree >= (0.999 if method != "bf16" else 0.99)
    same = gpu.indices.cpu() == cpu.indices
    assert torch.allclose(gpu.distances.cpu()[same], cpu.distances[same], atol=1e-4)


def test_entry_points_default_to_the_card(card):
    rng = np.random.default_rng(4)
    res = query_knn(rng.normal(size=(10, 3)), rng.normal(size=(50, 3)), 2)
    assert res.indices.device.type == "cuda"


@pytest.mark.parametrize("c32", [3136, 8448, 196608])
def test_select_subchunks_card_matches_cpu(c32, card):
    # 196608 sub-chunks (6.3M data rows): the chunk top-k runs over 49,152
    # columns, past the old kernel's width cap; a few hundred queries
    m_t = torch.randn(c32, 300 if c32 > 10000 else 1024, device="cuda", generator=card)
    got = knn_cuda._select_subchunks(m_t, 20)
    want = knn_cuda._select_subchunks(m_t.cpu(), 20)
    assert torch.equal(got.cpu(), want)


def _k3_matches_plain(q, data3, dn2, top_sub):
    """One kernel call (one launch on the counter) within 2^-20 of the row's
    max |score| of the plain version, with the same -inf entries."""
    before = rescore_cuda.rescore_subchunks.launches
    got = rescore_cuda.rescore_subchunks(q, data3, dn2, top_sub)
    want = rescore_cuda.rescore_subchunks_plain(q, data3, dn2, top_sub)
    torch.cuda.synchronize()
    assert rescore_cuda.rescore_subchunks.launches == before + 1
    masked = torch.isinf(want)
    assert torch.equal(masked, torch.isinf(got)) and bool((got[masked] < 0).all())
    scale = torch.where(masked, 0.0, want.abs()).amax(1, keepdim=True)
    diff = torch.where(masked, 0.0, got - want).abs()
    assert bool((diff <= 2.0 ** -20 * scale).all())
    return got


def _k3_inputs(nq, c32, ks, d, gen):
    q = torch.randn(nq, d, device="cuda", generator=gen)
    data3 = torch.randn(c32, 32, d, device="cuda", generator=gen)
    dn2 = (data3 * data3).sum(2)
    dn2[1, 3:9] = float("inf")                     # masked rows score -inf
    top_sub = torch.randint(0, c32, (nq, ks), device="cuda", generator=gen)
    top_sub[:, 0] = 1
    return q, data3, dn2, top_sub


@pytest.mark.parametrize("nq,c32,ks,d", [(300, 96, 20, 50), (77, 40, 5, 64), (64, 33, 3, 7),
                                         (50, 64, 20, 300), (5, 8, 1, 129)])
def test_rescore_subchunks_kernel_matches_plain(nq, c32, ks, d, card):
    # d = 300 and 129 stage each sub-chunk in several pieces of features
    _k3_matches_plain(*_k3_inputs(nq, c32, ks, d, card))


@pytest.mark.parametrize("case", ["hub", "hub_only", "wide", "wide_sorted", "repeated", "ks1",
                                  "nq1"])
def test_rescore_subchunks_kernel_on_skewed_ids(case, card):
    # with 2 or more slots a sub-chunk the kernel sorts the slots by
    # sub-chunk and cuts them into 64-slot items: a bucket larger than 3
    # items, ids repeated within a row, one rank; 22,000 slots over 10,000
    # sub-chunks (counted by global atomics past 8,192); with fewer it runs
    # one warp a query: 300 queries over 196,608 sub-chunks (1.26 GB of
    # data3, past the L2), one query
    nq, c32, ks, d = {"hub": (1000, 300, 20, 50), "hub_only": (700, 64, 3, 50),
                      "wide": (300, 196608, 20, 50), "wide_sorted": (1100, 10000, 20, 50),
                      "repeated": (200, 50, 10, 33), "ks1": (400, 20, 1, 50),
                      "nq1": (1, 30, 20, 50)}[case]
    q, data3, dn2, top_sub = _k3_inputs(nq, c32, ks, d, card)
    if case == "hub_only":                         # every slot in bucket 1 or 2
        top_sub[:] = 1
        top_sub[::3, 2] = 2
    if case == "repeated":
        top_sub[:, 1::2] = top_sub[:, 0::2]
        top_sub[::4, :] = 7
    _k3_matches_plain(q, data3, dn2, top_sub)


def test_rescore_subchunks_kernel_is_deterministic(card):
    # the atomics order the slots of a bucket differently from call to call;
    # each output is still one fixed-order chain
    q, data3, dn2, top_sub = _k3_inputs(2000, 200, 20, 50, card)
    first = rescore_cuda.rescore_subchunks(q, data3, dn2, top_sub)
    second = rescore_cuda.rescore_subchunks(q, data3, dn2, top_sub)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.parametrize("c32", [100, 20000])       # sorted, one warp a query
def test_rescore_subchunks_kernel_reads_nothing_back(c32, card):
    assert rescore_cuda.kernel_plan(500, 20, c32)[0] == (c32 == 100)
    q, data3, dn2, top_sub = _k3_inputs(500, c32, 20, 50, card)
    want = rescore_cuda.rescore_subchunks(q, data3, dn2, top_sub)   # built before
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = rescore_cuda.rescore_subchunks(q, data3, dn2, top_sub)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("c32", [40, 4000])         # sorted, one warp a query
def test_rescore_subchunks_kernel_nan_row_for_id_out_of_range(c32, card):
    q, data3, dn2, top_sub = _k3_inputs(100, c32, 5, 50, card)
    top_sub[3, 2] = c32
    top_sub[9, 0] = -1
    got = rescore_cuda.rescore_subchunks(q, data3, dn2, top_sub)
    bad = torch.zeros(100, 5, dtype=torch.bool, device="cuda")
    bad[3, 2] = bad[9, 0] = True
    bad = bad.repeat_interleave(32, 1)
    assert bool(torch.isnan(got[bad]).all()) and not bool(torch.isnan(got[~bad]).any())
    ids = top_sub.clamp(0, c32 - 1)
    want = rescore_cuda.rescore_subchunks_plain(q, data3, dn2, ids)
    ok = ~bad & ~torch.isinf(want)
    scale = torch.where(torch.isinf(want), 0.0, want.abs()).amax(1, keepdim=True)
    assert bool(((got - want).abs() <= 2.0 ** -20 * scale)[ok].all())


def test_rescore_subchunks_kernel_rejects_what_it_cannot_take(card):
    q = torch.randn(4, 8, device="cuda", generator=card)
    data3 = torch.randn(3, 32, 8, device="cuda", generator=card)
    dn2 = torch.zeros(3, 32, device="cuda")
    ids = torch.zeros(4, 2, dtype=torch.long, device="cuda")
    with pytest.raises(TypeError):
        rescore_cuda.rescore_subchunks(q, data3, dn2, ids.int())
    with pytest.raises(ValueError):
        rescore_cuda.rescore_subchunks(q.T.contiguous().T, data3, dn2, ids)
    with pytest.raises(ValueError):
        rescore_cuda.rescore_subchunks(q, data3, dn2.cpu(), ids)
    # dn2 a float past a 16-byte boundary; the guard of nq * ks < 2^31 slots
    # is not tested here: it would need an id tensor of 16 GiB
    dn2_off = torch.zeros(3 * 32 + 1, device="cuda")[1:].view(3, 32)
    with pytest.raises(ValueError):
        rescore_cuda.rescore_subchunks(q, data3, dn2_off, ids)
    data3_off = torch.zeros(3 * 32 * 8 + 1, device="cuda")[1:].view(3, 32, 8)
    with pytest.raises(ValueError):
        rescore_cuda.rescore_subchunks(q, data3_off, dn2, ids)


@pytest.mark.parametrize("precision", ["bf16", "high3", "highest"])
@pytest.mark.parametrize("d0", [50, 100, 250])
def test_pass1_scores_kernel_matches_plain(precision, d0, card):
    # dpad 64, 128 and 256: one, two and four 64-feature steps
    query = torch.randn(300, d0, device="cuda", generator=card)
    data = torch.randn(3000, d0, device="cuda", generator=card) + 0.5
    valid = torch.ones(3000, dtype=torch.bool, device="cuda")
    valid[1000:1100] = False
    q, x, dn = pass1_cuda.pass1_operands(query, data, valid)
    assert q.shape[1] == {50: 64, 100: 128, 250: 256}[d0]
    before = pass1_cuda.pass1_scores.launches
    got = pass1_cuda.pass1_scores(q, x, dn, precision)
    want = pass1_cuda.pass1_scores_plain(q, x, dn, precision)
    torch.cuda.synchronize()
    assert pass1_cuda.pass1_scores.launches == before + 1
    masked = torch.isinf(want)
    assert bool(masked.any()) and torch.equal(masked, torch.isinf(got))
    scale = torch.where(masked, 0.0, want.abs()).amax(0, keepdim=True)
    diff = torch.where(masked, 0.0, got - want).abs()
    assert bool((diff <= 2.0 ** -20 * scale).all())


@pytest.mark.parametrize("nd,nq", [(1152, 640), (384, 128), (3072, 1024)])
@pytest.mark.parametrize("dp,d0", [(64, 50), (128, 100), (256, 250), (384, 300)])
def test_pass1_bf16_kernel_on_ragged_tiles(dp, d0, nd, nq, card):
    # K4's bf16 mode runs K1's persistent wgmma kernel with dn in shared
    # memory beside the 256-row data tile: nd = 1152 and 384 leave a last
    # tile of 128 rows (zeros past nd, dn copied only up to nd); nq = 640
    # is 10 query tiles of 64, which the three consumers do not share
    # evenly; dp = 384 streams the data tile's k-blocks, and dn once a unit
    query = torch.randn(nq, d0, device="cuda", generator=card)
    data = torch.randn(nd, d0, device="cuda", generator=card) + 0.5
    data[40] = data[33]                      # a tie inside sub-chunk 1
    valid = torch.ones(nd, dtype=torch.bool, device="cuda")
    valid[64:96] = False                     # sub-chunk 2: masked rows only
    valid[nd - 5] = False
    q, x, dn = pass1_cuda.pass1_operands(query, data, valid)
    assert q.shape[1] == dp
    q, x, dn = q[:nq], x[:nd], dn[:nd]
    before = pass1_cuda.pass1_scores.launches
    got = pass1_cuda.pass1_scores(q, x, dn, "bf16")
    want = pass1_cuda.pass1_scores_plain(q, x, dn, "bf16")
    torch.cuda.synchronize()
    assert pass1_cuda.pass1_scores.launches == before + 1
    assert got.shape == (nd // 32, nq) and got.t().is_contiguous()
    assert got.t().contiguous().data_ptr() == got.data_ptr()   # the selection copies nothing
    assert bool(torch.isneginf(got[2]).all()) and bool(torch.isfinite(got[3:]).all())
    _within_column_bound(got, want)


def test_pass1_bf16_kernel_is_deterministic(card):
    query = torch.randn(1000, 50, device="cuda", generator=card)
    data = torch.randn(5000, 50, device="cuda", generator=card) + 0.5
    valid = torch.ones(5000, dtype=torch.bool, device="cuda")
    q, x, dn = pass1_cuda.pass1_operands(query, data, valid)
    first = pass1_cuda.pass1_scores(q, x, dn, "bf16")
    second = pass1_cuda.pass1_scores(q, x, dn, "bf16")
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


def test_pass1_bf16_kernel_rejects_a_misaligned_norm(card):
    q = torch.randn(128, 64, device="cuda", generator=card)
    x = torch.randn(128, 64, device="cuda", generator=card)
    dn_off = torch.zeros(129, device="cuda")[1:]
    with pytest.raises(ValueError):
        pass1_cuda.pass1_scores(q, x, dn_off, "bf16")


def _within_column_bound(got, want):
    """|got - want| <= 2^-20 of each query column's max |score|; -inf (K4's
    masked rows) and K1's 1e30 sentinel entries must match themselves."""
    inf = torch.isinf(want)
    assert torch.equal(inf, torch.isinf(got))
    sentinel = inf | (want.abs() > 1e29)
    scale = torch.where(sentinel, 0.0, want.abs()).amax(0, keepdim=True)
    bound = torch.where(sentinel & ~inf, want.abs(), scale) * 2.0 ** -20
    diff = torch.where(inf, 0.0, got - want).abs()
    assert bool((diff <= bound).all()), float((diff / bound).max())


@pytest.mark.parametrize("split", ["K1 fp32", "K1 six_pass", "K4 high3", "K4 highest"])
@pytest.mark.parametrize("query_tiles", [1, 3, 6, 21])
def test_split_modes_on_query_counts_off_the_walk(split, query_tiles, card):
    # 128-query tiles that the split kernels' query walk (16 tiles of 128
    # queries, or of 64 with six_pass) does not divide; 21 takes several
    # walks, the last one short
    nq = 128 * query_tiles
    query = torch.randn(nq, 50, device="cuda", generator=card)
    data = torch.randn(1024, 50, device="cuda", generator=card) + 0.5
    valid = torch.ones(1024, dtype=torch.bool, device="cuda")
    valid[200:300] = False
    if split.startswith("K1"):
        q, x = knn_cuda._pass1_operands(query, data, valid)
        q, six = q[:nq].contiguous(), split.endswith("six_pass")
        got = knn_cuda.chunk_max_scores(q, x, six)
        want = knn_cuda.chunk_max_scores_plain(q, x, six)
    else:
        q, x, dn = pass1_cuda.pass1_operands(query, data, valid)
        q, prec = q[:nq].contiguous(), split.split()[1]
        got = pass1_cuda.pass1_scores(q, x, dn, prec)
        want = pass1_cuda.pass1_scores_plain(q, x, dn, prec)
    torch.cuda.synchronize()
    assert got.shape == (1024 // 32, nq)
    _within_column_bound(got, want)


@pytest.mark.parametrize("exact_selection", [False, True])
def test_chunked_selection_near_ties_on_the_card(exact_selection, card):
    # tests/test_knn_backends.py's adversarial geometry: rows on a ray at
    # radii 10 + i * 1e-3, the query at radius 9, so neighbouring scores
    # differ by ~2e-3 at a magnitude of ~100; fp32 selection (3 or 6 split
    # products) must still rank them as the exact search does
    rng = np.random.default_rng(42)
    u = rng.normal(size=8)
    u /= np.linalg.norm(u)
    radii = 10.0 + 1e-3 * rng.permutation(1024)
    x = torch.from_numpy((radii[:, None] * u[None, :]).astype(np.float32)).cuda()
    q = torch.from_numpy(np.tile((9.0 * u).astype(np.float32), (16, 1))).cuda()
    before = knn_cuda.chunk_max_scores.launches
    ref = query_knn(q, x, 4, method="exact")
    out = query_knn(q, x, 4, method="chunked", exact_selection=exact_selection)
    assert knn_cuda.chunk_max_scores.launches == before + 1
    assert out.indices.device.type == "cuda"
    assert torch.equal(out.indices, ref.indices)
    assert torch.allclose(out.distances, ref.distances, rtol=0.0, atol=1e-5)


def _fused_inputs(n1, n2, d, seed):
    rng = np.random.default_rng(seed)
    left = rng.normal(size=(n1, d)).astype(np.float32)
    right = (rng.normal(size=(n2, d)) + 0.7).astype(np.float32)
    return left, right


def test_fused_merge_step_card_matches_cpu(card):
    from batchelor_torch import fused_merge_step

    left, right = _fused_inputs(3000, 2500, 20, 11)
    gpu = fused_merge_step(left, right, 20, 20, knn_method="exact")
    cpu = fused_merge_step(left, right, 20, 20, knn_method="exact", device="cpu")
    assert gpu.left.device.type == "cuda"
    assert torch.equal(gpu.pair_mask.cpu(), cpu.pair_mask)
    assert torch.equal(gpu.pair_targets.cpu(), cpu.pair_targets)
    assert int(gpu.n_pairs) == int(cpu.n_pairs)
    scale = float(cpu.right.abs().max())
    for name in ("left", "right"):
        assert float((getattr(gpu, name).cpu() - getattr(cpu, name)).abs().max()) <= 1e-4 * scale
    assert abs(float(gpu.batch_size) - float(cpu.batch_size)) <= 1e-5 * float(cpu.batch_size)


@pytest.mark.parametrize("method", ["chunked", "bf16"])
@pytest.mark.parametrize("n_valid", [2000, 6])
def test_two_pass_search_over_masked_data(method, n_valid, card):
    """The fused step's tricube search: most data rows masked (90%, or all
    but 6, fewer than k), against the CPU's plain version of the same
    search. Indices agree up to near-ties, masked rows never come back at
    a finite distance, and +inf stands exactly where the CPU has it."""
    rng = np.random.default_rng(12)
    q = rng.normal(size=(1500, 50)).astype(np.float32)
    x = rng.normal(size=(20000, 50)).astype(np.float32)
    mask = np.zeros(20000, bool)
    mask[rng.choice(20000, n_valid, replace=False)] = True
    gpu = query_knn(q, x, 20, data_mask=mask, method=method)
    cpu = query_knn(q, x, 20, data_mask=mask, method=method, device="cpu")
    fin = torch.isfinite(cpu.distances)
    assert int(fin.sum()) == 1500 * min(20, n_valid)
    assert torch.equal(torch.isfinite(gpu.distances.cpu()), fin)
    gi = gpu.indices.cpu()
    assert bool(torch.from_numpy(mask)[gi[fin]].all())
    same = (gi == cpu.indices) & fin
    agree = float(same.sum()) / float(fin.sum())
    assert agree >= (0.999 if method == "chunked" else 0.99)
    assert torch.allclose(gpu.distances.cpu()[same], cpu.distances[same], atol=1e-4)
    if n_valid < 20:          # no near-ties among 6 rows: every index agrees
        assert torch.equal(gi[fin], cpu.indices[fin])


def test_fused_merge_step_second_call_does_not_sync(card):
    from batchelor_torch import fused_merge_step

    # 12,000^2 scores pass AUTO_MIN_SCORES: "auto" takes the two-pass search
    left, right = (torch.from_numpy(a).cuda() for a in _fused_inputs(12000, 12000, 50, 13))
    before = knn_cuda.chunk_max_scores.launches
    warm = fused_merge_step(left, right, 20, 20, knn_method="auto")
    assert knn_cuda.chunk_max_scores.launches > before
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = fused_merge_step(left, right, 20, 20, knn_method="auto")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(again.pair_mask, warm.pair_mask)
    assert bool(torch.isfinite(again.right).all())


@pytest.mark.parametrize("w", [2, 3, 5, 8, 17, 32, 33, 40])
def test_topk_rows_kernel_on_narrow_rows_with_k1(w, card):
    # cluster_mnn's nearest-centroid search: the running best beside a few
    # centroids (a row of 1 + C columns), k = 1, in 16,384-row query tiles
    x = torch.randn(16384, w, device="cuda", generator=card)
    x[::3, w - 1] = x[::3, 0]                            # ties go to the lower column
    x[1::5, :] = float("-inf")                           # rows without a finite entry
    x[2::7, 1:] = float("-inf")
    odd = _k2_rows(21, w, 1, card)
    for rows in (x, odd):
        before = topk_cuda.topk_rows.launches
        v, i = topk_cuda.topk_rows(rows, 1)
        pv, pi = topk_cuda.topk_rows_plain(rows, 1)
        torch.cuda.synchronize()
        assert topk_cuda.topk_rows.launches == before + 1
        assert torch.equal(v, pv) and torch.equal(i, pi)


def _gene_space(res):
    return (res.corrected.double() @ res.rotation.double().T).cpu()


def test_cluster_mnn_card_matches_cpu(card):
    from batchelor_torch import cluster_mnn

    rng = np.random.default_rng(21)
    means = rng.normal(size=(4, 80)) * 2
    labels = [rng.integers(0, 4, 700) for _ in range(3)]
    mats = [means[c] + rng.normal(size=(700, 80)) + rng.normal(size=(1, 80)) * 0.5 * i
            for i, c in enumerate(labels)]
    kw = dict(clusters=labels, restrict=[None, np.arange(0, 700, 2), None])
    gpu = cluster_mnn(mats, **kw)
    cpu = cluster_mnn(mats, device="cpu", **kw)
    assert gpu.corrected.device.type == "cuda"
    for a, b in zip(gpu.centroid_result.merge_info, cpu.centroid_result.merge_info):
        assert set(map(tuple, a.pairs.tolist())) == set(map(tuple, b.pairs.tolist()))
    for key in ("cluster", "batch", "meta"):
        assert np.array_equal(gpu.cluster_meta[key], cpu.cluster_meta[key])
    want = _gene_space(cpu)
    assert float((_gene_space(gpu) - want).abs().max()) <= 1e-8 * float(want.abs().max())


def test_quick_correct_card_matches_cpu(card):
    from batchelor_torch import FastMNNParams, quick_correct

    rng = np.random.default_rng(22)
    lam = np.exp(rng.normal(size=(3, 300)))
    counts = [rng.poisson(lam[rng.integers(0, 3, n)] * s).astype(np.float64)
              for n, s in ((500, 1.0), (600, 1.7))]
    kw = dict(hvg_n=100, params=FastMNNParams(d=10))
    gpu = quick_correct(counts, **kw)
    cpu = quick_correct(counts, device="cpu", **kw)
    assert np.array_equal(gpu.hvgs, cpu.hvgs)
    assert np.allclose(gpu.dec.bio, cpu.dec.bio, atol=1e-10, rtol=0)
    for a, b in zip(gpu.corrected.merge_info, cpu.corrected.merge_info):
        assert np.array_equal(a.pairs, b.pairs)
    want = _gene_space(cpu.corrected)
    assert float((_gene_space(gpu.corrected) - want).abs().max()) <= 1e-8 * float(want.abs().max())


def test_batch_correct_regress_card_matches_cpu(card):
    from batchelor_torch import RegressParams, batch_correct

    rng = np.random.default_rng(23)
    mats = [rng.normal(size=(400, 60)) + i for i in range(3)]
    kw = dict(params=RegressParams(d=5), restrict=[None, np.arange(100), None])
    gpu = batch_correct(mats, **kw)
    cpu = batch_correct(mats, device="cpu", **kw)
    assert gpu.corrected.device.type == "cuda"
    assert torch.allclose(gpu.corrected.cpu(), cpu.corrected, atol=1e-10, rtol=0)
    sign = torch.sign((gpu.corrected_pcs.cpu() * cpu.corrected_pcs).sum(0))
    assert torch.allclose(gpu.corrected_pcs.cpu() * sign, cpu.corrected_pcs, atol=1e-8, rtol=0)


def _csr_counts(rng, n, g, density):
    x = rng.poisson(3.0, size=(n, g)).astype(np.float32) + 1
    return (x * (rng.uniform(size=(n, g)) < density)).astype(np.float32)


def test_device_dense_blocks_card_matches_host(card):
    from batchelor_torch import CSRCells, dense_blocks, device_dense_blocks

    rng = np.random.default_rng(24)
    x = _csr_counts(rng, 1000, 300, 0.1)
    x[[5, 999]] = 0                                      # empty rows, the last too
    csr = CSRCells.from_dense(x)
    host = list(dense_blocks(csr, block_rows=384))
    dev = list(device_dense_blocks(csr, block_rows=384))
    assert [n for _, n in dev] == [n for _, n in host] == [384, 384, 232]
    for (hb, _), (db, _) in zip(host, dev):
        assert db.device.type == "cuda" and torch.equal(db.cpu(), torch.from_numpy(hb))
    last, n = list(device_dense_blocks(csr, block_rows=384, pad=False))[-1]
    assert tuple(last.shape) == (232, 300) and torch.equal(last.cpu(), torch.from_numpy(x[768:]))
    empty = CSRCells.from_dense(np.zeros((5, 10), np.float32))
    blocks = list(device_dense_blocks(empty, block_rows=8))
    assert len(blocks) == 1 and blocks[0][1] == 5 and not bool(blocks[0][0].any())


def test_outofcore_pca_transfer_modes_on_the_card(card, monkeypatch):
    # the shipped nonzeros against host-densified blocks copied to the card
    from batchelor_torch import CSRCells, dense_blocks, multi_batch_pca_csr
    from batchelor_torch.ops import pca_outofcore

    def host_densify(csr, block_rows, pad=False, device=None):
        for block, n_valid in dense_blocks(csr, block_rows, pad=pad):
            yield torch.from_numpy(block).to(device), n_valid

    rng = np.random.default_rng(25)
    csrs = [CSRCells.from_dense(_csr_counts(rng, n, 200, 0.08)) for n in (3000, 2500)]
    kw = dict(d=10, block_rows=1024, eig_method="exact")
    sp = multi_batch_pca_csr(csrs, **kw)
    monkeypatch.setattr(pca_outofcore, "device_dense_blocks", host_densify)
    dn = multi_batch_pca_csr(csrs, **kw)
    assert sp.rotation.device.type == "cuda"
    assert torch.equal(sp.centers, dn.centers) and torch.equal(sp.rotation, dn.rotation)
    for a, b in zip(sp.components, dn.components):
        assert np.array_equal(a, b)


def test_quick_correct_csr_card_matches_cpu(card):
    from batchelor_torch import CSRCells, quick_correct_csr

    # 12 cell types and d = 6: the PCA keeps strong, well-separated
    # directions; with fewer types than d the cut would fall among nearly
    # equal noise directions, which the two eigensolvers place apart
    rng = np.random.default_rng(26)
    lam = np.exp(rng.normal(size=(12, 400)) - 1.5)
    stores = [CSRCells.from_dense(rng.poisson(lam[rng.integers(0, 12, n)] * s)
                                  .astype(np.float32)) for n, s in ((900, 1.0), (800, 1.6))]
    kw = dict(hvg_n=150, d=6, k=15, block_rows=512)
    gpu = quick_correct_csr(stores, **kw)
    cpu = quick_correct_csr(stores, device="cpu", **kw)
    assert gpu.corrected.corrected.device.type == "cuda"
    assert np.array_equal(gpu.hvgs, cpu.hvgs)
    # fp32 PCs on both sides, the cut among strong directions: identical
    # pairs, and the corrected values in gene space (blind to how the
    # eigensolvers turn directions within the kept subspace) on every row
    assert np.array_equal(*(np.unique(r.corrected.merge_info[0].pairs, axis=0)
                            for r in (gpu, cpu)))
    want = _gene_space(cpu.corrected)
    err = (_gene_space(gpu.corrected) - want).abs().max()
    assert float(err) <= 1e-4 * float(want.abs().max())


def test_distributed_fast_mnn_nccl_world_of_one_matches_reduced_mnn(card, tmp_path):
    """The parallel layer over a real NCCL group of one rank (each
    collective a local copy on the card), gather and ring modes, against
    reduced_mnn on the same card: identical pairs in every step."""
    import datetime

    import torch.distributed as dist

    from batchelor_torch import reduced_mnn
    from batchelor_torch.parallel import distributed_fast_mnn, make_cells_mesh

    rng = np.random.default_rng(11)
    mats = [torch.from_numpy((rng.normal(size=(3000, 20)) + 0.5 * i).astype(np.float32)).cuda()
            for i in range(3)]
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_cells_mesh()
        assert mesh.group is not None and mesh.size == 1 and mesh.device.type == "cuda"
        with pytest.raises(ValueError):
            make_cells_mesh(2)
        ref = reduced_mnn(mats, k=15, knn_method="exact")
        for memory in ("gather", "ring"):
            res = distributed_fast_mnn(mats, mesh, k=15, memory=memory)
            assert res.corrected.device.type == "cuda"
            assert bool(torch.isfinite(res.corrected).all())
            for a, b in zip(res.merge_info, ref.merge_info):
                assert np.array_equal(np.unique(a.pairs, axis=0), np.unique(b.pairs, axis=0))
            rows = (res.corrected - ref.corrected).abs().amax(1)
            scale = ref.corrected.abs().amax(1)
            assert int((rows > 1e-4 * scale).sum()) <= len(rows) // 1000
    finally:
        dist.destroy_process_group()


def _atlas_pcs(card, sizes=(12_000, 12_000, 4_000), d=50):
    """Three batches of PCs: the first step's searches score 1.44e8 > 2^27
    (the two-pass path under "auto"), the second's 9.6e7 (exact)."""
    base = torch.randn(8, d, device="cuda", generator=card)
    return [base[torch.randint(0, 8, (n,), device="cuda", generator=card)]
            + 0.3 * torch.randn(n, d, device="cuda", generator=card) + 0.5 * b
            for b, n in enumerate(sizes)]


# The walk's end waits once for the steps' copies to the host to land.
_WALK_END_SYNCS = 1


@pytest.mark.parametrize("method,n", [("exact", 4_000), ("auto", 12_000)])
def test_reduced_mnn_waits_once_a_merge_step(method, n, card):
    """After a warm call, ``reduced_mnn`` on 4 fp32 batches makes one
    synchronizing operation a merge step (the read of its pair counts) and
    at most ``_WALK_END_SYNCS`` at the walk's end, none at the entry.

    Against the CPU. In fp32 a row whose k-th neighbour lies within
    rounding of the next may take either on either side (K5 against
    ``_knn_tiled``, as ``_assert_knn_matches_tiled`` allows), and the next
    steps carry that on; so ``"exact"`` is held to the CPU in fp64, where
    both sides run the tiled search: the same pairs in every step, rows
    within 1e-8 of the largest. ``"auto"`` takes the bf16 two-pass search in
    every MNN search at these sizes, which runs only in fp32; the CPU runs
    it as ``"bf16"`` with the kernels' plain versions, whose sub-chunk
    maxima agree within 2^-20: the pairs agree but for 1 in 1,000, and a
    changed pair moves its tricube neighbourhood, so rows agree within
    1e-4 of the largest but for 1 in 100."""
    import warnings

    import batchelor_torch as bt
    from batchelor_torch.ops.knn import AUTO_MIN_SCORES

    rng = np.random.default_rng(17)
    mats = [(rng.normal(size=(n, 50)) + 0.7 * b).astype(np.float32) for b in range(4)]
    batches = [torch.from_numpy(m).cuda() for m in mats]
    assert (n * n > AUTO_MIN_SCORES) == (method == "auto")
    bt.reduced_mnn(batches, k=20, knn_method=method)          # warm: builds the kernels
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            gpu = bt.reduced_mnn(batches, k=20, knn_method=method)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchronizing" in str(w.message)]
    assert len(syncs) <= len(batches) - 1 + _WALK_END_SYNCS, [str(w.message) for w in syncs]

    if method == "exact":
        gpu = bt.reduced_mnn([b.double() for b in batches], k=20, knn_method=method)
        cpu = bt.reduced_mnn([m.astype(np.float64) for m in mats], k=20, device="cpu")
        for a, b in zip(gpu.merge_info, cpu.merge_info, strict=True):
            assert np.array_equal(a.pairs, b.pairs)
        want = cpu.corrected
        assert float((gpu.corrected.cpu() - want).abs().max()) <= 1e-8 * float(want.abs().max())
        return
    cpu = bt.reduced_mnn(mats, k=20, knn_method="bf16", device="cpu")
    for a, b in zip(gpu.merge_info, cpu.merge_info, strict=True):
        mine, theirs = set(map(tuple, a.pairs.tolist())), set(map(tuple, b.pairs.tolist()))
        assert len(mine ^ theirs) <= 1e-3 * len(theirs)
    scale = float(cpu.corrected.abs().max())
    off = (gpu.corrected.cpu() - cpu.corrected).abs().amax(1) > 1e-4 * scale
    assert float(off.double().mean()) <= 1e-2


def test_two_pass_counters_of_an_auto_search(card):
    import batchelor_torch as bt
    from batchelor_torch.ops.knn import AUTO_MIN_SCORES

    nq, nd, d, k = 12_000, 12_000, 50, 20
    assert nq * nd > AUTO_MIN_SCORES
    q = torch.randn(nq, d, device="cuda", generator=card)
    x = torch.randn(nd, d, device="cuda", generator=card)
    mask = torch.rand(nd, device="cuda", generator=card) < 0.5
    rec = bt.MetricsRecorder()
    with rec.activate():
        query_knn(q, x, k, method="auto")
        query_knn(q[:100], x, k, data_mask=mask)       # its valid count stays on the card
    assert [r["name"] for r in rec.records] == ["knn/two_pass", "knn/exact"]
    assert rec.records[0]["attrs"] == {"mode": "bf16", "nq": nq, "nd": nd}
    n_valid = int(mask.sum())
    assert rec.summary()["counters"] == {
        "knn/two_pass/searches": 1.0, "knn/two_pass/scores": float(nq * nd),
        "knn/two_pass/flops": float(2 * d * nq * nd),
        "knn/two_pass/bytes": float((nq + nd) * d * 4 + nq * k * 12),
        "knn/exact/searches": 1.0, "knn/exact/fused": 1.0,
        "knn/exact/scores": float(100 * n_valid),
        "knn/exact/flops": float(2 * d * 100 * n_valid),
        "knn/exact/bytes": float((100 + nd) * d * 4 + 100 * k * 12)}


def test_device_time_of_every_span(card):
    import batchelor_torch as bt

    batches = _atlas_pcs(card)
    rec = bt.MetricsRecorder(device_time=True)
    with rec.activate():
        bt.reduced_mnn(batches, k=20, knn_method="auto")
    spans = rec.summary()["spans"]
    assert all(r["device_ms"] >= 0 for r in rec.records)
    assert spans["fastmnn/call"]["device_ms"] > 0
    assert spans["knn/two_pass"]["count"] == 2 and spans["knn/two_pass"]["device_ms"] > 0
    inner = sum(spans[n]["device_ms"] for n in ("fastmnn/orthogonalize",
                                                "fastmnn/mnn_search", "fastmnn/correct"))
    assert inner <= spans["fastmnn/call"]["device_ms"] * 1.01


def test_a_recorder_adds_no_host_synchronization(card):
    """A profiled call issues the same synchronizing runtime calls with no
    recorder, a recorder and a recorder with device timing."""
    import collections
    import contextlib

    import batchelor_torch as bt
    from torch.profiler import ProfilerActivity, profile

    batches = _atlas_pcs(card)
    bt.reduced_mnn(batches, k=20, knn_method="auto")        # warm

    def syncs(rec):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                (rec.activate() if rec else contextlib.nullcontext()):
            bt.reduced_mnn(batches, k=20, knn_method="auto")
            torch.cuda.synchronize()
        return collections.Counter(e.name for e in prof.events()
                                   if "Synchronize" in e.name or e.name.startswith("cudaMemcpy"))

    plain = syncs(None)
    assert plain["cudaStreamSynchronize"] > 0
    assert syncs(bt.MetricsRecorder()) == plain
    timed = bt.MetricsRecorder(device_time=True)
    assert syncs(timed) == plain
    assert timed.summary()["spans"]["fastmnn/call"]["device_ms"] > 0


def _assert_knn_matches_tiled(idx, sq, q, x, k, valid):
    """K5's (idx, sq) against _knn_tiled's on the same card tensors. The
    rounding of a squared distance scales with its terms, |q|^2 + |x|^2:
    every distance agrees within 1e-5 of that scale, and the neighbour sets
    agree on every row whose k-th and (k+1)-th distances lie more than
    eight ulps (2^-20) of it apart."""
    want_i, want_sq = _knn_tiled(q, x, k + 1, valid)
    qn = (q.double() ** 2).sum(1, keepdim=True)
    scale = qn + (x.double() ** 2).sum(1)[want_i]
    assert idx.dtype == torch.long and sq.dtype == torch.float32
    assert idx.shape == sq.shape == (q.shape[0], k)
    assert bool(((sq.double() - want_sq[:, :k].double()).abs() <= 1e-5 * scale[:, :k]).all())
    assert bool(valid[idx].all())
    apart = (want_sq[:, k].double() - want_sq[:, k - 1].double()) > 2.0**-20 * scale[:, k - 1]
    assert bool(apart.float().mean() > 0.5)
    got_sets = idx[apart].sort(1).values
    want_sets = want_i[apart, :k].sort(1).values
    assert torch.equal(got_sets, want_sets)


@pytest.mark.parametrize("d", [2, 50, 100, 128])
@pytest.mark.parametrize("k", [1, 20, 64])
@pytest.mark.parametrize("nq,nd", [(1000, 3001), (77, 100), (300, 20_000)])
def test_knn_exact_kernel_matches_tiled(d, k, nq, nd, card):
    # ragged nq and nd; nd = 100 is less than one data tile; 300 x 20,000
    # splits the data rows into ranges
    q = torch.randn(nq, d, device="cuda", generator=card)
    x = torch.randn(nd, d, device="cuda", generator=card)
    valid = torch.ones(nd, device="cuda", dtype=torch.bool)
    before = knn_exact_cuda.knn_exact.launches
    idx, sq = knn_exact_cuda.knn_exact(q, x, k, valid)
    torch.cuda.synchronize()
    assert knn_exact_cuda.knn_exact.launches == before + 1
    _assert_knn_matches_tiled(idx, sq, q, x, k, valid)


@pytest.mark.parametrize("d,offset", [(50, 1), (50, 2), (51, 0), (51, 3), (64, 1), (33, 2)])
def test_knn_exact_kernel_on_unaligned_data_and_odd_widths(d, offset, card):
    # data that starts 4, 8 or 12 bytes past a 16-byte boundary (a view into
    # a larger buffer) and odd widths: the tile copies' hand-copied ends and
    # the single-width products
    nq, nd, k = 333, 1999, 20
    buf = torch.randn(nd * d + 4, device="cuda", generator=card)
    x = buf[offset:offset + nd * d].view(nd, d)
    assert x.data_ptr() % 16 == 4 * offset % 16
    q = torch.randn(nq, d, device="cuda", generator=card)
    valid = torch.ones(nd, device="cuda", dtype=torch.bool)
    idx, sq = knn_exact_cuda.knn_exact(q, x, k, valid)
    _assert_knn_matches_tiled(idx, sq, q, x, k, valid)


@pytest.mark.parametrize("how", ["data_mask", "n_data_valid"])
def test_knn_exact_kernel_over_masked_data(how, card):
    nq, nd, d, k = 700, 5000, 50, 20
    q = torch.randn(nq, d, device="cuda", generator=card)
    x = torch.randn(nd, d, device="cuda", generator=card)
    if how == "data_mask":
        valid = torch.rand(nd, device="cuda", generator=card) < 0.4
        kw = {"data_mask": valid}
    else:
        valid = torch.arange(nd, device="cuda") < 3333
        kw = {"n_data_valid": 3333}
    before = knn_exact_cuda.knn_exact.launches
    res = query_knn(q, x, k, squared=True, **kw)
    assert knn_exact_cuda.knn_exact.launches == before + 1
    _assert_knn_matches_tiled(res.indices, res.distances, q, x, k, valid)


@pytest.mark.parametrize("k", [20, 21, 64])
def test_knn_exact_kernel_ties_go_to_the_lower_row(k, card):
    # every data row three times over (copies 2,000 and 4,000 rows apart),
    # so each neighbour comes with two exact ties; k = 20 cuts a group of
    # copies, which must keep its lower rows
    nb, d = 2000, 50
    base = torch.randn(nb, d, device="cuda", generator=card)
    x = torch.cat([base, base, base])
    q = base[:500] + 0.05 * torch.randn(500, d, device="cuda", generator=card)
    valid = torch.ones(3 * nb, device="cuda", dtype=torch.bool)
    idx, sq = knn_exact_cuda.knn_exact(q, x, k, valid)
    idx, sq = idx.cpu(), sq.cpu()
    for r in range(q.shape[0]):
        rows, dist = idx[r].tolist(), sq[r].tolist()
        for p in range(1, k):
            assert dist[p - 1] < dist[p] or (dist[p - 1] == dist[p] and rows[p - 1] < rows[p])
        by_base = {}
        for row, dv in zip(rows, dist):
            by_base.setdefault(row % nb, []).append((row, dv))
        for b, copies in by_base.items():
            assert len({dv for _, dv in copies}) == 1          # bit for bit
            assert sorted(row for row, _ in copies) == [b + nb * c for c in range(len(copies))]
    want_i, _ = _knn_tiled(q, x, k, valid)
    assert bool(((idx % nb) == (want_i.cpu() % nb)).float().mean() > 0.99)


def test_knn_exact_kernel_is_deterministic_and_plan_blind(card, monkeypatch):
    # the same bits on a repeat, and with the data rows in one range or many
    q = torch.randn(2000, 50, device="cuda", generator=card)
    x = torch.randn(30_000, 50, device="cuda", generator=card)
    valid = torch.rand(30_000, device="cuda", generator=card) < 0.9
    a = knn_exact_cuda.knn_exact(q, x, 20, valid)
    b = knn_exact_cuda.knn_exact(q, x, 20, valid)
    assert knn_exact_cuda.plan_ranges(2000, 30_000, 20, knn_exact_cuda._slots(0, 50, 20, 0))[0] > 1
    monkeypatch.setattr(knn_exact_cuda, "plan_ranges", lambda nq, nd, k, slots: (1, -(-nd // 128)))
    c = knn_exact_cuda.knn_exact(q, x, 20, valid)
    for other in (b, c):
        assert torch.equal(a[0], other[0]) and torch.equal(a[1], other[1])


@pytest.mark.parametrize("case", ["fp64", "k65", "d129"])
def test_exact_search_outside_k5_takes_the_tiled_path(case, card):
    dtype, k, d = torch.float32, 20, 50
    if case == "fp64":
        dtype = torch.float64
    elif case == "k65":
        k = 65
    else:
        d = 129
    q = torch.randn(300, d, device="cuda", generator=card, dtype=dtype)
    x = torch.randn(2000, d, device="cuda", generator=card, dtype=dtype)
    assert not knn_exact_cuda.takes(q.device, q.dtype, k, d)
    before = knn_exact_cuda.knn_exact.launches
    res = query_knn(q, x, k, squared=True)
    assert knn_exact_cuda.knn_exact.launches == before
    want_i, want_sq = _knn_tiled(q, x, k, torch.ones(2000, device="cuda", dtype=torch.bool))
    assert torch.equal(res.indices, want_i) and torch.equal(res.distances, want_sq)
    assert res.distances.dtype == (torch.float64 if case == "fp64" else torch.float32)


def test_exact_counters_of_a_fused_search(card):
    import batchelor_torch as bt

    nq = nd = 47_250
    d, k = 50, 20
    q = torch.randn(nq, d, device="cuda", generator=card)
    x = torch.randn(nd, d, device="cuda", generator=card)
    rec = bt.MetricsRecorder()
    with rec.activate():
        query_knn(q, x, k, method="exact")
    assert [r["name"] for r in rec.records] == ["knn/exact"]
    assert rec.summary()["counters"] == {
        "knn/exact/searches": 1.0, "knn/exact/fused": 1.0,
        "knn/exact/scores": float(nq * nd), "knn/exact/flops": float(2 * d * nq * nd),
        "knn/exact/bytes": float((nq + nd) * d * 4 + nq * k * 12)}


def _stable_local_linear(x, y, span):
    """The host smoother with tied means in a stable order, the order the
    card sorts them in (numpy's default sort leaves ties in no set order)."""
    from batchelor_torch.correct import diagnostics

    order = np.argsort(x, kind="stable")
    return diagnostics._sorted_local_linear(x[order], y[order], diagnostics._window(span, x.size))


def _k6_case(case):
    """(xs, ys, q, window) of one K6 case, numpy fp64, xs sorted (stable)."""
    rng = np.random.default_rng(61)
    n, window = 5000, 1500
    x = np.exp(rng.normal(size=n))
    if case == "tied_means":
        x = np.round(rng.uniform(0, 10, size=n), 1)        # 101 values, distinct ys
    elif case == "zero_weights":
        x = np.repeat([5.0, 6.0, 7.0], [60, 60, 80])        # windows all at one distance
        n, window = x.size, 40
    elif case == "window_2":
        window = 2
    elif case == "window_n":
        n, window = 700, 700
        x = x[:n]
    y = rng.normal(size=n) + np.log(x + 1.0)
    order = np.argsort(x, kind="stable")
    xs, ys = x[order], y[order]
    q = np.concatenate([x[:300], rng.uniform(xs[0], xs[-1], 300), xs[[0, -1]],
                        [xs[0] - 1.0, xs[0] - 1e-9, xs[-1] + 1e-9, xs[-1] + 50.0, 0.0, -3.0]])
    if case == "tied_means":
        q = np.concatenate([q, np.arange(0, 10.05, 0.1)])
    elif case == "zero_weights":
        q = np.array([3.0, 5.0, 5.5, 6.0, 6.5, 7.0, 9.0])
    elif case == "non_finite":
        q = np.concatenate([q, [np.nan, np.inf, -np.inf, np.nan]])
    return xs, ys, q, window


@pytest.mark.parametrize("case", ["random", "tied_means", "zero_weights", "window_2", "window_n",
                                  "non_finite"])
def test_trend_smooth_kernel_matches_plain(case, card):
    """K6 against the plain smoother on the same sorted points: within
    1e-10 of the scale of ys and of the value (sums in another order)."""
    from batchelor_torch.correct import diagnostics
    from batchelor_torch.ops import trend_cuda

    xs, ys, q, window = _k6_case(case)
    want = diagnostics._sorted_local_linear(xs, ys, window)(q)
    before = trend_cuda.local_linear.launches
    t = [torch.from_numpy(a).cuda() for a in (xs, ys, q)]
    got = trend_cuda.local_linear(*t, window)
    torch.cuda.synchronize()
    assert trend_cuda.local_linear.launches == before + 1
    assert got.dtype == torch.float64 and got.shape == q.shape and got.is_cuda
    got = got.cpu().numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    tol = 1e-10 * (np.abs(ys).max() + np.abs(want))
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize("case", ["parametric", "not_parametric", "few_positive", "one_finite",
                                  "none_finite", "non_finite_moments"])
def test_card_trend_fit_matches_host(case, card):
    """fit_trend_var on CUDA tensors against the host's numpy (ties in the
    card's stable order) on every branch, at queries inside, outside and
    beyond the data, non-finite ones too: within 1e-10 of the host trend's
    largest value, as CUDA float64."""
    from unittest import mock

    import batchelor_torch as bt
    from batchelor_torch.correct import diagnostics

    rng = np.random.default_rng(62)
    x = np.exp(rng.uniform(np.log(0.01), np.log(50.0), size=3000))
    y = 3.0 * x / (x**1.5 + 2.0) * np.exp(rng.normal(scale=0.2, size=3000))
    kw = {"parametric": case != "not_parametric"}
    if case == "few_positive":
        x[3:], kw = -x[3:], {"span": 0.5}
    elif case == "one_finite":
        x[1:] = np.nan
    elif case == "none_finite":
        y[:] = np.inf
    elif case == "non_finite_moments":
        x[::7], y[::11], y[::13] = np.nan, np.inf, 0.0
    q = np.concatenate([x[:500], [0.0, -1.0, 1e-6, 200.0, np.nan, np.inf, -np.inf]])
    with mock.patch.object(diagnostics, "_local_linear", _stable_local_linear):
        want = diagnostics.fit_trend_var(x, y, **kw)(q)
    rec = bt.MetricsRecorder()
    with rec.activate():
        fit = diagnostics.fit_trend_var(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda(), **kw)
        got = fit(torch.from_numpy(q).cuda())
    assert rec.counters == {"trend/card_fits": 1.0}
    assert got.is_cuda and got.dtype == torch.float64 and got.shape == q.shape
    got = got.cpu().numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-10 * max(np.abs(want).max(), 1e-300), case


@pytest.fixture(scope="module")
def counts_cell():
    """The scib_immune_human_counts configuration's counts on the card at one
    seed, and the configuration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gpubench import harness

    cell = harness.load_cell("scib_immune_human_counts.quick_correct")
    return cell.config, cell.entry.draw_counts(cell.config, 2**31 + 301, torch.device("cuda"))


def test_card_trend_fit_matches_host_on_the_cell(counts_cell):
    """The card's fit against the host's on each batch's own moments of the
    quick_correct cell: tech within 1e-10 of its RMS (ties in the card's
    stable order), and the same 2,000 HVGs as the host's as it stands."""
    from unittest import mock

    import batchelor_torch as bt
    from batchelor_torch.correct import diagnostics
    from batchelor_torch.ops.stats import GeneVarResult, combine_var, get_top_hvgs

    cfg, counts = counts_cell
    logs = bt.multi_batch_norm(counts, min_mean=float(cfg["min_mean"])).logcounts
    decs = {"card": [], "host": []}
    for lg in logs:
        mean, total = lg.mean(0), torch.var(lg, dim=0, correction=1)
        m, v = mean.cpu().numpy(), total.cpu().numpy()
        with mock.patch.object(diagnostics, "_local_linear", _stable_local_linear):
            want = diagnostics.fit_trend_var(m, v)(m)
        got = diagnostics.fit_trend_var(mean, total)(mean)
        assert got.is_cuda and got.dtype == torch.float64
        got = got.cpu().numpy()
        assert np.abs(got - want).max() <= 1e-10 * np.sqrt(np.mean(want**2))
        host = diagnostics.fit_trend_var(m, v)(m)
        for name, tech in (("card", got), ("host", host)):
            decs[name].append(GeneVarResult(mean=m, total=v, tech=tech, bio=v - tech))
    hvg_n = int(cfg["hvg_n"])
    card, host = (get_top_hvgs(combine_var(decs[k]), n=hvg_n) for k in ("card", "host"))
    assert len(card) == hvg_n and set(card.tolist()) == set(host.tolist())


def test_quick_correct_fits_every_trend_on_the_card(counts_cell):
    import batchelor_torch as bt

    cfg, counts = counts_cell
    rec = bt.MetricsRecorder()
    with rec.activate():
        res = bt.quick_correct(counts, hvg_n=int(cfg["hvg_n"]))
    assert rec.counters["trend/card_fits"] == len(counts) == 10
    assert "trend/host_fits" not in rec.counters
    fits = [r for r in rec.records if r["name"] == "trend/fit"]
    assert [r["attrs"]["path"] for r in fits] == ["card"] * 10
    assert all(r["attrs"]["genes"] == cfg["genes"] and r["attrs"]["window"] >= 2 for r in fits)
    assert res.dec.mean.dtype == res.dec.total.dtype == np.float32
    assert res.dec.tech.dtype == res.dec.bio.dtype == np.float64
    assert len(res.hvgs) == cfg["hvg_n"]
