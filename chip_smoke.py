#!/usr/bin/env python3
"""Smoke run of batchelor_torch on one CUDA card: the quickest proof that the
port builds, agrees with itself and runs its main path on the GPU.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:
  0. build every kernel under batchelor_torch/csrc (one nvcc per source,
     all started together);
  1. kernel K2 (topk_rows) against its plain version at the main path's
     shapes, with planted ties and -inf pads, and on rows with fewer finite
     entries than k, rows of 60,000 columns, ascending and all-equal rows,
     and cluster_mnn's narrow rows (5 and 33 columns, k = 1): identical
     values and indices;
  2. kernel K1 (chunk_max_scores) against its plain version in its three
     modes on the main path's data (N_d = 100352, dpad = 64, first 4096
     queries): |diff| <= 2^-20 * max|s| of the query column, and the bf16
     mode's result is the view of its query-major store; each mode's time
     over its library call's is printed;
  3. the main path: reduced_mnn on two batches of 100,000 x 50 fp32 cells
     (bench.py's simulation, seed 42), k = 20, knn_method="auto", with the
     launch counters showing that K1, K2 and K3 ran in the MNN searches and
     K5 in the tricube searches, its pairs against an
     "exact" run (pair-set Jaccard >= 0.97: bf16 selection loses near-ties)
     and finite corrected values;
  4. the card against the CPU at 2 x 5,000 cells ("exact"): identical pairs,
     corrected values within 1e-4;
  5. kernel K3 (rescore_subchunks) against its plain version on the main
     path's data and sub-chunk selection (100,000 queries, ks = 20, d = 50):
     the gather identical to the CPU's, scores within 2^-20 * max|s| of the
     row, and K2's top-k sets of both identical except on rows whose k-th
     and (k+1)-th plain scores are that close; the selection's bucket
     statistics (slots per sub-chunk, segments per 64-slot item); then the
     same bound with uniform ids over 196,608 sub-chunks (a 1.26 GB data3,
     past the L2) on 4,096 queries (too few slots a sub-chunk to sort: one
     warp a query) and 32,768 (sorted);
  6. the probe's measurement with the port: pass-1 selection with each
     precision and the recall of "high3" and "bf16" against "highest"
     through the exact rescore, on every 97th query; then kernel K4
     (pass1_scores) against its plain version in its three precisions at
     98304 x 98304, d = 50 (first 4096 queries, masked rows give -inf, and
     the bf16 mode's result is the view of its query-major store); each
     precision's time over its library call's (one torch.addmm a query
     block, then the 32-row max) is printed, and the bf16 call's device
     launches (the casts to bf16 and the kernel) are counted;
  7. the slice's path: fast_mnn from gene space on two batches of
     100,000 cells x 2,000 genes, d = 50, k = 20, knn_method="auto", with
     the launch counters showing K1, K2, K3 and K5 (the tricube searches), finite corrected values, an
     orthonormal rotation, and its pairs against an "exact" run: pair-set
     Jaccard >= 0.80 for "auto" (bf16 selection loses crowded neighbours)
     and >= 0.97 for "chunked" (fp32 selection: K1's split3 mode), which
     runs twice, its first run with the launch counters;
  8. the card against the CPU on bench.py config 3's options (4 batches x
     2,000 cells x 500 genes, merge tree, restrict, prop_k, randomized
     PCA): in fp64 identical pairs in every step and corrected within 1e-4
     up to the sign of each PCA column; in fp32, where the two devices'
     rounding moves the PCA's weakest directions, the agreement is printed;
  9. fused_merge_step on the main path's data with "auto" and "exact",
     against reduced_mnn with the same method: identical pair sets and
     n_pairs, batch_size within 1e-5 relative, and under "exact" corrected
     values within 1e-4 x max|corrected| on >= 99.9% of rows (the rows
     beyond are printed: a tricube neighbour tie can fall either way; under
     "auto" they are printed only); the launch counters show K1, K2 and K3
     in the "auto" step and K5 in the "exact" one; a further "auto" call runs under
     torch.cuda.set_sync_debug_mode("error"), which raises at any sync with
     the host; then the step and reduced_mnn under torch.profiler (wall and
     device ms, idle share, device launches);
 10. mnn_correct (classic mnnCorrect, bench.py config 2's options: sigma =
     0.1, var_adj, cosine normalization) on 2 x 10,000 cells x 2,000 genes
     (log1p of the simulation's magnitudes), first and second call, K2 on
     the launch counter; then the card against the CPU at 2 x 1,000 x 500
     with svd_dim = 2, and with subset_row + correct_all + out_on_host
     (whose result stays on the host): in fp64 identical pairs and within
     1e-4 x max|corrected|; in fp32 the same where the pairs are identical,
     else the agreement is printed (a near-tied pair can come and go);
 11. checkpoints: reduced_mnn on 3 x 20,000 x 50 ("auto") with
     checkpoint_dir under build/, its last step's files deleted, then run
     again: the resumed result within 1e-6 x max|corrected| of the
     uninterrupted one, with identical pairs;
 12. quick_correct on raw counts, 2 x 100,000 cells x 5,000 genes drawn on
     the card (Poisson of the simulation's log-means, 4 cell types, batch 2
     shifted), hvg_n = 2,000, FastMNNParams(d=50, knn_method="auto"),
     correct_all: first and second call with the seconds of its
     normalization, variance model and correction, K1, K2, K3, K5 and K6
     (the trend fits) on the launch counters, one call profiled; then the
     card against the CPU at 2 x 2,000 x 500 in fp64: the same HVGs,
     identical pairs, corrected within 1e-6 x max|corrected| after sign
     alignment;
 13. cluster_mnn on bench.py config 4's atlas (8 x 100,000 cells x 500
     genes, log1p |x| of the simulation, its labels as clusters): first
     and second call, K5 on the launch counter (the nearest-centroid
     searches, k = 1 over the centroids' PCs), one call profiled; the
     k-means path (clusters=4) on 2 of the batches; then the card against
     the CPU at 8 x 2,000 x 100 in fp64: the same centroid pairs (the
     centroids at one position, an exact tie, taken as one), the same
     cluster_meta, corrected within 1e-6 in gene space;
 14. batch_correct with RescaleParams, RegressParams(d=50) and
     NoCorrectParams on phase 12's 2 x 100,000 x 2,000 HVG log-expression,
     mnn_delta_variance over its pairs, cluster_abundance_test and _var on
     phase 13's 800,000 labels, each timed; then each card against CPU in
     fp64 at a small size (1e-10; the abundance statistics 1e-12);
 15. out of core: raw counts 2 x 100,000 cells x 5,000 genes drawn on the
     card with phase 12's generator, every log-mean lowered by 3.25 (5-10%
     nonzero, droplet density), converted on the card to host CSRCells;
     quick_correct_csr (hvg_n = 2,000, d = 50, k = 20, "auto", min_mean =
     0.1 for UMI counts) first and second call with its quickcsr/* spans,
     K1, K2, K3 and K5 on the launch counters, one call profiled, beside the
     dense quick_correct on the same counts (HVG overlap, pair Jaccard,
     and the pair Jaccard with an exact PCA of the HVG stores in place of
     the randomized one that quick_correct_csr takes above 1,024 genes,
     at least 0.95);
     multi_batch_pca_csr as it runs (the nonzeros shipped, "sparse") and on
     host-densified blocks ("dense") bit-identical and timed in turns on the HVG stores and on 100,000 x 2,000 stores at
     25%, 50%, 75% and 100% density, with each mode's host-to-device bytes;
     mnn_correct_csr (2 x 10,000 x 2,000, subset_row, then correct_all on
     the host), cluster_mnn_csr with the simulation's labels,
     rescale_batches_csr, regress_batches_csr and mnn_delta_variance_blocked
     on CSR input, each timed with its launches; the card against the CPU at
     2 x 2,000 x 500 (~10%): device_dense_blocks bit for bit, the same HVGs,
     a pair Jaccard of at least 0.999, every row with the same pairs and
     tricube neighbours within 1e-4 x max in gene space, the others (the
     eigensolvers place near-equal PCA directions ~1e-4 apart, which moves
     a tricube neighbour at a near-tie, and its cell, as in phase 9) at
     most 0.1% of rows and within 0.05; the CPU's merge on the card's PCA stage (pca_cache_dir):
     identical pairs, every row within 1e-4 x max; the same cluster_meta;
     and
     python -m batchelor_torch import-dense, info and quick-correct in a
     subprocess, its corrected.npy within 1e-6 x max|corrected| of an
     in-process call with the same HVGs and pair counts;
 16. the parallel layer over a real NCCL group of one rank (a FileStore
     under build/, no torchrun; make_cells_mesh(2) must raise):
     distributed_fast_mnn on BASELINE.md config 4's atlas, 8 x 125,000 x 50
     (bench.py's shifts 0.3 i, seed 42), k = 20, "exact", in the "gather"
     and "ring" memory modes (first call, second call, one profiled call
     with its NCCL kernels' ms), K5 on the launch counter (and K2 in the
     ring's running merge); the gated calls
     run with deterministic algorithms. Gates: gather, ring and the same
     call without a process group agree exactly (identical pairs in every
     step, every row within 1e-4 x its max, lost variance within 1e-5);
     against reduced_mnn "exact" the same merge order and batches, pair
     Jaccard >= 0.99 in every step and lost variance within 1e-3 (at 8
     batches the reference parts from itself as far when its inputs move
     one ulp up, printed); against reduced_mnn on those moved inputs, and
     on the 3-batch prefix (375,000 cells) against reduced_mnn, identical
     pairs in every step, rows within 1e-4 x their max on >= 99.9% and lost
     variance within 1e-5. Then "auto"
     (K1, K2 and K3 on the counters, pair Jaccard >= 0.99 against
     reduced_mnn "auto" in the first step, whose searches both engines
     run on the same inputs; the run's Jaccard printed); a checkpointed
     3 x 20,000 run interrupted after
     its first step and resumed, bit for bit; quick_correct_csr(mesh=) on
     phase 15's stores against the call without a mesh ("exact"):
     identical pairs, rows within 1e-4 x their max on >= 99.9%;
 17. kernel K5 (knn_exact, the exact search on the card) against its plain
     version (knn._knn_tiled) on the same card tensors at the
     hca_bone_marrow atlas's shapes: 8 x 47,250 x 50 cells of the
     simulation (shifts 0.3 i), k = 20, the last merge step both ways
     (47,250 x 330,750 and 330,750 x 47,250) and its tricube search
     (47,250 queries over 36,000 of the left's cells): the same neighbours
     on every row whose k-th and (k+1)-th plain distances lie more than
     2^-20 of their terms apart, every distance within 1e-5 of its terms;
     each shape's ms, the plain version's and the bound by fp32 FMAs;
 18. kernel K6 (trend_cuda.local_linear, the trend fit's smoother on the
     card) against its plain version (diagnostics._sorted_local_linear)
     on the same sorted points: each batch's smoothed log-ratio as the
     card's fit_trend_var makes it from the moments of phase 12's
     normalized counts (~5,000 points, W ~1,500) and of 2 x 5,000 cells
     x 12,303 genes (the scib_immune_human_counts cell's width, W ~3,690),
     queried at every gene's mean and at tied, out-of-range and
     non-finite values: within 1e-10 of max |ys| + |plain|; each
     shape's ms, the plain version's (host numpy), the same chunked
     smoother in torch on the card, and the bound by fp64 flops.
It prints each phase's seconds, the build time, one {"kernels": [...]} line with each kernel's
launches on each path, times (median of CUDA-event timings), bound and
library yardstick, one line for each path's seconds, the card's name and
power limit, and last {"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout of the repository, it
exits non-zero and prints no result.
"""
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

N_CELLS = 100_000
DIMS = 50
K = 20
SEED = 42
GENES = 2_000                  # fast_mnn's and mnn_correct's gene-space width (7, 10)
CLASSIC_N = 10_000             # mnn_correct's cells a batch (phase 10)
CKPT_N = 20_000                # checkpointed reduced_mnn's cells a batch (phase 11)
PROBE_N = 98_304               # knn_pass1_precision_probe.py's N
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor-core peak, same source
FP32_FLOP_PER_S = 67e12        # fp32 outside the tensor cores, same source
FP64_FLOP_PER_S = 33.5e12      # fp64 outside the tensor cores, same source
K1_TOL = 2.0 ** -20
PAIR_JACCARD_MIN = 0.97
FAST_AUTO_JACCARD_MIN = 0.80   # bf16 selection on fast_mnn's crowded PCs (phase 7)
TWO_PASS = ("chunk_max_scores", "topk_rows", "rescore_subchunks")   # K1, K2, K3


def simulate(rng, n, g, shift=0.0, n_types=4, noise=0.5, labels=False):
    """Cells from a few types plus noise and a batch shift (bench.py::_simulate);
    with ``labels`` also each cell's type."""
    import numpy as np

    means = rng.normal(size=(n_types, g)).astype(np.float32)
    assign = rng.integers(0, n_types, n)
    x = means[assign] + rng.normal(size=(n, g)).astype(np.float32) * noise
    if shift:
        x = x + (rng.normal(size=(1, g)) * shift).astype(np.float32)
    return (x.astype(np.float32), assign) if labels else x.astype(np.float32)


def cuda_ms(torch, fn, reps):
    """Median milliseconds of ``fn`` by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_kernels(torch, fn, reps):
    """The kernels and memsets that one call of ``fn`` runs on the card, by
    torch.profiler over ``reps`` calls after a warm-up: name -> [runs a
    call, device ms a call]."""
    act = torch.profiler.ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.name.replace("(anonymous namespace)::", "").split("(")[0]
        runs, ms = out.get(name, [0.0, 0.0])
        out[name] = [runs + 1 / reps, ms + evt.time_range.elapsed_us() / reps / 1e3]
    return out


def k3_launches(torch, fn):
    """{device launches of one K3 call, the names of its kernels and memsets,
    the path they show}, measured by torch.profiler; fails unless there are
    1 to 4 launches."""
    kernels = device_kernels(torch, fn, 5)
    launches = round(sum(runs for runs, _ in kernels.values()))
    path = ("sorted" if "rescore_kernel" in kernels
            else "by_query" if "by_query_kernel" in kernels else "unknown")
    check(1 <= launches <= 4,
          f"K3: {launches} device launches a call, path {path} ({sorted(kernels)})")
    return {"device_launches_per_call": launches, "device_kernels": sorted(kernels),
            "path": path}


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


# (rows, width, k): the main path's four shapes, then cluster_mnn's
# nearest-centroid search (k = 1 over the running best and 4 centroids, in
# 16,384-row query tiles) and a width past one warp's 32 lanes
K2_TIMED = ((100352, 3136, K), (100000, 640, K), (16384, 8212, K), (16384, 640, K),
            (16384, 5, 1), (100000, 33, 1))


def k2_input(torch, gen, n, w):
    """K2's timed input: normal rows with planted ties and -inf pad columns
    (narrow rows: a tie of the first and last column, and -inf rows)."""
    x = torch.randn(n, w, device="cuda", generator=gen)
    if w < 64:
        x[::3, w - 1] = x[::3, 0]
        x[1::5] = float("-inf")
        return x
    x[:, [7, 100, w - 40]] = 6.0                          # planted ties
    x[::7, 11] = 6.0
    x[:, w - 30:] = float("-inf")                          # pad columns
    return x


def k2_bound_ms(n, w, k):
    """Each row read once, k values and columns written, at HBM's rate."""
    return (n * w * 4 + n * k * 8) / HBM_BYTES_PER_S * 1e3


def phase_k2(torch, topk_cuda):
    """K2 against its plain version; returns the kernel's entry."""
    print("phase 1: topk_rows (K2) against its plain version", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entries = []
    max_err = 0.0
    few = torch.full((8, 200), float("-inf"), device="cuda")
    few[:, 7], few[:, 5] = 2.0, 1.0                      # fewer finite than k
    wide = torch.randn(8, 60000, device="cuda", generator=gen)
    wide[:, 50000:] = 4.0                                 # ties past the old width cap
    ascending = torch.arange(3136, device="cuda", dtype=torch.float32).repeat(4, 1)
    cases = [(few, 4), (wide, K), (wide, 64), (ascending, K),
             (torch.ones(5, 3136, device="cuda"), 64)]
    cases += [(k2_input(torch, gen, n, w), k) for n, w, k in K2_TIMED]
    for x, k in cases:
        v, i = topk_cuda.topk_rows(x, k)
        pv, pi = topk_cuda.topk_rows_plain(x, k)
        torch.cuda.synchronize()
        check(torch.equal(v, pv) and torch.equal(i, pi),
              f"K2 {tuple(x.shape)} k={k}: values and indices identical")
        max_err = max(max_err, float((v - pv).abs().nan_to_num(0.0).max()))
        if (*x.shape, k) not in K2_TIMED:
            continue
        n, w = x.shape
        entries.append({
            "shape": [n, w], "k": k,
            "ms": cuda_ms(torch, lambda: topk_cuda.topk_rows(x, k), 10),
            "plain_ms": cuda_ms(torch, lambda: topk_cuda.topk_rows_plain(x, k), 3),
            "library_ms": cuda_ms(torch, lambda: torch.topk(x, k, dim=1), 10),
            "bound_ms": k2_bound_ms(n, w, k),
        })
    main = entries[0]
    return {
        "name": "topk_rows", "route": "cuda", "source": "batchelor_torch/csrc/topk_rows.cu",
        "replaces": "batchelor_tpu/ops/topk_pallas.py:28",
        "launches": None, "max_abs_err": max_err,
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes", "library_ms": main["library_ms"],
        "shape": main["shape"], "other_shapes": entries[1:],
    }


def phase_k1(torch, knn_cuda, b1, b2):
    """K1 against its plain version in all three modes; returns its entry."""
    print("phase 2: chunk_max_scores (K1) against its plain version", flush=True)
    from batchelor_torch.device import full_fp32_matmul

    query = torch.from_numpy(b1).cuda()
    data = torch.from_numpy(b2).cuda()
    valid = torch.ones(data.shape[0], dtype=torch.bool, device="cuda")
    modes = {}
    max_err = 0.0
    for mode in ("bf16", "fp32", "six_pass"):
        q, x = knn_cuda._pass1_operands(query, data, valid, bf16=mode == "bf16")
        six = mode == "six_pass"
        nq, dp = q.shape
        nd = x.shape[0]
        check(nd == 100352 and dp == 64, f"K1 {mode}: N_d={nd}, dpad={dp}")
        got = knn_cuda.chunk_max_scores(q[:4096], x, six)
        want = knn_cuda.chunk_max_scores_plain(q[:4096], x, six)
        if mode == "bf16":              # stored query-major, returned as its (N_d/32, N_q) view
            check(got.t().is_contiguous(), "K1 bf16: the result is the view of a query-major matrix")
        sentinel = want.abs() > 1e29
        scale = torch.where(sentinel, 0.0, want.abs()).amax(0, keepdim=True)
        bound = torch.where(sentinel, want.abs(), scale) * K1_TOL
        diff = (got - want).abs()
        rel = float((diff / torch.where(sentinel, want.abs(), scale)).max())
        check(bool((diff <= bound).all()),
              f"K1 {mode}: |diff| <= 2^-20 max|s| (worst {rel:.3g} of max|s|)")
        products = {"bf16": 1, "fp32": 3, "six_pass": 6}[mode]
        flops = 2.0 * nq * nd * dp * products
        nbytes = (nq + nd) * dp * q.element_size() + (nd // 32) * nq * 4
        t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        reps = 5 if mode == "bf16" else 3
        entry = {
            "ms": cuda_ms(torch, lambda: knn_cuda.chunk_max_scores(q, x, six), reps),
            "plain_ms": cuda_ms(torch, lambda: knn_cuda.chunk_max_scores_plain(q, x, six), 3),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": float(diff.max()), "max_rel_err": rel,
        }
        if mode != "six_pass":          # six_pass has fp32's operands and yardstick
            def library():
                with full_fp32_matmul():        # fp32 operands: no TF32
                    for q0 in range(0, nq, 8192):
                        (x @ q[q0:q0 + 8192].T).view(nd // 32, 32, -1).amax(1)
            library_ms = cuda_ms(torch, library, 3)
        entry["library_ms"] = library_ms
        ratio = entry["ms"] / library_ms
        if mode != "bf16":
            entry["ms_over_library"] = ratio
        print(f"  K1 {mode}: {entry['ms']:.3f} ms, library {library_ms:.3f} ms, "
              f"ratio {ratio:.3f}", flush=True)
        modes[mode] = entry
        max_err = max(max_err, entry["max_abs_err"])
        del q, x, got, want
    main = modes["bf16"]                  # the mode "auto" takes on the main path
    return {
        "name": "chunk_max_scores", "route": "cuda", "source": "batchelor_torch/csrc/chunk_max.cu",
        "replaces": "batchelor_tpu/ops/knn_pallas.py:68",
        "launches": None, "max_abs_err": max_err,
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "shape": [100352, 100352, 64], "modes": modes,
    }


def pair_set(info, n):
    p = info.pairs.astype("int64")
    return p[:, 0] * n + p[:, 1]


def zero_counts(wrappers):
    for w in wrappers:
        w.launches = 0


def read_counts(wrappers):
    return {w.__name__: w.launches for w in wrappers}


def ran(launches, names):
    """Whether each of the kernels ``names`` launched."""
    return all(launches[n] > 0 for n in names)


def phase_main_path(torch, np, bt, path_kernels, b1, b2):
    """reduced_mnn at 2 x 100k; returns (launch counts, seconds, pairs)."""
    print("phase 3: reduced_mnn, 2 x 100,000 x 50, k=20, knn_method='auto'", flush=True)
    batches = [torch.from_numpy(b).cuda() for b in (b1, b2)]
    torch.cuda.synchronize()
    zero_counts(path_kernels)
    t0 = time.perf_counter()
    res = bt.reduced_mnn(batches, k=K, knn_method="auto")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(path_kernels)
    check(ran(launches, TWO_PASS + ("knn_exact",)),
          f"K1, K2 and K3 ran, and K5 in the tricube searches: {launches}")
    check(tuple(res.corrected.shape) == (2 * N_CELLS, DIMS)
          and bool(torch.isfinite(res.corrected).all()), "corrected is finite, (200000, 50)")
    t0 = time.perf_counter()
    again = bt.reduced_mnn(batches, k=K, knn_method="auto")
    torch.cuda.synchronize()
    seconds_again = time.perf_counter() - t0
    check(np.array_equal(again.merge_info[0].pairs, res.merge_info[0].pairs),
          "a second run gives the same pairs")
    exact = bt.reduced_mnn(batches, k=K, knn_method="exact")
    a, b = pair_set(res.merge_info[0], 2 * N_CELLS), pair_set(exact.merge_info[0], 2 * N_CELLS)
    jaccard = np.intersect1d(a, b).size / np.union1d(a, b).size
    # bf16 selection errs by ~2^-8 of the score magnitude (|x|^2 ~ 60 on
    # this uncentred simulation) and swaps neighbours near the k-th; the
    # reference's bf16 search makes the same products (K1's bf16 kernel,
    # wgmma with fp32 sums, holds its plain version within 2^-20 of the
    # column's max |s| in phase 2). Measured Jaccard on an H100: 0.97996.
    check(jaccard >= PAIR_JACCARD_MIN,
          f"pairs vs knn_method='exact': Jaccard {jaccard:.5f} >= {PAIR_JACCARD_MIN}")
    return launches, seconds, seconds_again, int(a.size), int(b.size), jaccard


def phase_card_vs_cpu(torch, np, bt):
    print("phase 4: the card against the CPU, 2 x 5,000 cells, 'exact'", flush=True)
    rng = np.random.default_rng(SEED)
    b = [simulate(rng, 5000, DIMS), simulate(rng, 5000, DIMS, shift=0.8)]
    gpu = bt.reduced_mnn(b, k=K, knn_method="exact")
    cpu = bt.reduced_mnn(b, k=K, knn_method="exact", device="cpu")
    check(np.array_equal(gpu.merge_info[0].pairs, cpu.merge_info[0].pairs),
          f"identical pairs ({cpu.merge_info[0].pairs.shape[0]})")
    err = float((gpu.corrected.cpu() - cpu.corrected).abs().max())
    check(err <= 1e-4, f"corrected within 1e-4 (max |diff| {err:.3g})")


def row_scale(torch, want, dim):
    """max |want| along ``dim`` over the finite entries, for the 2^-20 bounds."""
    return torch.where(torch.isinf(want), 0.0, want.abs()).amax(dim, keepdim=True)


def finite_diff(torch, got, want):
    """|got - want| with both infinite entries counted as 0; fails unless
    the infinite entries are the same -inf entries."""
    inf = torch.isinf(want)
    check(torch.equal(inf, torch.isinf(got)) and bool((got[inf] < 0).all())
          and bool((want[inf] < 0).all()), "the same entries are -inf")
    return torch.where(inf, 0.0, got) - torch.where(inf, 0.0, want)


K3_WIDE_C32 = 196_608          # 6.3M data rows: data3 of 1.26 GB, past the 50 MB L2


def k3_bound_ms(nq, ks, d, uniq):
    """(bound ms, what bounds it): the selected sub-chunks and their norms,
    the ids and the queries read once, the scores written once, against
    2 nq ks 32 d fp32 flop outside the tensor cores."""
    nbytes = uniq * 32 * d * 4 + uniq * 32 * 4 + nq * ks * 8 + nq * d * 4 + nq * ks * 32 * 4
    t_ops = 2.0 * nq * ks * 32 * d / FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def k3_bucket_stats(torch, top_sub, c32, p):
    """Slots per sub-chunk over all c32 sub-chunks (empty ones included), and
    the segments (runs of one sub-chunk) in each p-slot item of the sorted
    slots, as the kernel cuts them (p: rescore_cuda.kernel_plan's)."""
    sizes = torch.bincount(top_sub.flatten(), minlength=c32)
    f = sizes.double()
    nz = sizes > 0
    start = (torch.cumsum(sizes, 0) - sizes)[nz]
    items = -(-top_sub.numel() // p)
    seg = torch.zeros(items + 1, dtype=torch.long, device=top_sub.device)
    ones = torch.ones_like(start)
    seg.index_add_(0, start // p, ones)
    seg.index_add_(0, (start + sizes[nz] - 1) // p + 1, -ones)
    seg = seg.cumsum(0)[:items]
    return {"sub_chunks": c32, "mean": top_sub.numel() / c32, "unique": int(nz.sum()),
            "median": float(torch.quantile(f, 0.5)),
            "p99": float(torch.quantile(f, 0.99)), "max": int(sizes.max()),
            "items": items, "segments_per_item_max": int(seg.max()),
            "segments_per_item_mean": float(seg.double().mean())}


def k3_wide_inputs(torch, gen, nq, ks=K, d=DIMS, c32=K3_WIDE_C32):
    """q, data3, dn2 (rows 3..8 of sub-chunk 1 masked) and uniform ids over
    c32 sub-chunks: each sub-chunk chosen nq * ks / c32 times on average."""
    q = torch.randn(nq, d, device="cuda", generator=gen)
    data3 = torch.randn(c32, 32, d, device="cuda", generator=gen)
    dn2 = (data3 * data3).sum(2)
    dn2[1, 3:9] = float("inf")
    top_sub = torch.randint(0, c32, (nq, ks), device="cuda", generator=gen)
    top_sub[::50, 0] = 1
    return q, data3, dn2, top_sub


def phase_k3(torch, knn_cuda, rescore_cuda, topk_cuda, b1, b2):
    """K3 against its plain version on the main path's data; returns its entry."""
    print("phase 5: rescore_subchunks (K3) against its plain version", flush=True)
    query = torch.from_numpy(b1).cuda()
    data = torch.from_numpy(b2).cuda()
    valid = torch.ones(data.shape[0], dtype=torch.bool, device="cuda")
    m_t = knn_cuda._prep_pass1(query, data, valid, bf16=True)
    top_sub = knn_cuda._select_subchunks(m_t, K)[:query.shape[0]].contiguous()
    del m_t
    data3, dn2 = knn_cuda._chunked_view(data, valid)
    nq, ks = top_sub.shape
    d = data3.shape[2]
    check((nq, ks, d) == (N_CELLS, K, DIMS), f"K3 inputs: nq={nq}, ks={ks}, d={d}")
    part = top_sub[:4096]
    check(torch.equal(rescore_cuda.gather_subchunks_plain(part, data3).cpu(),
                      data3.cpu()[part.cpu()]), "K3 gather: card equals CPU on 4096 queries")
    got = rescore_cuda.rescore_subchunks(query, data3, dn2, top_sub)
    want = rescore_cuda.rescore_subchunks_plain(query, data3, dn2, top_sub)
    torch.cuda.synchronize()
    scale = row_scale(torch, want, 1)
    diff = finite_diff(torch, got, want).abs()
    rel = float((diff / scale).max())
    check(bool((diff <= K1_TOL * scale).all()),
          f"K3: |diff| <= 2^-20 max|s| of the row (worst {rel:.3g} of max|s|)")
    pv, pi = topk_cuda.topk_rows(want, K + 1)
    _, gi = topk_cuda.topk_rows(got, K)
    near = (pv[:, :-1] - pv[:, 1:]) <= K1_TOL * scale   # consecutive plain gaps
    kth_tie = near[:, K - 1]
    other_set = (gi.sort(1)[0] != pi[:, :K].sort(1)[0]).any(1)
    other_order = (gi != pi[:, :K]).any(1)
    kth_ties = int(kth_tie.sum())
    check(not bool((other_set & ~kth_tie).any()),
          f"K3: K2's top-{K} sets identical on every row but the {kth_ties} rows whose "
          f"plain k-th and (k+1)-th scores are within 2^-20 max|s| "
          f"({int(other_set.sum())} rows differ)")
    check(not bool((other_order & ~near.any(1)).any()),
          f"K3: K2's top-{K} order identical on every row without a near-tie "
          f"({int(other_order.sum())} rows differ, {int(near.any(1).sum())} rows hold a near-tie)")
    _, p = rescore_cuda.kernel_plan(nq, ks, data3.shape[0])
    buckets = k3_bucket_stats(torch, top_sub, data3.shape[0], p)
    print(f"  K3 buckets: {buckets}", flush=True)
    plan = k3_launches(torch, lambda: rescore_cuda.rescore_subchunks(query, data3, dn2, top_sub))
    bound_ms, bound_by = k3_bound_ms(nq, ks, d, buckets["unique"])
    wide = phase_k3_wide(torch, rescore_cuda)
    return {
        "name": "rescore_subchunks", "route": "cuda",
        "source": "batchelor_torch/csrc/rescore_chunks.cu",
        "replaces": "benchmarks/knn_dma_rescore_probe.py:43",
        "launches": None, "max_abs_err": float(diff.max()), "max_rel_err": rel,
        "ms": cuda_ms(torch, lambda: rescore_cuda.rescore_subchunks(query, data3, dn2, top_sub), 10),
        "plain_ms": cuda_ms(torch, lambda: rescore_cuda.rescore_subchunks_plain(
            query, data3, dn2, top_sub), 3),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "library_none_because": "no single PyTorch call gathers rows by block id and "
                                "rescores them; the plain version is the gather + bmm it replaces",
        "shape": [nq, ks, d], **plan, "slots_per_item": p, "buckets": buckets,
        "unique_subchunks": buckets["unique"], "kth_near_tie_rows": kth_ties, "wide": wide,
    }


def phase_k3_wide(torch, rescore_cuda):
    """K3 against its plain version over 196,608 sub-chunks: 4,096 queries
    (0.4 slots a sub-chunk: one warp a query) and 32,768 (3.3: sorted)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    wide = []
    for n in (4096, 32768):
        q, data3, dn2, top_sub = k3_wide_inputs(torch, gen, n)
        nq, ks = top_sub.shape
        got = rescore_cuda.rescore_subchunks(q, data3, dn2, top_sub)
        want = rescore_cuda.rescore_subchunks_plain(q, data3, dn2, top_sub)
        torch.cuda.synchronize()
        scale = row_scale(torch, want, 1)
        diff = finite_diff(torch, got, want).abs()
        rel = float((diff / scale).max())
        _, p = rescore_cuda.kernel_plan(nq, ks, K3_WIDE_C32)
        buckets = k3_bucket_stats(torch, top_sub, K3_WIDE_C32, p)
        plan = k3_launches(torch, lambda: rescore_cuda.rescore_subchunks(q, data3, dn2, top_sub))
        check(bool((diff <= K1_TOL * scale).all()),
              f"K3 wide ({nq} queries, {K3_WIDE_C32} sub-chunks, {plan['path']}): "
              f"|diff| <= 2^-20 max|s| of the row (worst {rel:.3g} of max|s|)")
        bound_ms, bound_by = k3_bound_ms(nq, ks, DIMS, buckets["unique"])
        entry = {"shape": [nq, ks, DIMS, K3_WIDE_C32], "max_abs_err": float(diff.max()),
                 "max_rel_err": rel,
                 "ms": cuda_ms(torch, lambda: rescore_cuda.rescore_subchunks(
                     q, data3, dn2, top_sub), 10),
                 "plain_ms": cuda_ms(torch, lambda: rescore_cuda.rescore_subchunks_plain(
                     q, data3, dn2, top_sub), 3),
                 "bound_ms": bound_ms, "bound_by": bound_by, **plan, "buckets": buckets}
        print(f"  K3 wide, {nq} queries: {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, "
              f"bound {bound_ms:.4f} ms", flush=True)
        wide.append(entry)
        del q, data3, dn2, top_sub, got, want
    return wide


def k4_bf16_library(torch, q, x, neg_dn, query_block=8192):
    """K4 bf16's library yardstick: q and x rounded to bf16, then per query
    block one torch.addmm of 2 x.q - dn in bf16 and the 32-row max."""
    xl, ql = x.to(torch.bfloat16), q.to(torch.bfloat16)
    bias = neg_dn.to(torch.bfloat16)
    for q0 in range(0, q.shape[0], query_block):
        s = torch.addmm(bias, xl, ql[q0:q0 + query_block].T, alpha=2.0)
        s.view(x.shape[0] // 32, 32, -1).amax(1)


def phase_k4(torch, np, knn_cuda, pass1_cuda):
    """K4's probe measurement with the port, then K4 against its plain
    version; returns (its entry, the probe measurement)."""
    print("phase 6: pass1_scores (K4): the precision probe, then against its plain version",
          flush=True)
    from batchelor_torch.device import full_fp32_matmul

    rng = np.random.default_rng(0)                  # the probe's seed and data
    query = torch.from_numpy(rng.normal(size=(PROBE_N, DIMS)).astype(np.float32)).cuda()
    data = torch.from_numpy(rng.normal(size=(PROBE_N, DIMS)).astype(np.float32)).cuda()
    valid = torch.ones(PROBE_N, dtype=torch.bool, device="cuda")
    data3, dn2 = knn_cuda._chunked_view(data, valid)
    max_bytes = knn_cuda.default_max_bytes(query.device)

    # the probe's path: select with each precision, rescore exactly
    zero_counts([pass1_cuda.pass1_scores])
    q, x, dn = pass1_cuda.pass1_operands(query, data, valid)
    full = {}
    for prec in ("highest", "high3", "bf16"):
        m_t = pass1_cuda.pass1_scores(q, x, dn, prec)
        top_sub = knn_cuda._select_subchunks(m_t, K)[:PROBE_N].contiguous()
        del m_t
        full[prec] = knn_cuda._rescore_chunks(query, data3, dn2, top_sub, K, True, max_bytes)
    torch.cuda.synchronize()
    launches = read_counts([pass1_cuda.pass1_scores])["pass1_scores"]
    check(launches == 3, f"K4 ran once per precision on the probe's path ({launches})")
    ref_i, ref_sq = (t[::97].cpu().numpy() for t in full["highest"])
    probe = {}
    for prec in ("high3", "bf16"):
        idx, sq = (t[::97].cpu().numpy() for t in full[prec])
        recall = float(np.mean([len(set(a) & set(b)) / K for a, b in zip(ref_i, idx)]))
        gap = float(np.max(np.abs(np.sqrt(ref_sq) - np.sqrt(sq))))
        probe[prec] = {"recall_vs_highest": recall, "max_dist_gap": gap}
        print(f"  {prec} vs highest selection: recall {recall:.6f}, max |d| gap {gap:.3e}",
              flush=True)
    check(probe["high3"]["recall_vs_highest"] >= 0.999, "high3 selection recall >= 0.999")
    del full

    # the kernel against its plain version, with masked rows
    masked = valid.clone()
    masked[1000:1100] = False                         # sub-chunks 32 and 33 fully masked
    qm, xm, dnm = pass1_cuda.pass1_operands(query, data, masked)
    nq, dp = qm.shape
    nd = xm.shape[0]
    check((nq, nd, dp) == (PROBE_N, PROBE_N, 64), f"K4 operands: {nq} x {nd} x {dp}")
    modes, max_err = {}, 0.0
    lib_fp32 = lib_bf16 = None
    neg_dn = -dnm[:, None]              # masked rows: -inf
    for prec in ("bf16", "high3", "highest"):
        got = pass1_cuda.pass1_scores(qm[:4096], xm, dnm, prec)
        want = pass1_cuda.pass1_scores_plain(qm[:4096], xm, dnm, prec)
        torch.cuda.synchronize()
        scale = row_scale(torch, want, 0)
        diff = finite_diff(torch, got, want).abs()
        check(bool(torch.isinf(want[32:34]).all()), f"K4 {prec}: masked sub-chunks are -inf")
        if prec == "bf16":              # stored query-major, returned as its (N_d/32, N_q) view
            check(got.t().is_contiguous(), "K4 bf16: the result is the view of a query-major matrix")
        rel = float((diff / scale).max())
        check(bool((diff <= K1_TOL * scale).all()),
              f"K4 {prec}: |diff| <= 2^-20 max|s| (worst {rel:.3g} of max|s|)")
        products = {"bf16": 1, "high3": 3, "highest": 6}[prec]
        flops = 2.0 * nq * nd * dp * products
        nbytes = (nq + nd) * dp * 4 + nd * 4 + (nd // 32) * nq * 4
        t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S

        def library(low):
            # one addmm a query block (2 x.q - dn) in the operands' dtype, then
            # the 32-row max
            if low:
                k4_bf16_library(torch, qm, xm, neg_dn)
                return
            with full_fp32_matmul():
                for q0 in range(0, nq, 8192):
                    s = torch.addmm(neg_dn, xm, qm[q0:q0 + 8192].T, alpha=2.0)
                    s.view(nd // 32, 32, -1).amax(1)
        if prec == "bf16":
            lib_bf16 = cuda_ms(torch, lambda: library(True), 3)
        elif lib_fp32 is None:
            lib_fp32 = cuda_ms(torch, lambda: library(False), 3)
        modes[prec] = {
            "ms": cuda_ms(torch, lambda: pass1_cuda.pass1_scores(qm, xm, dnm, prec),
                          5 if prec == "bf16" else 3),
            "plain_ms": cuda_ms(torch, lambda: pass1_cuda.pass1_scores_plain(qm, xm, dnm, prec), 3),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_bf16 if prec == "bf16" else lib_fp32,
            "library_call": f"torch.addmm {'bf16' if prec == 'bf16' else 'fp32'}, amax",
            "max_abs_err": float(diff.max()), "max_rel_err": rel,
        }
        ms, lib_ms = modes[prec]["ms"], modes[prec]["library_ms"]
        modes[prec]["ms_over_library"] = ms / lib_ms
        if prec == "bf16":              # the casts to bf16 and the kernel, by torch.profiler
            kernels = device_kernels(torch, lambda: pass1_cuda.pass1_scores(qm, xm, dnm, prec), 3)
            modes[prec]["device_launches_per_call"] = round(sum(r for r, _ in kernels.values()))
            modes[prec]["device_kernels"] = sorted(kernels)
        max_err = max(max_err, modes[prec]["max_abs_err"])
        print(f"  pass 1 {prec}: {ms:.3f} ms, library {lib_ms:.3f} ms, ratio {ms / lib_ms:.3f}",
              flush=True)
    main = modes["high3"]                    # the precision the probe proposes
    entry = {
        "name": "pass1_scores", "route": "cuda", "source": "batchelor_torch/csrc/pass1_norm.cu",
        "replaces": "benchmarks/knn_pass1_precision_probe.py:42",
        "launches": launches, "max_abs_err": max_err,
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "shape": [nq, nd, dp], "mode": "high3", "modes": modes,
    }
    return entry, probe


def phase_fast_mnn(torch, np, bt, path_kernels):
    """fast_mnn from gene space at 2 x 100,000 x 2,000; returns its line."""
    print(f"phase 7: fast_mnn, 2 x {N_CELLS:,} x {GENES:,} genes, d={DIMS}, k={K}, "
          "knn_method='auto'", flush=True)
    rng = np.random.default_rng(SEED)
    batches = [torch.from_numpy(simulate(rng, N_CELLS, GENES)).cuda(),
               torch.from_numpy(simulate(rng, N_CELLS, GENES, shift=0.8)).cuda()]
    torch.cuda.synchronize()
    runs = []
    for run in ("first", "second"):
        rec = bt.MetricsRecorder()
        if run == "first":
            zero_counts(path_kernels)
        with rec.activate():
            t0 = time.perf_counter()
            res = bt.fast_mnn(batches, d=DIMS, k=K, knn_method="auto")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        if run == "first":
            launches = read_counts(path_kernels)
            check(ran(launches, TWO_PASS + ("knn_exact",)),
                  f"K1, K2 and K3 ran, and K5 in the tricube searches: {launches}")
        spans = {k: sum(v) for k, v in rec.spans.items()}
        split = {"cosine_norm_s": spans.get("fastmnn/cosine_norm", 0.0),
                 "pca_s": spans.get("fastmnn/pca", 0.0)}
        split["merge_s"] = seconds - split["cosine_norm_s"] - split["pca_s"]
        runs.append({"seconds": seconds, "cells_per_s": 2 * N_CELLS / seconds, **split})
        print(f"  {run} run: {seconds:.3f} s {split}", flush=True)
    check(tuple(res.corrected.shape) == (2 * N_CELLS, DIMS)
          and bool(torch.isfinite(res.corrected).all()), "corrected is finite, (200000, 50)")
    v = res.rotation.double()
    ortho = float((v.T @ v - torch.eye(DIMS, dtype=v.dtype, device=v.device)).abs().max())
    check(ortho <= 1e-4, f"rotation is orthonormal: |V'V - I| = {ortho:.3g} <= 1e-4")
    exact = pair_set(bt.fast_mnn(batches, d=DIMS, k=K, knn_method="exact").merge_info[0],
                     2 * N_CELLS)
    # fp32 selection: K1's split3 mode in both MNN searches, run twice
    chunked_s = []
    for run in ("first", "second"):
        if run == "first":
            zero_counts(path_kernels)
        t0 = time.perf_counter()
        chunked = bt.fast_mnn(batches, d=DIMS, k=K, knn_method="chunked")
        torch.cuda.synchronize()
        chunked_s.append(time.perf_counter() - t0)
        if run == "first":
            chunked_launches = read_counts(path_kernels)
            check(ran(chunked_launches, TWO_PASS + ("knn_exact",)),
                  f"'chunked': K1 (split3), K2 and K3 ran, and K5 in the tricube searches: "
                  f"{chunked_launches}")
        print(f"  'chunked' {run} run: {chunked_s[-1]:.3f} s", flush=True)
    fp32 = pair_set(chunked.merge_info[0], 2 * N_CELLS)
    a = pair_set(res.merge_info[0], 2 * N_CELLS)
    jaccard = np.intersect1d(a, exact).size / np.union1d(a, exact).size
    jaccard_fp32 = np.intersect1d(fp32, exact).size / np.union1d(fp32, exact).size
    # After cosine normalization and the PCA the cells crowd: the gaps between
    # neighbours near the k-th are far below bf16's ~2^-8 of |x|^2, so "auto"
    # (bf16 selection, as in the reference) loses pairs here that fp32
    # selection ("chunked") keeps. Measured on an H100: 0.83143 with "auto",
    # 0.99961 with "chunked".
    check(jaccard >= FAST_AUTO_JACCARD_MIN,
          f"'auto' pairs vs 'exact': Jaccard {jaccard:.5f} >= {FAST_AUTO_JACCARD_MIN}")
    check(jaccard_fp32 >= PAIR_JACCARD_MIN,
          f"'chunked' pairs vs 'exact': Jaccard {jaccard_fp32:.5f} >= {PAIR_JACCARD_MIN}")
    return launches, chunked_launches, {
        "path": f"fast_mnn 2x{N_CELLS}x{GENES} d={DIMS} k={K} auto",
        "seconds": runs[0]["seconds"], "seconds_second_run": runs[1]["seconds"],
        "seconds_chunked": chunked_s[0], "seconds_chunked_second_run": chunked_s[1],
        "cells_per_s": runs[0]["cells_per_s"], "cells_per_s_second_run": runs[1]["cells_per_s"],
        "split_first_run": {k: runs[0][k] for k in ("cosine_norm_s", "pca_s", "merge_s")},
        "split_second_run": {k: runs[1][k] for k in ("cosine_norm_s", "pca_s", "merge_s")},
        "pairs_auto": int(a.size), "pairs_exact": int(exact.size), "pair_jaccard": jaccard,
        "pairs_chunked": int(fp32.size), "pair_jaccard_chunked": jaccard_fp32,
        "rotation_orthonormality": ortho,
    }


def phase_config3_card_vs_cpu(torch, np, bt):
    """bench.py config 3's options on the card and on the CPU: in fp64 the
    pairs must be identical; in fp32 the agreement is measured and reported."""
    print("phase 8: fast_mnn, card against CPU, 4 x 2,000 x 500 (bench.py config 3)", flush=True)
    rng = np.random.default_rng(SEED)
    n = 2000
    mats = [simulate(rng, n, 500, shift=0.3 * i) for i in range(4)]
    opts = dict(d=DIMS, prop_k=0.005, merge_order=[[0, 1], [2, 3]],
                restrict=[np.arange(0, n, 2), None, None, np.arange(0, n, 3)],
                svd_method="randomized")
    out = {}
    for dtype in (np.float64, np.float32):
        name = np.dtype(dtype).name
        gpu = bt.fast_mnn([m.astype(dtype) for m in mats], **opts)
        cpu = bt.fast_mnn([m.astype(dtype) for m in mats], device="cpu", **opts)
        jac = []
        for g, c in zip(gpu.merge_info, cpu.merge_info):
            a, b = pair_set(g, 4 * n), pair_set(c, 4 * n)
            jac.append(np.intersect1d(a, b).size / np.union1d(a, b).size)
        vg, vc = gpu.rotation.cpu().double(), cpu.rotation.double()
        sign = torch.sign(torch.diagonal(vg.T @ vc))
        err = float((gpu.corrected.cpu().double() * sign - cpu.corrected.double()).abs().max())
        sin_max = float(torch.linalg.matrix_norm(vc - vg @ (vg.T @ vc), ord=2))
        out[name] = {"pair_jaccard_by_step": jac, "corrected_max_abs_diff": err,
                     "rotation_subspace_sin_max": sin_max}
        print(f"  {name}: pair Jaccard by step {jac}, corrected max |diff| {err:.3g}, "
              f"rotation subspace sin {sin_max:.3g}", flush=True)
        if dtype is np.float64:
            for step, (g, c) in enumerate(zip(gpu.merge_info, cpu.merge_info)):
                check(np.array_equal(g.pairs, c.pairs),
                      f"fp64 step {step}: identical pairs ({c.pairs.shape[0]})")
            check(err <= 1e-4, f"fp64 corrected within 1e-4 up to column signs ({err:.3g})")
    return out


def profiled(torch, fn, warm_up=True):
    """One call of ``fn`` under torch.profiler after a warm-up call (none
    when the caller just made one): (wall ms, device ms summed over its
    kernels, memsets and copies, the device's idle share 1 - device / wall,
    device launches, NCCL kernels' ms)."""
    act = torch.profiler.ProfilerActivity
    if warm_up:
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for evt in prof.events():
        # the port's trace spans ("fastmnn/...") also stand on the device
        # timeline, over the kernels they enclose: counting them would count
        # those kernels twice
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.name.startswith(("fastmnn/", "quickcorrect/", "quickcsr/",
                                        "driver/"))):
            continue
        name = evt.name.replace("(anonymous namespace)::", "").split("(")[0][:60]
        runs, ms = by_name.get(name, (0, 0.0))
        by_name[name] = (runs + 1, ms + evt.time_range.elapsed_us() / 1e3)
    device_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms,
            "nccl_ms": sum(ms for k, (_, ms) in by_name.items() if "nccl" in k.lower()),
            "device_launches": sum(runs for runs, _ in by_name.values()),
            "top_kernels": [{"name": k, "launches": r, "ms": m} for k, (r, m) in top]}


def print_profile(p, what):
    print(f"  {what} profiled: wall {p['wall_ms']:.2f} ms, device {p['device_ms']:.2f} ms, "
          f"idle share {p['idle_share']:.3f}, {p['device_launches']} device launches", flush=True)
    for t in p["top_kernels"]:
        print(f"    {t['ms']:8.3f} ms {t['launches']:5d} x {t['name']}", flush=True)


def fused_pair_set(np, out, n1, n):
    """The fused step's pairs as reduced_mnn's output positions, i * n + j."""
    mask = out.pair_mask.cpu().numpy()
    targets = out.pair_targets.cpu().numpy()
    rows, cols = np.nonzero(mask)
    return rows.astype("int64") * n + targets[rows, cols].astype("int64") + n1


def phase_fused(torch, np, bt, path_kernels, b1, b2):
    """fused_merge_step at 2 x 100k against reduced_mnn; returns its line."""
    print("phase 9: fused_merge_step, 2 x 100,000 x 50, k=20, against reduced_mnn "
          "('auto' and 'exact'), then sync-free", flush=True)
    left = torch.from_numpy(b1).cuda()
    right = torch.from_numpy(b2).cuda()
    n = 2 * N_CELLS
    torch.cuda.synchronize()
    out = {}
    for method in ("auto", "exact"):
        zero_counts(path_kernels)
        t0 = time.perf_counter()
        fused = bt.fused_merge_step(left, right, K, K, K, knn_method=method)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts(path_kernels)
        if method == "auto":
            check(ran(launches, TWO_PASS), f"'auto': K1, K2 and K3 ran: {launches}")
        else:
            check(ran(launches, ("knn_exact",)), f"'exact': K5 ran: {launches}")
        ref = bt.reduced_mnn([left, right], k=K, knn_method=method)
        ours, theirs = fused_pair_set(np, fused, N_CELLS, n), pair_set(ref.merge_info[0], n)
        check(np.array_equal(np.sort(ours), np.sort(theirs)),
              f"'{method}': pair sets identical to reduced_mnn's ({theirs.size})")
        check(int(fused.n_pairs) == theirs.size, f"'{method}': n_pairs {int(fused.n_pairs)}")
        size, ref_size = float(fused.batch_size), ref.merge_info[0].batch_size
        rel = abs(size - ref_size) / ref_size
        check(rel <= 1e-5, f"'{method}': batch_size {size:.7g} vs {ref_size:.7g} "
                           f"(relative {rel:.3g} <= 1e-5)")
        corrected = torch.cat([fused.left, fused.right])
        check(bool(torch.isfinite(corrected).all()), f"'{method}': corrected is finite")
        scale = float(ref.corrected.abs().max())
        row_diff = (corrected - ref.corrected).abs().amax(1)
        off = int((row_diff > 1e-4 * scale).sum())
        worst = float(row_diff.max()) / scale
        # the host engine searches the compact involved set for the tricube
        # neighbours, the fused step the masked full set: a tie between two
        # candidates can fall either way
        print(f"  '{method}': {off} of {n} rows beyond 1e-4 x max|corrected| "
              f"(worst {worst:.3g} of it); first run {seconds:.3f} s", flush=True)
        if method == "exact":
            check(off <= n // 1000, f"'exact': corrected within 1e-4 x max|corrected| on "
                                    f">= 99.9% of rows ({off} rows beyond)")
        out[method] = {"seconds_first_run": seconds, "launches": launches,
                       "pairs": int(theirs.size), "batch_size": size,
                       "batch_size_rel_diff": rel, "rows_beyond_1e-4": off,
                       "worst_row_diff_rel": worst}
    # the warm-up was the 'auto' call above; this one may not sync at all
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = bt.fused_merge_step(left, right, K, K, K, knn_method="auto")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(again.right).all()),
          "'auto' second call completed under set_sync_debug_mode('error')")
    prof = {
        "fused_merge_step": profiled(torch, lambda: bt.fused_merge_step(
            left, right, K, K, K, knn_method="auto")),
        "reduced_mnn": profiled(torch, lambda: bt.reduced_mnn(
            [left, right], k=K, knn_method="auto")),
    }
    for name, p in prof.items():
        print_profile(p, f"{name} 'auto'")
    return {"path": f"fused_merge_step 2x{N_CELLS}x{DIMS} k={K}", **out, "profiled": prof}


def classic_inputs(np, n, genes):
    rng = np.random.default_rng(SEED)
    return [np.log1p(np.abs(simulate(rng, n, genes))),
            np.log1p(np.abs(simulate(rng, n, genes, shift=0.8)))]


def phase_classic(torch, np, bt, path_kernels):
    """mnn_correct at 2 x 10,000 x 2,000, then card against CPU; returns its line."""
    print(f"phase 10: mnn_correct, 2 x {CLASSIC_N:,} x {GENES:,} genes, sigma=0.1, "
          "var_adj, then card against CPU at 2 x 1,000 x 500", flush=True)
    mats = [torch.from_numpy(m).cuda() for m in classic_inputs(np, CLASSIC_N, GENES)]
    torch.cuda.synchronize()
    seconds = []
    for run in ("first", "second"):
        if run == "first":
            zero_counts(path_kernels)
        t0 = time.perf_counter()
        res = bt.mnn_correct(mats, sigma=0.1, var_adj=True)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if run == "first":
            launches = read_counts(path_kernels)
            check(launches["topk_rows"] > 0, f"K2 ran in the MNN searches: {launches}")
        print(f"  {run} run: {seconds[-1]:.3f} s", flush=True)
    check(tuple(res.corrected.shape) == (2 * CLASSIC_N, GENES)
          and bool(torch.isfinite(res.corrected).all()),
          f"corrected is finite, ({2 * CLASSIC_N}, {GENES}); "
          f"{res.merge_info[0].pairs.shape[0]} pairs")
    small = classic_inputs(np, 1000, 500)
    agree = {}
    for name, kw in (("svd_dim=2", {"svd_dim": 2}),
                     ("subset_row+correct_all+out_on_host",
                      {"subset_row": np.arange(0, 500, 2), "correct_all": True,
                       "out_on_host": True})):
        for dtype in (np.float64, np.float32):
            mats = [m.astype(dtype) for m in small]
            gpu = bt.mnn_correct(mats, sigma=0.1, var_adj=True, **kw)
            cpu = bt.mnn_correct(mats, sigma=0.1, var_adj=True, device="cpu", **kw)
            host = isinstance(gpu.corrected, np.ndarray)
            g = gpu.corrected if host else gpu.corrected.cpu().numpy()
            c = np.asarray(cpu.corrected)
            a, b = pair_set(gpu.merge_info[0], 2000), pair_set(cpu.merge_info[0], 2000)
            same_pairs = np.array_equal(np.sort(a), np.sort(b))
            jac = np.intersect1d(a, b).size / np.union1d(a, b).size
            err = float(np.abs(g - c).max()) / float(np.abs(c).max())
            label = f"{name} {np.dtype(dtype).name}"
            agree[label] = {"pair_jaccard": jac, "max_abs_diff_rel": err, "host_result": host}
            print(f"  {label}: pair Jaccard {jac:.5f}, max |diff| {err:.3g} of max|corrected|",
                  flush=True)
            check(host == ("out_on_host" in kw), f"{label}: result on the host iff out_on_host")
            # in fp32 the two devices round the exact search's distances
            # differently, and a pair at a near-tie can come and go; one pair
            # moves its cell's average and the smoothing around it
            if dtype is np.float64 or same_pairs:
                check(same_pairs and err <= 1e-4,
                      f"{label}: identical pairs, card within 1e-4 x max|corrected| of the CPU")
    return {"path": f"mnn_correct 2x{CLASSIC_N}x{GENES} sigma=0.1 var_adj",
            "seconds": seconds[0], "seconds_second_run": seconds[1], "launches": launches,
            "pairs": int(res.merge_info[0].pairs.shape[0]), "card_vs_cpu": agree}


def phase_checkpoint(torch, np, bt, root):
    """reduced_mnn with checkpoint_dir: an interrupted run resumed."""
    import shutil

    n = CKPT_N
    print(f"phase 11: checkpoints, reduced_mnn on 3 x {n:,} x {DIMS}, 'auto', "
          "resumed after its last step's files are gone", flush=True)
    rng = np.random.default_rng(SEED)
    mats = [torch.from_numpy(simulate(rng, n, DIMS, shift=0.4 * i)).cuda() for i in range(3)]
    ck = os.path.join(root, "build", "chip_smoke_checkpoint")
    shutil.rmtree(ck, ignore_errors=True)
    # index_add_'s atomics would make two runs differ in their last bits and
    # move near-tied tricube neighbours; deterministic algorithms make the
    # resumed run reproduce the uninterrupted one
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.perf_counter()
        full = bt.reduced_mnn(mats, k=K, knn_method="auto", checkpoint_dir=ck)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        check(bt.MergeCheckpointer(ck).completed_steps == 2, "two steps saved")
        meta_path = os.path.join(ck, "merge_meta.json")
        with open(meta_path) as fh:
            meta = json.load(fh)
        for name in ("step_0001.npz", "step_0001_data.npy"):
            os.remove(os.path.join(ck, name))
        meta["completed"] = 1
        with open(meta_path, "w") as fh:
            json.dump(meta, fh)
        t0 = time.perf_counter()
        resumed = bt.reduced_mnn(mats, k=K, knn_method="auto", checkpoint_dir=ck)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    shutil.rmtree(ck, ignore_errors=True)
    scale = float(full.corrected.abs().max())
    err = float((resumed.corrected - full.corrected).abs().max()) / scale
    check(err <= 1e-6, f"resumed equals uninterrupted within 1e-6 x max|corrected| ({err:.3g})")
    same = all(np.array_equal(a.pairs, b.pairs)
               for a, b in zip(full.merge_info, resumed.merge_info))
    check(same, "identical pairs in both steps")
    return {"path": f"reduced_mnn 3x{n}x{DIMS} auto checkpointed",
            "seconds_uninterrupted": full_s, "seconds_resumed": resumed_s,
            "max_abs_diff_rel": err}


QC_N = 100_000                 # quick_correct's cells a batch (phase 12)
QC_GENES = 5_000               # its genes: bench.py's gene-space width
HVG_N = 2_000                  # its highly variable genes
CLUSTER_N = 100_000            # cluster_mnn's cells a batch, 8 batches (phase 13)
CLUSTER_GENES = 500            # bench.py config 4: min(N_GENES, 500)


def card_counts(torch, gen, means, n, shift, labels=False):
    """Raw counts drawn on the card: Poisson of exp(type mean + 0.5 noise
    (+ the batch's shift)), the simulation's log-means, from ``gen``; with
    ``labels`` also each cell's type."""
    assign = torch.randint(0, means.shape[0], (n,), device="cuda", generator=gen)
    logmean = means[assign] + 0.5 * torch.randn(n, means.shape[1], device="cuda", generator=gen)
    if shift is not None:
        logmean += shift
    counts = torch.poisson(logmean.exp_(), generator=gen)
    return (counts, assign.cpu().numpy()) if labels else counts


def quick_counts(torch, n, genes):
    """Two batches of raw counts on the card, the second shifted."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    means = torch.randn(4, genes, device="cuda", generator=gen)
    shift = 0.8 * torch.randn(1, genes, device="cuda", generator=gen)
    return [card_counts(torch, gen, means, n, None), card_counts(torch, gen, means, n, shift)]


def aligned_diff(torch, gpu, cpu):
    """max |card - CPU| of corrected PCs over max |CPU|, each card column
    turned to the sign of the CPU's rotation column."""
    sign = torch.sign(torch.diagonal(gpu.rotation.cpu().double().T @ cpu.rotation.double()))
    want = cpu.corrected.double()
    return float((gpu.corrected.cpu().double() * sign - want).abs().max() / want.abs().max())


def gene_space_diff(gpu, cpu):
    """max |card - CPU| of corrected @ rotation.T over its max |CPU|: blind to
    the signs and bases the PCA's eigensolvers choose."""
    def genes(res):
        return res.corrected.cpu().double() @ res.rotation.cpu().double().T
    want = genes(cpu)
    return float((genes(gpu) - want).abs().max() / want.abs().max())


def phase_quick_correct(torch, np, bt, path_kernels):
    """quick_correct from raw counts at 2 x 100,000 x 5,000; returns (its line,
    its result, the counts, the launches)."""
    print(f"phase 12: quick_correct, raw counts 2 x {QC_N:,} x {QC_GENES:,} genes, "
          f"hvg_n={HVG_N}, FastMNNParams(d={DIMS}, knn_method='auto'), correct_all", flush=True)
    t0 = time.perf_counter()
    counts = quick_counts(torch, QC_N, QC_GENES)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    params = bt.FastMNNParams(d=DIMS, knn_method="auto")
    runs = []
    for run in ("first", "second"):
        rec = bt.MetricsRecorder()
        if run == "first":
            zero_counts(path_kernels)
        with rec.activate():
            t0 = time.perf_counter()
            res = bt.quick_correct(counts, hvg_n=HVG_N, params=params, correct_all=True)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        if run == "first":
            launches = read_counts(path_kernels)
            check(ran(launches, TWO_PASS + ("knn_exact", "local_linear")),
                  f"K1, K2 and K3 ran, K5 in the tricube searches and K6 in the trend "
                  f"fits: {launches}")
        spans = {k: sum(v) for k, v in rec.spans.items()}
        split = {"normalize_s": spans.get("quickcorrect/normalize", 0.0),
                 "model_gene_var_s": spans.get("quickcorrect/model_gene_var", 0.0),
                 "correct_s": spans.get("quickcorrect/correct", 0.0)}
        runs.append({"seconds": seconds, **split})
        print(f"  {run} run: {seconds:.3f} s {split}", flush=True)
    prof = profiled(torch, lambda: bt.quick_correct(counts, hvg_n=HVG_N, params=params,
                                                    correct_all=True))
    print_profile(prof, "quick_correct")
    out = res.corrected
    check(res.hvgs.shape == (HVG_N,) and len(set(res.hvgs.tolist())) == HVG_N,
          f"{HVG_N} distinct HVGs")
    check(tuple(out.corrected.shape) == (2 * QC_N, DIMS) and bool(torch.isfinite(out.corrected).all())
          and tuple(out.rotation.shape) == (QC_GENES, DIMS),
          f"corrected is finite, ({2 * QC_N}, {DIMS}); rotation ({QC_GENES}, {DIMS}); "
          f"{out.merge_info[0].pairs.shape[0]} pairs")

    small = [c.cpu().double() for c in quick_counts(torch, 2000, 500)]
    kw = dict(hvg_n=200, params=bt.FastMNNParams(d=DIMS, knn_method="auto"))
    gpu = bt.quick_correct(small, **kw)
    cpu = bt.quick_correct(small, device="cpu", **kw)
    check(np.array_equal(gpu.hvgs, cpu.hvgs), "2 x 2,000 x 500 fp64: the same HVGs")
    check(np.array_equal(gpu.corrected.merge_info[0].pairs, cpu.corrected.merge_info[0].pairs),
          f"2 x 2,000 x 500 fp64: identical pairs ({cpu.corrected.merge_info[0].pairs.shape[0]})")
    err = aligned_diff(torch, gpu.corrected, cpu.corrected)
    check(err <= 1e-6, f"2 x 2,000 x 500 fp64: corrected within 1e-6 x max|corrected| after "
                       f"sign alignment ({err:.3g})")
    line = {"path": f"quick_correct 2x{QC_N}x{QC_GENES} hvg_n={HVG_N} d={DIMS} auto",
            "draw_counts_s": draw_s, "seconds": runs[0]["seconds"],
            "seconds_second_run": runs[1]["seconds"],
            "split_first_run": {k: v for k, v in runs[0].items() if k != "seconds"},
            "split_second_run": {k: v for k, v in runs[1].items() if k != "seconds"},
            "pairs": int(out.merge_info[0].pairs.shape[0]), "card_vs_cpu_rel_diff": err,
            "profiled": prof}
    return line, res, counts, launches


def cluster_inputs(np, n, genes, dtype):
    """bench.py config 4's atlas: 8 batches of log1p |x| of the simulation
    with shift 0.3 i, and the simulation's labels as clusters."""
    rng = np.random.default_rng(SEED)
    mats, labels = [], []
    for i in range(8):
        x, assign = simulate(rng, n, genes, shift=0.3 * i, labels=True)
        mats.append(np.log1p(np.abs(x)).astype(dtype))
        labels.append(assign)
    return mats, labels


def phase_cluster(torch, np, bt, path_kernels):
    """cluster_mnn at 8 x 100,000 x 500; returns (its line, the labels, the launches)."""
    print(f"phase 13: cluster_mnn, 8 x {CLUSTER_N:,} x {CLUSTER_GENES} genes (bench.py config 4), "
          "then clusters=4 (k-means) on 2 batches", flush=True)
    t0 = time.perf_counter()
    host, labels = cluster_inputs(np, CLUSTER_N, CLUSTER_GENES, np.float32)
    mats = [torch.from_numpy(m).cuda() for m in host]
    torch.cuda.synchronize()
    inputs_s = time.perf_counter() - t0
    del host
    seconds = []
    for run in ("first", "second"):
        if run == "first":
            zero_counts(path_kernels)
        t0 = time.perf_counter()
        res = bt.cluster_mnn(mats, clusters=labels)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if run == "first":
            launches = read_counts(path_kernels)
            check(ran(launches, ("knn_exact",)),
                  f"K5 ran in the nearest-centroid searches: {launches}")
        print(f"  {run} run: {seconds[-1]:.3f} s", flush=True)
    prof = profiled(torch, lambda: bt.cluster_mnn(mats, clusters=labels))
    print_profile(prof, "cluster_mnn")
    n_cent = len(res.cluster_meta["meta"])
    check(tuple(res.corrected.shape) == (8 * CLUSTER_N, n_cent - 1)
          and bool(torch.isfinite(res.corrected).all()),
          f"corrected is finite, ({8 * CLUSTER_N}, {n_cent - 1}); {n_cent} centroids in "
          f"{len(set(res.cluster_meta['meta'].tolist()))} meta-clusters")
    kmeans_s = []
    for run in ("first", "second"):
        t0 = time.perf_counter()
        auto = bt.cluster_mnn(mats[:2], clusters=4)
        torch.cuda.synchronize()
        kmeans_s.append(time.perf_counter() - t0)
        print(f"  clusters=4 on 2 batches, {run} run: {kmeans_s[-1]:.3f} s", flush=True)
    agree = sum(len(set(zip(auto.cluster[i * CLUSTER_N:(i + 1) * CLUSTER_N].tolist(),
                            labels[i].tolist()))) for i in range(2))
    print(f"  k-means labels against the simulation's: {agree} distinct (k-means, type) "
          "pairs over the 2 batches (8: the same partitions)", flush=True)
    check(bool(torch.isfinite(auto.corrected).all()), "clusters=4: corrected is finite")

    small, small_labels = cluster_inputs(np, 2000, 100, np.float64)
    gpu = bt.cluster_mnn(small, clusters=small_labels)
    cpu = bt.cluster_mnn(small, clusters=small_labels, device="cpu")
    # The simulation draws each batch's type means anew, so most merge steps
    # find one centroid pair, which moves the right centroid onto its left
    # partner; a later centroid then has two nearest left centroids at one
    # position, an exact tie that rounding decides (the CPU alone flips it
    # under a 1e-13 relative perturbation of the input). Name each centroid
    # by the lowest-numbered centroid at its corrected position (the CPU's)
    # before comparing the pairs.
    pos = cpu.centroid_result.corrected.double()
    dist = torch.cdist(pos, pos, compute_mode="donot_use_mm_for_euclid_dist")
    same = (dist <= 1e-9 * float(pos.abs().max())) | torch.eye(pos.shape[0], dtype=torch.bool)
    canon = same.double().argmax(1).tolist()
    steps = list(zip(gpu.centroid_result.merge_info, cpu.centroid_result.merge_info))
    by_index = sum(set(map(tuple, a.pairs.tolist())) != set(map(tuple, b.pairs.tolist()))
                   for a, b in steps)
    same = all({(canon[i], canon[j]) for i, j in a.pairs.tolist()}
               == {(canon[i], canon[j]) for i, j in b.pairs.tolist()} for a, b in steps)
    check(same, f"8 x 2,000 x 100 fp64: the same centroid pairs in every step, centroids at "
                f"one position taken as one ({by_index} of {len(steps)} steps differ by index)")
    check(all(np.array_equal(gpu.cluster_meta[k], cpu.cluster_meta[k])
              for k in ("cluster", "batch", "meta")), "8 x 2,000 x 100 fp64: the same cluster_meta")
    err = gene_space_diff(gpu, cpu)
    check(err <= 1e-6, f"8 x 2,000 x 100 fp64: corrected within 1e-6 x max in gene space ({err:.3g})")
    line = {"path": f"cluster_mnn 8x{CLUSTER_N}x{CLUSTER_GENES}", "inputs_s": inputs_s,
            "seconds": seconds[0], "seconds_second_run": seconds[1],
            "kmeans_2_batches_seconds": kmeans_s[0],
            "kmeans_2_batches_seconds_second_run": kmeans_s[1],
            "kmeans_type_pairs": agree, "centroids": n_cent, "card_vs_cpu_rel_diff": err,
            "card_vs_cpu_steps_differing_by_index": by_index, "profiled": prof}
    return line, labels, launches


def phase_engines(torch, np, bt, qc, counts, labels):
    """rescale, regress and noCorrect on phase 12's HVG log-expression, the
    delta variance over its pairs, the abundance tests on phase 13's labels;
    each card against CPU at a small size. Returns its line."""
    print(f"phase 14: batch_correct (rescale, regress d={DIMS}, none) on 2 x {QC_N:,} x {HVG_N:,} "
          "log-expression, mnn_delta_variance, cluster_abundance_test/var", flush=True)
    line = {}

    def timed_call(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        line[name + "_s"] = time.perf_counter() - t0
        print(f"  {name}: {line[name + '_s']:.3f} s", flush=True)
        return out

    logs = bt.multi_batch_norm(counts).logcounts
    hv = torch.from_numpy(qc.hvgs).cuda()
    sub = [lg[:, hv] for lg in logs]
    for name, params in (("rescale", bt.RescaleParams()), ("regress", bt.RegressParams(d=DIMS)),
                         ("no_correct", bt.NoCorrectParams())):
        for run in ("first", "second"):
            out = timed_call(f"{name}_{run}", lambda: bt.batch_correct(sub, params=params))
        check(tuple(out.corrected.shape) == (2 * QC_N, HVG_N)
              and bool(torch.isfinite(out.corrected).all()), f"{name}: finite, ({2 * QC_N}, {HVG_N})")
        if name == "regress":
            check(tuple(out.corrected_pcs.shape) == (2 * QC_N, DIMS)
                  and bool(torch.isfinite(out.corrected_pcs).all()),
                  f"regress: corrected_pcs finite, ({2 * QC_N}, {DIMS})")
        del out
    del sub
    pairs = [i.pairs for i in qc.corrected.merge_info]
    dv = timed_call("mnn_delta_variance", lambda: bt.mnn_delta_variance(
        logs, pairs, subset_row=qc.hvgs))
    check(dv.adjusted.shape == (HVG_N,) and bool(np.isfinite(dv.adjusted).all()),
          f"mnn_delta_variance: finite, ({HVG_N},) over {pairs[0].shape[0]} pairs")
    del logs
    x = np.concatenate(labels)
    batch = np.repeat(np.arange(len(labels)), [lab.size for lab in labels])
    p = timed_call("cluster_abundance_test", lambda: bt.cluster_abundance_test(x, batch))
    v = timed_call("cluster_abundance_var", lambda: bt.cluster_abundance_var(x, batch))
    check(p.shape == (4,) and bool(((p >= 0) & (p <= 1)).all()) and v.shape == (4,),
          f"abundance over {x.size:,} cells: p-values {np.round(p, 6).tolist()}")

    # card against CPU, fp64, small
    rng = np.random.default_rng(SEED)
    mats = [np.log1p(np.abs(simulate(rng, 1000, 200, shift=0.8 * i))).astype(np.float64)
            for i in range(2)]
    for name, params in (("rescale", bt.RescaleParams()),
                         ("regress", bt.RegressParams(d=10, keep=[0])),
                         ("no_correct", bt.NoCorrectParams())):
        kw = dict(params=params, restrict=[None, np.arange(0, 1000, 3)])
        gpu, cpu = bt.batch_correct(mats, **kw), bt.batch_correct(mats, device="cpu", **kw)
        err = float((gpu.corrected.cpu() - cpu.corrected).abs().max())
        check(err <= 1e-10, f"{name} 2 x 1,000 x 200 fp64: card within 1e-10 of the CPU ({err:.3g})")
        if name == "regress":
            sign = torch.sign((gpu.corrected_pcs.cpu() * cpu.corrected_pcs).sum(0))
            err = float((gpu.corrected_pcs.cpu() * sign - cpu.corrected_pcs).abs().max())
            check(err <= 1e-8, f"regress d=10: PCs within 1e-8 after sign alignment ({err:.3g})")
    pr = [np.stack([rng.integers(0, 1000, 300), 1000 + rng.integers(0, 1000, 300)], 1)]
    for fn, kw in ((bt.mnn_delta_variance, {"cos_norm": True}),
                   (bt.mnn_delta_variance_blocked, {"chunk_pairs": 128})):
        gpu, cpu = fn(mats, pr, **kw), fn(mats, pr, device="cpu", **kw)
        err = max(float(np.abs(getattr(gpu, f) - getattr(cpu, f)).max())
                  for f in ("mean", "total", "trend", "adjusted"))
        check(err <= 1e-10, f"{fn.__name__} 2 x 1,000 x 200 fp64: card within 1e-10 ({err:.3g})")
    sx, sb = rng.integers(0, 6, 5000), rng.integers(0, 3, 5000)
    for fn in (bt.cluster_abundance_test, bt.cluster_abundance_var):
        err = float(np.abs(fn(sx, sb) - fn(sx, sb, device="cpu")).max())
        check(err <= 1e-12, f"{fn.__name__}: card within 1e-12 of the CPU ({err:.3g})")
    return {"path": f"engines and diagnostics on 2x{QC_N}x{HVG_N}", **line}


OOC_N = 100_000                # quick_correct_csr's cells a batch (phase 15)
OOC_LOG_SHIFT = -3.25          # lowers phase 12's log-means to 5-10% nonzero counts
# multiBatchNorm's gene filter for UMI counts: at droplet density no gene
# averages the default min_mean = 1 count (scran's documentation advises 0.1)
UMI_MIN_MEAN = 0.1
CROSSOVER_DENSITIES = (0.25, 0.5, 0.75, 1.0)


def droplet_counts(torch, n, genes, log_shift=OOC_LOG_SHIFT):
    """Two batches of raw counts on the card at droplet density: phase 12's
    generator with every log-mean lowered by ``-log_shift``, the second batch
    shifted; returns (counts, type labels)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    means = torch.randn(4, genes, device="cuda", generator=gen)
    shift = 0.8 * torch.randn(1, genes, device="cuda", generator=gen)
    out = [card_counts(torch, gen, means, n, log_shift, labels=True),
           card_counts(torch, gen, means, n, shift + log_shift, labels=True)]
    return [c for c, _ in out], [lab for _, lab in out]


def card_to_csr(torch, np, bt, x, rows=16_384):
    """A dense card matrix as a host CSRCells (fp32 data, int32 indices,
    int64 indptr), converted on the card block by block."""
    data, indices, counts = [], [], []
    for r0 in range(0, x.shape[0], rows):
        blk = x[r0:r0 + rows]
        nz = blk != 0
        counts.append(nz.sum(1).cpu())
        data.append(blk[nz].float().cpu())
        indices.append(nz.nonzero()[:, 1].int().cpu())
    indptr = np.concatenate([[0], np.cumsum(torch.cat(counts).numpy())]).astype(np.int64)
    return bt.CSRCells(data=torch.cat(data).numpy(), indices=torch.cat(indices).numpy(),
                       indptr=indptr, n_genes=x.shape[1])


def density(csr):
    return csr.data.shape[0] / (csr.n_cells * csr.n_genes)


def h2d_bytes(csr, block_rows, mode):
    """Host-to-device bytes of one pass over ``csr``: 4 a slot for "dense",
    8 a nonzero plus 8 a row offset (n + 1 a block) for "sparse"."""
    if mode == "dense":
        return 4 * csr.n_cells * csr.n_genes
    n_blocks = -(-csr.n_cells // block_rows)
    return 8 * csr.data.shape[0] + 8 * (csr.n_cells + n_blocks)


def sync_time(torch, fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def transfer_modes(torch, np, bt, stores, label):
    """multi_batch_pca_csr on ``stores`` as it runs (the nonzeros shipped,
    "sparse") and with each block densified on the host and copied instead
    ("dense", the JAX package's other transfer): bit-identical results, each
    mode timed in turns (sparse, dense, dense, sparse), and the host-to-device
    bytes of each; returns its line."""
    from unittest import mock

    from batchelor_torch.ops import pca_outofcore

    def host_densify(csr, block_rows, pad=False, device=None):
        for block, n_valid in bt.dense_blocks(csr, block_rows, pad=pad):
            yield torch.from_numpy(block).to(device), n_valid

    def run(mode):
        if mode == "sparse":
            return bt.multi_batch_pca_csr(stores, **kw)
        with mock.patch.object(pca_outofcore, "device_dense_blocks", host_densify):
            return bt.multi_batch_pca_csr(stores, **kw)

    kw = dict(d=DIMS, block_rows=8192)
    res, secs = {}, {"sparse": [], "dense": []}
    for mode in ("sparse", "dense", "dense", "sparse"):
        res[mode], s = sync_time(torch, lambda: run(mode))
        secs[mode].append(s)
    sp, dn = res["sparse"], res["dense"]
    same = (torch.equal(sp.centers, dn.centers) and torch.equal(sp.rotation, dn.rotation)
            and all(np.array_equal(a, b) for a, b in zip(sp.components, dn.components)))
    dens = sum(s.data.shape[0] for s in stores) / sum(s.n_cells * s.n_genes for s in stores)
    check(same, f"{label}: transfer 'sparse' and 'dense' bit-identical (density {dens:.4f})")
    line = {"density": dens, "shape": [len(stores), stores[0].n_cells, stores[0].n_genes]}
    for mode in ("sparse", "dense"):
        # two passes over every store: the Gram, then the projection
        line[mode] = {"seconds": secs[mode],
                      "h2d_bytes": 2 * sum(h2d_bytes(s, kw["block_rows"], mode) for s in stores)}
    print(f"  {label}: density {dens:.4f}; sparse {secs['sparse']} s "
          f"({line['sparse']['h2d_bytes'] / 1e9:.3f} GB to the card), dense {secs['dense']} s "
          f"({line['dense']['h2d_bytes'] / 1e9:.3f} GB)", flush=True)
    return line


def tricube_neighbours(fn):
    """``fn()`` and the neighbours that its last tricube search found: for
    each cell of the merge's right side, its nearest MNN-involved cells."""
    from unittest import mock

    from batchelor_torch.ops import correction

    seen, real = [], correction.query_knn

    def recording(query, data, k, **kw):
        out = real(query, data, k, **kw)
        seen.append(out.indices.cpu().numpy())
        return out

    with mock.patch.object(correction, "query_knn", recording):
        res = fn()
    return res, seen[-1]


def random_store(torch, np, bt, n, genes, p):
    """A (n, genes) store of uniform values at density ``p``, drawn on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.rand(n, genes, device="cuda", generator=gen)
    x = torch.where(torch.rand(n, genes, device="cuda", generator=gen) < p, x + 0.5, 0.0)
    return card_to_csr(torch, np, bt, x)


def phase_outofcore(torch, np, bt, path_kernels, root):
    """The out-of-core path on 2 x 100,000 x 5,000 droplet-density stores;
    returns (its line, launches by path)."""
    from batchelor_torch.correct import outofcore

    print(f"phase 15: out of core, CSR stores 2 x {OOC_N:,} x {QC_GENES:,} genes of raw counts "
          f"at droplet density: quick_correct_csr (hvg_n={HVG_N}, d={DIMS}, k={K}, 'auto'), "
          "the transfer modes, the *_csr engines, card against CPU, the CLI", flush=True)
    t0 = time.perf_counter()
    counts, labels = droplet_counts(torch, OOC_N, QC_GENES)
    stores = [card_to_csr(torch, np, bt, c) for c in counts]
    inputs_s = time.perf_counter() - t0
    dens = [density(s) for s in stores]
    host_gb = sum(s.data.nbytes + s.indices.nbytes + s.indptr.nbytes for s in stores) / 1e9
    check(all(0.05 <= d <= 0.10 for d in dens),
          f"stores at droplet density: {[round(d, 4) for d in dens]} nonzero, "
          f"{host_gb:.3f} GB of CSR on the host")
    line = {"path": f"quick_correct_csr 2x{OOC_N}x{QC_GENES} hvg_n={HVG_N} d={DIMS} auto",
            "inputs_s": inputs_s, "density": dens, "host_csr_gb": host_gb}
    launches = {}

    qkw = dict(hvg_n=HVG_N, d=DIMS, k=K, knn_method="auto", min_mean=UMI_MIN_MEAN)
    runs = []
    for run in ("first", "second"):
        rec = bt.MetricsRecorder()
        if run == "first":
            zero_counts(path_kernels)
        with rec.activate():
            qc, s = sync_time(torch, lambda: bt.quick_correct_csr(stores, **qkw))
        if run == "first":
            launches["quick_correct_csr"] = read_counts(path_kernels)
            check(ran(launches["quick_correct_csr"], TWO_PASS + ("knn_exact",)),
                  f"K1, K2 and K3 ran, and K5 in the tricube searches: "
                  f"{launches['quick_correct_csr']}")
        spans = {k: sum(v) for k, v in rec.spans.items() if k.startswith("quickcsr/")}
        runs.append({"seconds": s, "spans": spans})
        print(f"  quick_correct_csr {run} run: {s:.3f} s {spans}", flush=True)
    line["runs"] = runs
    line["profiled"] = profiled(torch, lambda: bt.quick_correct_csr(stores, **qkw))
    print_profile(line["profiled"], "quick_correct_csr")
    out = qc.corrected
    n_hvg = qc.hvgs.shape[0]
    # get_top_hvgs keeps only genes with a positive biological variance
    check(len(set(qc.hvgs.tolist())) == n_hvg <= HVG_N,
          f"{n_hvg} distinct HVGs (at most {HVG_N})")
    check(tuple(out.corrected.shape) == (2 * OOC_N, DIMS)
          and bool(torch.isfinite(out.corrected).all())
          and tuple(out.rotation.shape) == (n_hvg, DIMS),
          f"corrected finite ({2 * OOC_N}, {DIMS}), rotation ({n_hvg}, {DIMS}), "
          f"{out.merge_info[0].pairs.shape[0]} pairs")
    line["hvgs"] = n_hvg

    # the dense quick_correct on the same counts with the matching options
    params = bt.FastMNNParams(d=DIMS, k=K, knn_method="auto")
    dense_s = []
    for _ in range(2):
        dense, s = sync_time(torch, lambda: bt.quick_correct(
            counts, hvg_n=HVG_N, params=params, correct_all=False, min_mean=UMI_MIN_MEAN))
        dense_s.append(s)
    overlap = np.intersect1d(dense.hvgs, qc.hvgs).size / max(dense.hvgs.size, n_hvg)
    a, b = pair_set(out.merge_info[0], 2 * OOC_N), pair_set(dense.corrected.merge_info[0],
                                                            2 * OOC_N)
    jac = np.intersect1d(a, b).size / np.union1d(a, b).size
    line["dense_quick_correct"] = {"seconds": dense_s, "hvg_overlap": overlap,
                                   "pair_jaccard": jac, "pairs": int(b.size)}
    print(f"  dense quick_correct on the same counts: {dense_s} s against "
          f"{[r['seconds'] for r in runs]} s out of core; HVG overlap {overlap:.4f}, "
          f"pair Jaccard {jac:.5f}", flush=True)
    del counts, dense

    # the HVG stores as quick_correct_csr transforms them
    sfs = [(lib / lib.mean()).astype(np.float32) for lib in (s.row_sums() for s in stores)]
    avgs = [outofcore._stream_stats(s, sf, 2.0)[0] for s, sf in zip(stores, sfs)]
    sfs = [np.asarray(r, np.float32) for r in outofcore.rescale_size_factors(
        avgs, sfs, min_mean=UMI_MIN_MEAN)]
    hvg_stores = [outofcore._lognorm_cosine_csr(s.select_genes(qc.hvgs), sf, 2.0, True)
                  for s, sf in zip(stores, sfs)]
    # above 1,024 genes quick_correct_csr's PCA is the randomized one (as the
    # JAX package's); the dense path's is exact: the pairs of an exact PCA
    exact = bt.reduced_mnn(bt.multi_batch_pca_csr(hvg_stores, d=DIMS, eig_method="exact")
                           .components, k=K, knn_method="auto")
    c = pair_set(exact.merge_info[0], 2 * OOC_N)
    jac_exact = np.intersect1d(c, b).size / np.union1d(c, b).size
    jac_rand = np.intersect1d(c, a).size / np.union1d(c, a).size
    line["dense_quick_correct"].update(pair_jaccard_exact_pca=jac_exact,
                                       exact_pca_vs_randomized_pair_jaccard=jac_rand)
    print(f"  with an exact PCA of the HVG stores: pair Jaccard {jac_exact:.5f} against the "
          f"dense path, {jac_rand:.5f} against the randomized one", flush=True)
    check(jac_exact >= 0.95, f"the streamed path with an exact PCA finds the dense path's pairs: "
                             f"Jaccard {jac_exact:.5f} >= 0.95")

    # the transfer modes on the HVG stores, then at 25%, 50%, 75% and 100%
    line["transfer"] = [transfer_modes(torch, np, bt, hvg_stores, "HVG stores")]
    for p in CROSSOVER_DENSITIES:
        st = random_store(torch, np, bt, OOC_N, HVG_N, p)
        line["transfer"].append(transfer_modes(torch, np, bt, [st], f"1 x {OOC_N:,} x {HVG_N:,}"))
        del st

    # the other engines
    def engine(name, fn):
        zero_counts(path_kernels)
        res, s = sync_time(torch, fn)
        launches[name] = read_counts(path_kernels)
        line[name + "_s"] = s
        print(f"  {name}: {s:.3f} s, launches {launches[name]}", flush=True)
        return res

    small = [s.select_cells(np.arange(CLASSIC_N)) for s in hvg_stores]
    sub = np.arange(0, n_hvg, 4)
    mc = engine("mnn_correct_csr", lambda: bt.mnn_correct_csr(small, subset_row=sub))
    check(tuple(mc.corrected.shape) == (2 * CLASSIC_N, sub.size)
          and bool(torch.isfinite(mc.corrected).all()) and launches["mnn_correct_csr"]["topk_rows"] > 0,
          f"mnn_correct_csr 2 x {CLASSIC_N:,} x {n_hvg:,}, subset_row: finite, K2 ran")
    mc = engine("mnn_correct_csr_correct_all", lambda: bt.mnn_correct_csr(
        small, subset_row=sub, correct_all=True))
    check(isinstance(mc.corrected, np.ndarray) and mc.corrected.shape == (2 * CLASSIC_N, n_hvg)
          and bool(np.isfinite(mc.corrected).all()),
          "mnn_correct_csr with correct_all: a finite host result (out_on_host)")
    cm = engine("cluster_mnn_csr", lambda: bt.cluster_mnn_csr(hvg_stores, clusters=labels))
    check(bool(torch.isfinite(cm.corrected).all()) and ran(launches["cluster_mnn_csr"], ("knn_exact",)),
          f"cluster_mnn_csr: finite, {len(cm.cluster_meta['meta'])} centroids, K5 ran")
    rs = engine("rescale_batches_csr", lambda: bt.rescale_batches_csr(hvg_stores))
    check(all(np.isfinite(s.data).all() and np.array_equal(s.indptr, h.indptr)
              for s, h in zip(rs, hvg_stores)), "rescale_batches_csr: finite, pattern kept")
    rg = engine("regress_batches_csr", lambda: bt.regress_batches_csr(hvg_stores))
    check(rg.shape == (2 * OOC_N, n_hvg) and bool(np.isfinite(rg.block(0, 4096)).all()),
          "regress_batches_csr: finite residual block")
    pairs = [i.pairs for i in out.merge_info]
    dv = engine("mnn_delta_variance_blocked", lambda: bt.mnn_delta_variance_blocked(
        hvg_stores, pairs))
    check(bool(np.isfinite(dv.adjusted).all()) and dv.adjusted.shape == (n_hvg,),
          f"mnn_delta_variance_blocked on CSR over {pairs[0].shape[0]} pairs: finite")
    del hvg_stores, small

    # the card against the CPU at 2 x 2,000 x 500, ~10% density, fp32 CSR
    (c_small, lab_small) = droplet_counts(torch, 2000, 500, log_shift=-2.5)
    small = [card_to_csr(torch, np, bt, c) for c in c_small]
    sd = [density(s) for s in small]
    for s in small:
        host = list(bt.dense_blocks(s, block_rows=768))
        dev = list(bt.device_dense_blocks(s, block_rows=768))
        check(all(torch.equal(d.cpu(), torch.from_numpy(h)) for (h, _), (d, _) in zip(host, dev)),
              f"device_dense_blocks bit for bit against the host densify (density {density(s):.4f})")
    kw = dict(hvg_n=200, d=DIMS, k=K, min_mean=UMI_MIN_MEAN)
    cache = os.path.join(root, "build", "chip_smoke_pca")
    shutil.rmtree(cache, ignore_errors=True)
    gpu, nb_gpu = tricube_neighbours(lambda: bt.quick_correct_csr(small, pca_cache_dir=cache,
                                                                    **kw))
    cpu, nb_cpu = tricube_neighbours(lambda: bt.quick_correct_csr(small, device="cpu", **kw))
    check(np.array_equal(gpu.hvgs, cpu.hvgs), "2 x 2,000 x 500: the same HVGs")
    ga, ca = pair_set(gpu.corrected.merge_info[0], 4000), pair_set(cpu.corrected.merge_info[0],
                                                                   4000)
    same_pairs = np.array_equal(np.sort(ga), np.sort(ca))
    jac_small = np.intersect1d(ga, ca).size / np.union1d(ga, ca).size
    pc_err = aligned_diff(torch, gpu.corrected, cpu.corrected)

    def genes(res):
        return res.corrected.cpu().double() @ res.rotation.cpu().double().T
    want = genes(cpu.corrected)
    row_err = ((genes(gpu.corrected) - want).abs().amax(1) / want.abs().max()).numpy()
    # fp32 on both sides: the two eigensolvers place the PCA's weak, nearly
    # equal directions ~1e-4 apart (compare in gene space, corrected @
    # rotation.T, blind to turns within the kept subspace); a cell whose
    # tricube neighbours (the merge's last kNN) were near-tied can take
    # another one, and moves with it, as in phase 9; a near-tied pair can
    # come and go. Every other cell is held to 1e-4.
    odd = np.setxor1d(ga, ca)
    moved = np.zeros(4000, bool)
    moved[np.concatenate([odd // 4000, odd % 4000])] = True
    right0 = small[0].n_cells
    moved[right0:] |= [set(a) != set(b) for a, b in zip(nb_gpu, nb_cpu)]
    err_kept = float(row_err[~moved].max())
    err_moved = float(row_err[moved].max()) if moved.any() else 0.0
    print(f"  2 x 2,000 x 500 (densities {[round(d, 4) for d in sd]}): pair Jaccard "
          f"{jac_small:.5f}; {int(moved.sum())} rows touched by a differing pair or with other "
          f"tricube neighbours, the largest {err_moved:.3g} x max in gene space; the other "
          f"rows within {err_kept:.3g} x max; {pc_err:.3g} x max|corrected| in PC space after "
          "sign alignment", flush=True)
    check(jac_small >= 0.999, f"pair Jaccard {jac_small:.5f} >= 0.999")
    check(err_kept <= 1e-4, f"corrected in gene space within 1e-4 x max on every row with the "
                            f"same pairs and tricube neighbours ({err_kept:.3g})")
    check(moved.mean() <= 1e-3 and err_moved <= 0.05,
          f"{int(moved.sum())} rows (<= 0.1%) with another pair or tricube neighbour, "
          f"within 0.05 x max ({err_moved:.3g})")
    # the merge alone: the CPU's run on the card's PCA stage
    shared = bt.quick_correct_csr(small, device="cpu", pca_cache_dir=cache, **kw)
    shutil.rmtree(cache)
    sa = pair_set(shared.corrected.merge_info[0], 4000)
    merge_err = float((shared.corrected.corrected - gpu.corrected.corrected.cpu()).abs().max()
                      / shared.corrected.corrected.abs().max())
    check(np.array_equal(np.sort(sa), np.sort(ga)) and merge_err <= 1e-4,
          f"the CPU's merge on the card's PCA stage: identical pairs ({sa.size}), corrected "
          f"within 1e-4 x max|corrected| ({merge_err:.3g})")
    cg = bt.cluster_mnn_csr(small, clusters=lab_small)
    cc = bt.cluster_mnn_csr(small, clusters=lab_small, device="cpu")
    check(all(np.array_equal(cg.cluster_meta[k], cc.cluster_meta[k])
              for k in ("cluster", "batch", "meta")), "cluster_mnn_csr: the same cluster_meta")
    line["card_vs_cpu"] = {"densities": sd, "pair_jaccard": jac_small, "identical_pairs": same_pairs,
                           "rows_moved_by_a_near_tie": int(moved.sum()),
                           "gene_space_diff_rel_moved": err_moved,
                           "gene_space_diff_rel_others": err_kept,
                           "pc_space_aligned_diff_rel": pc_err,
                           "merge_on_card_pca_diff_rel": merge_err}

    # the CLI in a subprocess on the card, against an in-process call, on
    # phase 12's small counts (the CLI keeps the default min_mean)
    cli = os.path.join(root, "build", "chip_smoke_cli")
    dirs = []
    for i, c in enumerate(quick_counts(torch, 2000, 500)):
        npy = os.path.join(cli, f"b{i}.npy")
        os.makedirs(cli, exist_ok=True)
        np.save(npy, c.cpu().numpy())
        dirs.append(os.path.join(cli, f"store{i}"))
        cli_run(root, ["import-dense", npy, dirs[-1]])
    info = json.loads(cli_run(root, ["info", dirs[0]]))
    check(info["cells"] == 2000 and info["genes"] == 500, f"info: {info}")
    outdir = os.path.join(cli, "out")
    cli_run(root, ["quick-correct", "--input", *dirs, "--output", outdir, "--hvgs", "200",
                   "--d", str(DIMS), "--k", str(K)])
    ref = bt.quick_correct_csr([bt.CSRCells.load(d) for d in dirs], hvg_n=200, d=DIMS, k=K)
    got = np.load(os.path.join(outdir, "corrected.npy"))
    want = ref.corrected.corrected.cpu().numpy()
    cli_err = float(np.abs(got - want).max() / np.abs(want).max())
    with open(os.path.join(outdir, "merge_info.json")) as fh:
        n_pairs = [m["n_pairs"] for m in json.load(fh)]
    check(np.array_equal(np.load(os.path.join(outdir, "hvgs.npy")), ref.hvgs)
          and n_pairs == [i.pairs.shape[0] for i in ref.corrected.merge_info]
          and cli_err <= 1e-6,
          f"python -m batchelor_torch quick-correct: the same HVGs and pairs ({n_pairs}), "
          f"corrected within 1e-6 x max|corrected| of an in-process call ({cli_err:.3g})")
    line["cli_max_abs_diff_rel"] = cli_err
    return line, launches, stores


PAR_BATCHES = 8                # phase 16: BASELINE.md config 4's atlas,
PAR_N = 125_000                # 8 x 125,000 = 1,000,000 cells
PAR_ROWS_MIN = 0.999           # rows within 1e-4 of their max against reduced_mnn


@contextlib.contextmanager
def deterministic(torch):
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def compare_runs(torch, np, a, b):
    """Two MNNResults on the same cells: pairs and pair Jaccard by step, the
    quantiles 50/99/max of each row's difference over its max |value|,
    rows beyond 1e-4, lost variance, merge order and batches."""
    n = a.corrected.shape[0]
    jac = []
    for x, y in zip(a.merge_info, b.merge_info):
        sx, sy = pair_set(x, n), pair_set(y, n)
        jac.append(np.intersect1d(sx, sy).size / max(1, np.union1d(sx, sy).size))
    diff = ((a.corrected - b.corrected).abs().amax(1)
            / b.corrected.abs().amax(1).clamp(min=1e-30)).cpu().numpy()
    return {"pairs": [int(x.pairs.shape[0]) for x in a.merge_info], "jaccard_by_step": jac,
            "row_quantiles": [float(q) for q in np.quantile(diff, [0.5, 0.99, 1.0])],
            "rows_beyond_1e-4": int((diff > 1e-4).sum()),
            "lost_var_max_diff": max(float(np.abs(x.lost_var - y.lost_var).max())
                                     for x, y in zip(a.merge_info, b.merge_info)),
            "merge_order_equal": [(list(x.left), list(x.right)) for x in a.merge_info]
            == [(list(y.left), list(y.right)) for y in b.merge_info],
            "batch_equal": bool(np.array_equal(np.asarray(a.batch), np.asarray(b.batch)))}


def pair_jaccard(np, a, b, n):
    """Pair-set Jaccard over every step of two results on n cells."""
    sa = np.concatenate([pair_set(i, n) for i in a.merge_info])
    sb = np.concatenate([pair_set(i, n) for i in b.merge_info])
    return np.intersect1d(sa, sb).size / np.union1d(sa, sb).size


def phase_parallel(torch, np, bt, path_kernels, root, stores):
    """The parallel layer over a real NCCL group of one rank: distributed_fast_mnn
    on the 1,000,000-cell atlas in both memory modes against reduced_mnn, a
    checkpoint resumed, quick_correct_csr(mesh=) on phase 15's stores;
    returns (its line, launches by path)."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from batchelor_torch.parallel import distributed_fast_mnn, make_cells_mesh

    n_all = PAR_BATCHES * PAR_N
    print(f"phase 16: the parallel layer over NCCL at world size 1: distributed_fast_mnn on "
          f"{PAR_BATCHES} x {PAR_N:,} x {DIMS}, k={K}, gather and ring against reduced_mnn; "
          "a checkpoint resumed; quick_correct_csr(mesh=)", flush=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(root, "build"))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1, timeout=datetime.timedelta(minutes=10))
    try:
        mesh = make_cells_mesh()
        check(mesh.size == 1 and mesh.group is not None and mesh.device.type == "cuda"
              and "nccl" in str(dist.get_backend(mesh.group)).lower(),
              f"make_cells_mesh(): world size 1 over NCCL on {mesh.device}")
        try:
            make_cells_mesh(2)
            raised = False
        except ValueError:
            raised = True
        check(raised, "make_cells_mesh(2) on a one-card world raises (no CPU fallback)")
        return _parallel_runs(torch, np, bt, path_kernels, root, stores, mesh, n_all,
                              distributed_fast_mnn, lambda: make_cells_mesh(1))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _parallel_runs(torch, np, bt, path_kernels, root, stores, mesh, n_all, dfm,
                   make_local_mesh):
    rng = np.random.default_rng(SEED)
    mats = [torch.from_numpy(simulate(rng, PAR_N, DIMS, shift=0.3 * i)).cuda()
            for i in range(PAR_BATCHES)]
    torch.cuda.synchronize()
    line = {"path": f"distributed_fast_mnn {PAR_BATCHES}x{PAR_N}x{DIMS} k={K} NCCL world 1"}
    launches = {}
    runs = {}
    # the gated calls run with deterministic algorithms: index_add_'s atomics
    # would make two runs differ in their last bits and move near-tied
    # neighbours (phase 11); the timed calls after them run without
    for mode in ("gather", "ring"):
        zero_counts(path_kernels)
        with deterministic(torch):
            res, first = sync_time(torch, lambda: dfm(mats, mesh, k=K, memory=mode))
        launches[f"distributed_fast_mnn_{mode}_exact"] = read_counts(path_kernels)
        _, second = sync_time(torch, lambda: dfm(mats, mesh, k=K, memory=mode))
        prof = profiled(torch, lambda: dfm(mats, mesh, k=K, memory=mode), warm_up=False)
        runs[mode] = res
        line[mode] = {"seconds_first": first, "seconds_second": second, "profiled": prof,
                      "launches": launches[f"distributed_fast_mnn_{mode}_exact"]}
        print(f"  '{mode}', 'exact': first call (deterministic) {first:.3f} s, second "
              f"{second:.3f} s; "
              f"launches {launches[f'distributed_fast_mnn_{mode}_exact']}; "
              f"NCCL kernels {prof['nccl_ms']:.3f} ms", flush=True)
        print_profile(prof, f"'{mode}'")
    with deterministic(torch):
        ref, ref_s = sync_time(torch, lambda: bt.reduced_mnn(mats, k=K, knn_method="exact"))
    line["reduced_mnn_exact_seconds"] = ref_s
    print(f"  reduced_mnn 'exact': {ref_s:.3f} s", flush=True)
    gather, ring = runs["gather"], runs["ring"]
    check(ran(launches["distributed_fast_mnn_gather_exact"], ("knn_exact",)),
          "'gather': K5 ran on the exact path")
    check(ran(launches["distributed_fast_mnn_ring_exact"], ("knn_exact", "topk_rows")),
          "'ring': K5 ran on the exact path, K2 in its running merge")
    check(all(tuple(r.corrected.shape) == (n_all, DIMS) and bool(torch.isfinite(r.corrected).all())
              for r in (gather, ring)), f"corrected finite, ({n_all}, {DIMS}), both modes")
    with deterministic(torch):
        # the same code without any process group, and the reference on
        # inputs moved one ulp up: how far the reference moves by itself
        no_group = dfm(mats, make_local_mesh(), k=K)
        moved = [torch.nextafter(m, torch.full_like(m, float("inf"))) for m in mats]
        ref_ulp = bt.reduced_mnn(moved, k=K, knn_method="exact")
        del moved
    # every comparison is read before any is gated
    cmp = {}
    for a_name, a, b_name, b in (("gather", gather, "ring", ring),
                                 ("gather", gather, "no_group", no_group),
                                 ("gather", gather, "reduced_mnn", ref),
                                 ("ring", ring, "reduced_mnn", ref),
                                 ("reduced_mnn_one_ulp_up", ref_ulp, "reduced_mnn", ref),
                                 ("gather", gather, "reduced_mnn_one_ulp_up", ref_ulp)):
        cmp[f"{a_name}_vs_{b_name}"] = c = compare_runs(torch, np, a, b)
        print(f"  {a_name} vs {b_name}: pairs by step {c['pairs']}, Jaccard "
              f"{[round(j, 6) for j in c['jaccard_by_step']]}; row diff / row max, quantiles "
              f"50/99/max {c['row_quantiles']}; {c['rows_beyond_1e-4']} of {n_all} rows "
              f"beyond 1e-4; lost_var within {c['lost_var_max_diff']:.3g}", flush=True)
    line["comparisons"] = cmp
    for name, c in cmp.items():
        check(c["merge_order_equal"] and c["batch_equal"],
              f"{name}: the same merge order and batches")
    for name in ("gather_vs_ring", "gather_vs_no_group"):
        c = cmp[name]
        check(all(j == 1.0 for j in c["jaccard_by_step"]) and c["rows_beyond_1e-4"] == 0
              and c["lost_var_max_diff"] <= 1e-5,
              f"{name}: identical pairs in every step, every row within 1e-4 x its max, "
              "lost variance within 1e-5")
    # at 8 batches reduced_mnn sits on a knife-edge of these inputs: moved
    # one ulp it parts from itself as far as the parallel layer parts from
    # it, and the parallel layer agrees with the moved reference as closely
    # as with the reference on the 3-batch prefix below (readings, PERF.md)
    for name in ("gather_vs_reduced_mnn", "ring_vs_reduced_mnn"):
        c = cmp[name]
        check(min(c["jaccard_by_step"]) >= 0.99 and c["lost_var_max_diff"] <= 1e-3,
              f"{name}: pair Jaccard >= 0.99 in every step "
              f"({min(c['jaccard_by_step']):.5f}), lost variance within 1e-3")
    c = cmp["gather_vs_reduced_mnn_one_ulp_up"]
    check(all(j == 1.0 for j in c["jaccard_by_step"])
          and c["rows_beyond_1e-4"] <= (1 - PAR_ROWS_MIN) * n_all
          and c["lost_var_max_diff"] <= 1e-5,
          f"gather vs reduced_mnn one ulp up: identical pairs in every step, rows within "
          f"1e-4 x their max on >= 99.9% ({c['rows_beyond_1e-4']} beyond), lost variance "
          f"within 1e-5 ({c['lost_var_max_diff']:.3g})")
    with deterministic(torch):
        three = dfm(mats[:3], mesh, k=K)
        three_ring = dfm(mats[:3], mesh, k=K, memory="ring")
        three_ref = bt.reduced_mnn(mats[:3], k=K, knn_method="exact")
    n3 = 3 * PAR_N
    for name, a in (("gather", three), ("ring", three_ring)):
        c = compare_runs(torch, np, a, three_ref)
        cmp[f"3_batches_{name}_vs_reduced_mnn"] = c
        check(c["merge_order_equal"] and c["batch_equal"]
              and all(j == 1.0 for j in c["jaccard_by_step"])
              and c["rows_beyond_1e-4"] <= (1 - PAR_ROWS_MIN) * n3
              and c["lost_var_max_diff"] <= 1e-5,
              f"3 x {PAR_N:,}, {name} vs reduced_mnn: identical pairs in both steps "
              f"{c['pairs']}, rows within 1e-4 x their max on >= 99.9% "
              f"({c['rows_beyond_1e-4']} beyond: near-tied tricube neighbours, phase 9), "
              f"lost variance within 1e-5 ({c['lost_var_max_diff']:.3g})")
    del three, three_ring, three_ref, no_group, ref_ulp
    del ring, runs

    # "auto": the two-pass search on the per-rank searches
    zero_counts(path_kernels)
    auto, auto_s = sync_time(torch, lambda: dfm(mats, mesh, k=K, knn_method="auto"))
    launches["distributed_fast_mnn_gather_auto"] = read_counts(path_kernels)
    check(ran(launches["distributed_fast_mnn_gather_auto"], TWO_PASS),
          f"'auto': K1, K2 and K3 ran: {launches['distributed_fast_mnn_gather_auto']}")
    _, auto_s2 = sync_time(torch, lambda: dfm(mats, mesh, k=K, knn_method="auto"))
    auto_prof = profiled(torch, lambda: dfm(mats, mesh, k=K, knn_method="auto"), warm_up=False)
    print_profile(auto_prof, "'gather' 'auto'")
    ref_auto = bt.reduced_mnn(mats, k=K, knn_method="auto")
    jac = pair_jaccard(np, auto, ref_auto, n_all)
    c = compare_runs(torch, np, auto, ref_auto)
    print(f"  'auto': first call {auto_s:.3f} s, second {auto_s2:.3f} s; pair Jaccard "
          f"against reduced_mnn 'auto' {jac:.6f} over the run, by step "
          f"{[round(j, 6) for j in c['jaccard_by_step']]}", flush=True)
    # the first step's searches get the same inputs on both sides, and both
    # select in bf16; from there the tricube searches part (the compact
    # involved set against the masked whole set: other sub-chunks for bf16
    # to choose among), so the later steps start from other coordinates
    check(c["jaccard_by_step"][0] >= 0.99,
          f"'auto' first step's pairs vs reduced_mnn 'auto': Jaccard "
          f"{c['jaccard_by_step'][0]:.5f} >= 0.99")
    line["gather_auto"] = {"seconds_first": auto_s, "seconds_second": auto_s2,
                           "profiled": auto_prof, "pair_jaccard_vs_reduced_mnn_auto": jac,
                           "vs_reduced_mnn_auto": c,
                           "launches": launches["distributed_fast_mnn_gather_auto"]}
    del mats, auto, ref_auto, ref, gather

    # checkpoints: an interrupted 3-batch run resumed, bit for bit
    rng = np.random.default_rng(SEED)
    small = [torch.from_numpy(simulate(rng, CKPT_N, DIMS, shift=0.4 * i)).cuda()
             for i in range(3)]
    ck_full = os.path.join(root, "build", "chip_smoke_dist_full")
    ck = os.path.join(root, "build", "chip_smoke_dist_ckpt")
    for d in (ck_full, ck):
        shutil.rmtree(d, ignore_errors=True)
    with deterministic(torch):
        full = dfm(small, mesh, k=K, checkpoint_dir=ck_full)
        dfm(small, mesh, k=K, checkpoint_dir=ck)
        meta_path = os.path.join(ck, "merge_meta.json")
        with open(meta_path) as fh:
            meta = json.load(fh)
        for name in ("step_0001.npz", "step_0001_data.npy"):
            os.remove(os.path.join(ck, name))
        meta["completed"] = 1
        with open(meta_path, "w") as fh:
            json.dump(meta, fh)
        resumed, resumed_s = sync_time(torch, lambda: dfm(small, mesh, k=K, checkpoint_dir=ck))
    for d in (ck_full, ck):
        shutil.rmtree(d, ignore_errors=True)
    check(torch.equal(resumed.corrected, full.corrected)
          and all(np.array_equal(a.pairs, b.pairs) and a.batch_size == b.batch_size
                  and np.array_equal(a.lost_var, b.lost_var)
                  for a, b in zip(resumed.merge_info, full.merge_info)),
          f"3 x {CKPT_N:,} checkpointed, interrupted after step 1, resumed: bit for bit "
          f"the uninterrupted run ({resumed_s:.3f} s)")
    line["checkpoint_resumed_seconds"] = resumed_s

    # out of core: quick_correct_csr with the mesh on phase 15's stores
    qkw = dict(hvg_n=HVG_N, d=DIMS, k=K, knn_method="exact", min_mean=UMI_MIN_MEAN)
    with deterministic(torch):
        single, single_s = sync_time(torch, lambda: bt.quick_correct_csr(stores, **qkw))
        meshed, mesh_s = sync_time(torch, lambda: bt.quick_correct_csr(stores, mesh=mesh, **qkw))
    n_ooc = sum(s.n_cells for s in stores)
    c = compare_runs(torch, np, meshed.corrected, single.corrected)
    print(f"  quick_correct_csr(mesh=): {mesh_s:.3f} s, without a mesh {single_s:.3f} s; pairs "
          f"{c['pairs']}, Jaccard {c['jaccard_by_step']}; {c['rows_beyond_1e-4']} of {n_ooc} "
          f"rows beyond 1e-4 x their max (quantiles 50/99/max {c['row_quantiles']})",
          flush=True)
    check(np.array_equal(meshed.hvgs, single.hvgs) and all(j == 1.0 for j in c["jaccard_by_step"]),
          "quick_correct_csr(mesh=): the same HVGs and identical pairs as without a mesh")
    check(c["rows_beyond_1e-4"] <= (1 - PAR_ROWS_MIN) * n_ooc,
          f"quick_correct_csr(mesh=): rows within 1e-4 x their max on >= 99.9% "
          f"({c['rows_beyond_1e-4']} beyond)")
    line["quick_correct_csr_mesh"] = {"seconds": mesh_s, "seconds_without_mesh": single_s, **c}
    return line, launches


def cli_run(root, argv):
    """``python -m batchelor_torch`` with ``argv`` from the repository root;
    its standard output, or a failure with its errors."""
    out = subprocess.run([sys.executable, "-m", "batchelor_torch", *argv], cwd=root,
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"python -m batchelor_torch {argv[0]} exits 0"
          + ("" if out.returncode == 0 else f":\n{out.stderr[-4000:]}"))
    return out.stdout


ATLAS_N = 47_250               # phase 17: hca_bone_marrow's cells a donor, 8 donors
TRICUBE_N = 36_000             # its last step's tricube search: the involved left cells


def k5_bound_ms(nq, nd, d):
    """d fp32 FMAs a score at the card's fp32 rate."""
    return 2.0 * d * nq * nd / FP32_FLOP_PER_S * 1e3


def knn_agreement(torch, got, want_i, want_sq, q, x, k):
    """(rows compared, rows whose neighbour sets differ, largest distance
    error over its terms' scale) of K5's ``got`` against the plain search's
    k + 1 neighbours: rows are compared where the plain k-th and (k+1)-th
    distances lie more than 2^-20 of their terms apart."""
    idx, sq = got
    qn = (q.double() ** 2).sum(1, keepdim=True)
    scale = qn + (x.double() ** 2).sum(1)[want_i]
    err = float(((sq.double() - want_sq[:, :k].double()).abs() / scale[:, :k]).max())
    apart = (want_sq[:, k].double() - want_sq[:, k - 1].double()) > 2.0**-20 * scale[:, k - 1]
    differ = (idx[apart].sort(1).values != want_i[apart, :k].sort(1).values).any(1)
    return int(apart.sum()), int(differ.sum()), err


def phase_k5(torch, np, knn_exact_cuda):
    """K5 against its plain version at the atlas's shapes; returns its entry."""
    from batchelor_torch.ops.knn import _knn_tiled

    print(f"phase 17: knn_exact (K5) against its plain version, 8 x {ATLAS_N:,} x {DIMS}, "
          f"k={K}", flush=True)
    rng = np.random.default_rng(SEED)
    batches = [torch.from_numpy(simulate(rng, ATLAS_N, DIMS, shift=0.3 * i)).cuda()
               for i in range(8)]
    left, right = torch.cat(batches[:7]), batches[7]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    involved = left[torch.randperm(left.shape[0], device="cuda", generator=gen)[:TRICUBE_N]]
    entries = []
    max_err = 0.0
    for label, q, x in (("mnn_right_to_left", right, left), ("mnn_left_to_right", left, right),
                        ("tricube", right, involved)):
        nq, nd = q.shape[0], x.shape[0]
        valid = torch.ones(nd, device="cuda", dtype=torch.bool)
        want_i, want_sq = _knn_tiled(q, x, K + 1, valid)
        rows, differ, err = knn_agreement(torch, knn_exact_cuda.knn_exact(q, x, K, valid),
                                          want_i, want_sq, q, x, K)
        del want_i, want_sq
        check(differ == 0 and err <= 1e-5,
              f"K5 {nq} x {nd}: the same neighbours on all {rows} rows apart from near-ties, "
              f"distances within 1e-5 of their terms ({err:.3g})")
        max_err = max(max_err, err)
        entry = {"label": label, "shape": [nq, nd, DIMS], "k": K, "rows_compared": rows,
                 "ms": cuda_ms(torch, lambda: knn_exact_cuda.knn_exact(q, x, K, valid), 10),
                 "plain_ms": cuda_ms(torch, lambda: _knn_tiled(q, x, K, valid), 3),
                 "bound_ms": k5_bound_ms(nq, nd, DIMS)}
        entry["fp32_fma_peak_pct"] = 100.0 * entry["bound_ms"] / entry["ms"]
        entries.append(entry)
        print(f"  {label}: K5 {entry['ms']:.3f} ms ({entry['fp32_fma_peak_pct']:.1f}% of the "
              f"fp32 FMA peak), plain {entry['plain_ms']:.3f} ms, bound "
              f"{entry['bound_ms']:.3f} ms", flush=True)
    main = entries[0]
    return {
        "name": "knn_exact", "route": "cuda", "source": "batchelor_torch/csrc/knn_exact.cu",
        "replaces": "batchelor_torch/ops/knn.py::_knn_tiled on the card",
        "launches": None, "max_dist_err": max_err,
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "operations (fp32 FMA)", "library_ms": None,
        "shape": main["shape"], "k": K, "other_shapes": entries[1:],
    }


TREND_SPAN = 0.3               # fit_trend_var's default span
CELL_GENES = 12_303            # phase 18: scib_immune_human_counts' genes
K6_FLOPS_A_PAIR = 24           # fp64 flops a query and window point, both passes


def k6_bound_ms(nq, window):
    """K6's fp64 flops at the card's fp64 rate."""
    return nq * window * K6_FLOPS_A_PAIR / FP64_FLOP_PER_S * 1e3


def k6_operands(torch, mean, total, span=TREND_SPAN):
    """(sorted positive means, their log-ratio to the fitted curve, window):
    what the card's fit_trend_var hands K6 for one batch's moments."""
    from batchelor_torch.correct import diagnostics as d

    x, y = mean.double(), total.double()
    pos = torch.isfinite(x) & torch.isfinite(y) & (x > 0) & (y > 0)
    n_pos = int(pos.sum())
    xs, ys = d._sorted_points(x, y, pos, n_pos)
    a, b, n, _ = d._parametric_curve_tensors(xs, ys)
    return xs, torch.log(ys / (a * xs / (xs**n + b))), d._window(span, n_pos)


def torch_local_linear(torch, xs, ys, q, window, chunk=1 << 24):
    """The plain smoother's chunked (queries, window) arithmetic written in
    torch on the card: the yardstick K6 replaces."""
    n = xs.numel()
    offs = torch.arange(window, device=xs.device)
    out = torch.empty_like(q)
    step = max(1, chunk // window)
    for c0 in range(0, q.numel(), step):
        qi = q[c0:c0 + step]
        lo = (torch.searchsorted(xs, qi) - window // 2).clamp(0, n - window)
        idx = lo[:, None] + offs
        xw, yw = xs[idx], ys[idx]
        dist = (xw - qi[:, None]).abs()
        h = dist.amax(1, keepdim=True).clamp_min(1e-12)
        w = (1 - (dist / h).clamp_max(1.0) ** 3) ** 3
        sw = w.sum(1)
        sw_safe = sw.clamp_min(1e-300)
        xm = (w * xw).sum(1) / sw_safe
        ym = (w * yw).sum(1) / sw_safe
        dx = xw - xm[:, None]
        den = (w * dx**2).sum(1)
        num = (w * dx * (yw - ym[:, None])).sum(1)
        slope = torch.where(den > 1e-12, num / den.clamp_min(1e-12), 0.0)
        out[c0:c0 + step] = torch.where(sw > 0, ym + slope * (qi - xm), yw.mean(1))
    return out


def phase_k6(torch, np, bt, trend_cuda):
    """K6 against its plain version on the trend fits' own operands; returns its entry."""
    from batchelor_torch.correct.diagnostics import _sorted_local_linear

    print(f"phase 18: trend_smooth (K6) against its plain version, the smoothed log-ratio of "
          f"2 x {QC_N:,} x {QC_GENES:,} and 2 x 5,000 x {CELL_GENES:,} counts", flush=True)
    entries = []
    max_err = 0.0
    for label, n, genes in (("quick_correct_phase_12", QC_N, QC_GENES),
                            ("scib_counts_width", 5_000, CELL_GENES)):
        counts = quick_counts(torch, n, genes)
        logs = bt.multi_batch_norm(counts, device="cuda").logcounts
        del counts
        moments = [(lg.mean(0), torch.var(lg, dim=0, correction=1)) for lg in logs]
        del logs
        for b, (mean, total) in enumerate(moments):
            xs, ys, window = k6_operands(torch, mean, total)
            q = mean.double()
            # tied (every 7th point), out-of-range and non-finite queries beside the genes'
            extra = torch.tensor([-1.0, 0.0, float("nan"), float("inf"), float("-inf")],
                                 dtype=torch.float64, device="cuda")
            probes = torch.cat([q, xs[::7], xs[[0, -1]], xs[-1:] + 1.0, extra])
            got = trend_cuda.local_linear(xs, ys, probes, window).cpu().numpy()
            xs_h, ys_h, probes_h = (t.cpu().numpy() for t in (xs, ys, probes))
            plain = _sorted_local_linear(xs_h, ys_h, window)
            want = plain(probes_h)
            yard = torch_local_linear(torch, xs, ys, probes, window).cpu().numpy()
            err = float((np.abs(got - want) / (np.abs(ys_h).max() + np.abs(want))).max())
            check(bool(np.isfinite(got).all()) and err <= 1e-10,
                  f"K6 {label} batch {b}: {probes.numel()} queries over {xs.numel()} points, "
                  f"W = {window}, within 1e-10 of max|ys| + |plain| ({err:.3g})")
            yard_err = float((np.abs(yard - want) / (np.abs(ys_h).max() + np.abs(want))).max())
            check(yard_err <= 1e-10, f"the torch yardstick {label} batch {b} within 1e-10 of "
                                     f"the plain version ({yard_err:.3g})")
            max_err = max(max_err, err)
            q_h = q.cpu().numpy()
            t0 = time.perf_counter()
            for _ in range(3):
                plain(q_h)
            plain_ms = (time.perf_counter() - t0) / 3 * 1e3
            nq = q.numel()
            entry = {"label": f"{label}_batch_{b}", "queries": nq, "points": int(xs.numel()),
                     "window": window,
                     "ms": cuda_ms(torch, lambda: trend_cuda.local_linear(xs, ys, q, window), 20),
                     "plain_ms": plain_ms,
                     "torch_ms": cuda_ms(torch, lambda: torch_local_linear(torch, xs, ys, q,
                                                                           window), 5),
                     "bound_ms": k6_bound_ms(nq, window)}
            entry["fp64_peak_pct"] = 100.0 * entry["bound_ms"] / entry["ms"]
            entries.append(entry)
            print(f"  {entry['label']}: {nq} queries x {xs.numel()} points, W = {window}: "
                  f"K6 {entry['ms']:.4f} ms ({entry['fp64_peak_pct']:.1f}% of the fp64 peak), "
                  f"plain {plain_ms:.1f} ms, torch on the card {entry['torch_ms']:.3f} ms, "
                  f"bound {entry['bound_ms']:.4f} ms", flush=True)
        del moments
    main = max(entries, key=lambda e: e["queries"] * e["window"])
    return {
        "name": "local_linear", "route": "cuda", "source": "batchelor_torch/csrc/trend_smooth.cu",
        "replaces": "batchelor_torch/correct/diagnostics.py::_sorted_local_linear on the host",
        "launches": None, "max_rel_err": max_err,
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "operations (fp64)", "library_ms": main["torch_ms"],
        "library": "the plain smoother's chunked arithmetic in torch on the card",
        "shape": [main["queries"], main["points"], main["window"]], "other_shapes": entries,
    }


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import batchelor_torch as bt
    from batchelor_torch import _build
    from batchelor_torch.ops import (knn_cuda, knn_exact_cuda, pass1_cuda, rescore_cuda, topk_cuda,
                                     trend_cuda)

    build_s = _build.build()
    print(f"build: {build_s:.3f} s for {len(_build.KERNELS)} kernels", flush=True)

    rng = np.random.default_rng(SEED)
    b1 = simulate(rng, N_CELLS, DIMS)
    b2 = simulate(rng, N_CELLS, DIMS, shift=0.8)
    path_kernels = [knn_cuda.chunk_max_scores, topk_cuda.topk_rows,
                    rescore_cuda.rescore_subchunks, knn_exact_cuda.knn_exact,
                    trend_cuda.local_linear]

    phase_s = {0: build_s}

    def timed(n, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[n] = time.perf_counter() - t0
        print(f"  phase {n}: {phase_s[n]:.1f} s", flush=True)
        return out

    root = os.path.dirname(os.path.abspath(__file__))
    k2 = timed(1, phase_k2, torch, topk_cuda)
    k1 = timed(2, phase_k1, torch, knn_cuda, b1, b2)
    launches, seconds, seconds_again, n_auto, n_exact, jaccard = timed(
        3, phase_main_path, torch, np, bt, path_kernels, b1, b2)
    timed(4, phase_card_vs_cpu, torch, np, bt)
    k3 = timed(5, phase_k3, torch, knn_cuda, rescore_cuda, topk_cuda, b1, b2)
    k4, probe = timed(6, phase_k4, torch, np, knn_cuda, pass1_cuda)
    fast_launches, chunked_launches, fast_line = timed(
        7, phase_fast_mnn, torch, np, bt, path_kernels)
    config3 = timed(8, phase_config3_card_vs_cpu, torch, np, bt)
    fused_line = timed(9, phase_fused, torch, np, bt, path_kernels, b1, b2)
    classic_line = timed(10, phase_classic, torch, np, bt, path_kernels)
    ckpt_line = timed(11, phase_checkpoint, torch, np, bt, root)
    qc_line, qc, counts, qc_launches = timed(12, phase_quick_correct, torch, np, bt, path_kernels)
    cluster_line, labels, cluster_launches = timed(13, phase_cluster, torch, np, bt, path_kernels)
    engines_line = timed(14, phase_engines, torch, np, bt, qc, counts, labels)
    del qc, counts, labels
    ooc_line, ooc_launches, stores = timed(15, phase_outofcore, torch, np, bt, path_kernels,
                                           root)
    par_line, par_launches = timed(16, phase_parallel, torch, np, bt, path_kernels, root,
                                   stores)
    del stores
    k5 = timed(17, phase_k5, torch, np, knn_exact_cuda)
    k6 = timed(18, phase_k6, torch, np, bt, trend_cuda)

    for entry in (k1, k2, k3, k5, k6):
        entry["launches"] = launches[entry["name"]]
        entry["launches_by_path"] = {
            "reduced_mnn": launches[entry["name"]],
            "fast_mnn": fast_launches[entry["name"]],
            "fast_mnn_chunked": chunked_launches[entry["name"]],
            "fused_merge_step": fused_line["auto"]["launches"][entry["name"]],
            "fused_merge_step_exact": fused_line["exact"]["launches"][entry["name"]],
            "mnn_correct": classic_line["launches"][entry["name"]],
            "quick_correct": qc_launches[entry["name"]],
            "cluster_mnn": cluster_launches[entry["name"]],
            **{path: ooc_launches[path][entry["name"]]
               for path in ("quick_correct_csr", "cluster_mnn_csr", "mnn_correct_csr")},
            **{path: counts[entry["name"]] for path, counts in par_launches.items()}}
    k4["launches_by_path"] = {"pass1_precision_probe": k4["launches"]}
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6]}), flush=True)
    print(json.dumps({"main_path": "reduced_mnn 2x100000x50 k=20 auto",
                      "seconds": seconds, "seconds_second_run": seconds_again,
                      "cells_per_s": 2 * N_CELLS / seconds,
                      "cells_per_s_second_run": 2 * N_CELLS / seconds_again,
                      "pairs_auto": n_auto, "pairs_exact": n_exact,
                      "pair_jaccard": jaccard, "build_s": build_s}), flush=True)
    print(json.dumps(fast_line), flush=True)
    print(json.dumps({"pass1_precision_probe": probe,
                      "config3_card_vs_cpu": config3}), flush=True)
    print(json.dumps(fused_line), flush=True)
    print(json.dumps(classic_line), flush=True)
    print(json.dumps(ckpt_line), flush=True)
    print(json.dumps(qc_line), flush=True)
    print(json.dumps(cluster_line), flush=True)
    print(json.dumps(engines_line), flush=True)
    print(json.dumps(ooc_line), flush=True)
    print(json.dumps(par_line), flush=True)
    print(json.dumps({"phase_seconds": phase_s}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
