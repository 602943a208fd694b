#!/usr/bin/env python3
"""How far quick_correct_csr on the card departs from the CPU's, and why.

    python3 tools/csr_card_vs_cpu.py

Runs quick_correct_csr on the card and on the CPU (fp32 CSR on both
sides) for two small inputs: chip_smoke.py phase 15's 2 x 2,000 x 500
droplet counts (hvg_n=200, d=50, k=20) and the 2 x ~850 x 400 twelve-type
counts of tests/test_torch_cuda.py::test_quick_correct_csr_card_matches_cpu
(hvg_n=150, d=6, k=15). For each it prints one JSON line:

  * the pair Jaccard and the corrected values in gene space (corrected @
    rotation.T, blind to turns within the kept subspace): the share of rows
    within 1e-4 x max and the largest row's error;
  * the PCA: the sine of the largest principal angle between the card's and
    the CPU's kept subspaces, and the relative gap of the fp64 Gram's
    eigenvalues at the cut, (l_d - l_{d+1}) / l_1;
  * the merge alone: the CPU's run again on the card's PCA stage (shared
    through ``pca_cache_dir``), its pair Jaccard and largest gene-space error;
  * the rows whose tricube neighbour sets (the last kNN of the merge) differ
    between card and CPU, and how many of the rows beyond 1e-4 are among
    them.

Then the card's name and power limit.
"""
import json
import os
import subprocess
import sys
import tempfile


def gene_space(res):
    return res.corrected.cpu().double() @ res.rotation.cpu().double().T


def compare(torch, np, bt, stores, kw, label):
    from batchelor_torch.correct import outofcore
    from chip_smoke import tricube_neighbours

    with tempfile.TemporaryDirectory() as cache:
        gpu, nb_gpu = tricube_neighbours(
            lambda: bt.quick_correct_csr(stores, pca_cache_dir=cache, **kw))
        cpu, nb_cpu = tricube_neighbours(
            lambda: bt.quick_correct_csr(stores, device="cpu", **kw))
        shared = bt.quick_correct_csr(stores, device="cpu", pca_cache_dir=cache, **kw)
    n = sum(s.n_cells for s in stores)

    def pairs(res):
        p = res.corrected.merge_info[0].pairs.astype(np.int64)
        return p[:, 0] * n + p[:, 1]

    def jaccard(a, b):
        return np.intersect1d(a, b).size / np.union1d(a, b).size

    want = gene_space(cpu.corrected)
    scale = float(want.abs().max())
    row_err = ((gene_space(gpu.corrected) - want).abs().amax(1) / scale).numpy()
    shared_err = float((gene_space(shared.corrected) - gene_space(gpu.corrected)).abs().max()
                       / float(gene_space(gpu.corrected).abs().max()))
    ra = gpu.corrected.rotation.cpu().double().numpy()
    rb = cpu.corrected.rotation.cpu().double().numpy()
    sin = float(np.linalg.norm(ra - rb @ (rb.T @ ra), 2))

    # the fp64 Gram of the HVG stores as quick_correct_csr weights them
    sfs = [(lib / lib.mean()).astype(np.float32) for lib in (s.row_sums() for s in stores)]
    avgs = [outofcore._stream_stats(s, sf, 2.0)[0] for s, sf in zip(stores, sfs)]
    sfs = [np.asarray(r, np.float32) for r in outofcore.rescale_size_factors(
        avgs, sfs, min_mean=kw.get("min_mean", 1.0))]
    xs = [outofcore._lognorm_cosine_csr(s.select_genes(cpu.hvgs), sf, 2.0, True)
          .to_dense().astype(np.float64) for s, sf in zip(stores, sfs)]
    center = np.mean([x.mean(0) for x in xs], 0)
    gram = sum((x - center).T @ (x - center) / x.shape[0] for x in xs)
    lam = np.sort(np.linalg.eigvalsh(gram))[::-1]
    d = kw["d"]

    # the rows (of the second batch, the merge's right side) whose tricube
    # neighbours differ
    right0 = stores[0].n_cells
    moved = np.flatnonzero([set(a) != set(b) for a, b in zip(nb_gpu, nb_cpu)])
    beyond = np.flatnonzero(row_err > 1e-4)
    line = {
        "input": label,
        "pairs": int(pairs(cpu).size),
        "pair_jaccard": jaccard(pairs(gpu), pairs(cpu)),
        "rows_within_1e-4": float((row_err <= 1e-4).mean()),
        "largest_row_err_rel": float(row_err.max()),
        "rows_beyond_1e-4": beyond.tolist(),
        "pca_subspace_sin": sin,
        "eig_gap_at_cut_rel": float((lam[d - 1] - lam[d]) / lam[0]),
        "merge_on_card_pca_pair_jaccard": jaccard(pairs(shared), pairs(gpu)),
        "merge_on_card_pca_err_rel": shared_err,
        "rows_with_other_tricube_neighbours": (moved + right0).tolist(),
        "rows_beyond_1e-4_with_other_neighbours": int(np.isin(beyond, moved + right0).sum()),
    }
    print(json.dumps(line), flush=True)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("csr_card_vs_cpu: needs a CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import batchelor_torch as bt
    from chip_smoke import DIMS, K, UMI_MIN_MEAN, card_to_csr, droplet_counts

    counts, _ = droplet_counts(torch, 2000, 500, log_shift=-2.5)
    stores = [card_to_csr(torch, np, bt, c) for c in counts]
    compare(torch, np, bt, stores, dict(hvg_n=200, d=DIMS, k=K, min_mean=UMI_MIN_MEAN),
            "chip_smoke phase 15, 2 x 2,000 x 500 droplet counts")

    rng = np.random.default_rng(26)
    lam = np.exp(rng.normal(size=(12, 400)) - 1.5)
    stores = [bt.CSRCells.from_dense(rng.poisson(lam[rng.integers(0, 12, n)] * s)
                                     .astype(np.float32)) for n, s in ((900, 1.0), (800, 1.6))]
    compare(torch, np, bt, stores, dict(hvg_n=150, d=6, k=15, block_rows=512),
            "test_quick_correct_csr_card_matches_cpu, 12 types")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
