#!/usr/bin/env python3
"""End-to-end seconds of the port's paths, one tree against another, on the card.

    python3 tools/path_ab.py --trees DIR_A,DIR_B [--runs 3]

Each tree is a checkout of the repository (for example an earlier commit
unpacked by git archive into a directory that .gitignore lists, and "."
for this one). The trees run in the order A, B, B, A, each in a fresh
process that imports batchelor_torch and chip_smoke.py's simulation from
that tree and builds its kernels. A process times reduced_mnn (2 x 100,000
x 50, k = 20, "auto") and fast_mnn (2 x 100,000 x 2,000 genes, d = 50,
k = 20, "auto" and "chunked"): a first run, then --runs steady runs each,
by the host clock around the call ending in torch.cuda.synchronize(), on
chip_smoke.py's data (seed 42). Prints one JSON line per process, then per
tree and path the median of the steady runs of both its processes, then
the card's name and power limit.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

PATHS = (("reduced_mnn", "auto"), ("fast_mnn", "auto"), ("fast_mnn", "chunked"))


def worker(tree, runs):
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np

    import batchelor_torch as bt
    from batchelor_torch import _build
    from chip_smoke import DIMS, GENES, K, N_CELLS, SEED, simulate

    _build.build()
    rng = np.random.default_rng(SEED)
    reduced = [torch.from_numpy(simulate(rng, N_CELLS, DIMS)).cuda(),
               torch.from_numpy(simulate(rng, N_CELLS, DIMS, shift=0.8)).cuda()]
    rng = np.random.default_rng(SEED)
    genes = [torch.from_numpy(simulate(rng, N_CELLS, GENES)).cuda(),
             torch.from_numpy(simulate(rng, N_CELLS, GENES, shift=0.8)).cuda()]
    out = {"tree": tree}
    for path, method in PATHS:
        kw = {"k": K, "knn_method": method}
        if path == "fast_mnn":
            kw["d"] = DIMS
        batches = reduced if path == "reduced_mnn" else genes
        seconds = []
        for _ in range(runs + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            getattr(bt, path)(batches, **kw)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        out[f"{path} {method}"] = {"first_s": seconds[0], "steady_s": seconds[1:]}
    print(json.dumps(out), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", required=True)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--worker", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("path_ab: needs a CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        return worker(args.worker, args.runs)
    a, b = args.trees.split(",")
    results = {a: [], b: []}
    for tree in (a, b, b, a):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--trees", args.trees,
                               "--runs", str(args.runs), "--worker", tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"worker for {tree} failed:\n{proc.stderr[-4000:]}")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results[tree].append(json.loads(line))
    summary = {tree: {f"{p} {m}": statistics.median(
        s for r in rs for s in r[f"{p} {m}"]["steady_s"]) for p, m in PATHS}
        for tree, rs in results.items()}
    print(json.dumps({"median_steady_s": summary}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
