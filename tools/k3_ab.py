#!/usr/bin/env python3
"""K3 (rescore_subchunks), the current kernel against an earlier commit's, on the card.

    python3 tools/k3_ab.py [--baseline-csrc DIR] [--csrc NAME=DIR ...]
                           [--variant NAME=FLAGS ...] [--reps 10] [--rounds 3]
                           [--profile] [--inputs path,imbalanced]

Builds csrc/rescore_chunks.cu and, with --baseline-csrc, the
rescore_chunks.cu in DIR (for example an earlier commit's sources, unpacked
by git archive), the one in each --csrc DIR, and each --variant (the
current source with extra nvcc flags, for example p128=-DRESCORE_SLOTS=128),
all nvcc started together, with ptxas's report of each kernel's registers
and spills. A source whose launch function takes no scratch (the
one-warp-a-query kernel before the sub-chunk sort) is called with its own
arguments. The default inputs (--inputs path), d = 50 and ks = 20:
  - the main path's own: the two MNN searches of reduced_mnn on
    chip_smoke.py's 2 x 100,000 x 50 batches (seed 42, k = 20, "auto"),
    recorded at the rescore's call;
  - the same for fast_mnn's PCs (2 x 100,000 x 2,000 genes, d = 50);
  - uniform random ids over the first search's 3,136 sub-chunks;
  - hub only: every query selects sub-chunks 0-19;
  - wide: 100,000 queries, uniform ids over 196,608 sub-chunks (data3 1.26 GB),
    then 32,768, 16,384 and 4,096 queries over the same (3.3 down to 0.4
    slots a sub-chunk; 4,096 is chip_smoke.py's wide check), which place
    RESCORE_SORT_MIN: build the source twice, with -DRESCORE_SORT_MIN=0 and
    with -DRESCORE_SORT_MIN=1e9, to time each path on every input.
--inputs imbalanced records the rescore calls of reduced_mnn on a small
batch (500, 2,000 and 8,000 cells) against 1,000,000 cells at d = 20, 50
and 100: real selections with few slots a sub-chunk.
For each input it prints the bucket statistics (slots per sub-chunk over
all sub-chunks: unique, median, p99, max; segments per 64-slot item) and
times every version in rounds (each round times them in turn, forwards
then backwards; a time is the median over the rounds of the median of
--reps CUDA-event timings), with the bound (chip_smoke.py's k3_bound_ms)
and the plain version's time. Each version must lie within 2^-20 of the
row's max |score| of the plain version, with the same -inf entries. With
--profile it also counts and times each version's kernels (and memsets)
apart, by torch.profiler over --reps calls (chip_smoke.py's device_kernels). Prints one JSON line, then the card's
name and power limit. Exits non-zero if any version disagrees.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path


def build(versions, out_dir):
    """versions: name -> (source dir, extra nvcc flags). Returns name ->
    (launch function, whether it takes scratch) and ptxas's reports."""
    from batchelor_torch import _build
    from split_walk_ab import ptxas_summary

    jobs = []
    for name, (src, flags) in versions.items():
        out = out_dir / f"librescore_chunks-{name}.so"
        source = Path(src) / "rescore_chunks.cu"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o", str(out),
               str(source)]
        scratch = "int* work" in source.read_text()
        jobs.append((name, out, scratch, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                          stderr=subprocess.STDOUT, text=True)))
    fns, regs = {}, {}
    for name, out, scratch, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} rescore_chunks.cu:\n{log}")
        fn = ctypes.CDLL(str(out)).rescore_subchunks_launch
        n_int = 4 if scratch else 3
        fn.argtypes = ([ctypes.c_void_p] * (6 if scratch else 5) + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = (fn, scratch)
        regs[name] = [{"kernel": k, "registers": r, "spill_stores": s, "spill_loads": l}
                      for k, r, s, l in ptxas_summary(log)]
    return fns, regs


def record_rescore_calls(torch, knn_cuda, runs):
    """runs: (label, callable) pairs. Returns (label search n, (q, data3,
    dn2, top_sub)) for every rescore call that each callable makes."""
    calls = []
    inner = knn_cuda.rescore_subchunks

    def recorder(q, data3, dn2, top_sub):
        calls.append((q, data3, dn2, top_sub))
        return inner(q, data3, dn2, top_sub)

    inputs = []
    knn_cuda.rescore_subchunks = recorder
    try:
        for label, run in runs:
            calls.clear()
            run()
            torch.cuda.synchronize()
            inputs += [(f"{label} search {n + 1}", call) for n, call in enumerate(calls)]
    finally:
        knn_cuda.rescore_subchunks = inner
    return inputs


def record_path_inputs(torch, np, bt, knn_cuda):
    """The (q, data3, dn2, top_sub) of every rescore call of reduced_mnn and
    of fast_mnn ("auto") on chip_smoke.py's data."""
    from chip_smoke import DIMS, GENES, K, N_CELLS, SEED, simulate

    rng = np.random.default_rng(SEED)
    reduced = [torch.from_numpy(simulate(rng, N_CELLS, DIMS)).cuda(),
               torch.from_numpy(simulate(rng, N_CELLS, DIMS, shift=0.8)).cuda()]
    rng = np.random.default_rng(SEED)
    genes = [torch.from_numpy(simulate(rng, N_CELLS, GENES)).cuda(),
             torch.from_numpy(simulate(rng, N_CELLS, GENES, shift=0.8)).cuda()]
    return record_rescore_calls(torch, knn_cuda, (
        ("reduced_mnn", lambda: bt.reduced_mnn(reduced, k=K, knn_method="auto")),
        ("fast_mnn", lambda: bt.fast_mnn(genes, d=DIMS, k=K, knn_method="auto"))))


IMBALANCED_LARGE = 1_000_000
IMBALANCED_SMALL = (500, 2_000, 8_000)
IMBALANCED_DIMS = (20, 50, 100)


def record_imbalanced_inputs(torch, np, bt, knn_cuda):
    """The rescore calls of reduced_mnn ("auto", k = 20) on a small batch
    against a large one (IMBALANCED_SMALL cells against IMBALANCED_LARGE, at
    each of IMBALANCED_DIMS; chip_smoke.py's simulation, seed 42): search 1
    takes the small batch's cells as queries against the large batch's
    sub-chunks, a selection with few slots a sub-chunk but real sharing."""
    from chip_smoke import K, SEED, simulate

    inputs = []
    for d in IMBALANCED_DIMS:
        rng = np.random.default_rng(SEED)
        small = torch.from_numpy(simulate(rng, max(IMBALANCED_SMALL), d)).cuda()
        large = torch.from_numpy(simulate(rng, IMBALANCED_LARGE, d, shift=0.8)).cuda()
        inputs += record_rescore_calls(torch, knn_cuda, [
            (f"d={d}, {n:,} against {IMBALANCED_LARGE:,}",
             lambda n=n: bt.reduced_mnn([small[:n].contiguous(), large], k=K,
                                        knn_method="auto"))
            for n in IMBALANCED_SMALL])
        del small, large
    return inputs


def main():
    import torch

    if not torch.cuda.is_available():
        print("k3_ab: needs a CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(here), here]
    import numpy as np

    import batchelor_torch as bt
    from batchelor_torch import _build
    from batchelor_torch.ops import knn_cuda, rescore_cuda
    from chip_smoke import (K1_TOL, SEED, cuda_ms, device_kernels, k3_bound_ms,
                            k3_bucket_stats, k3_wide_inputs)

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline-csrc", default=None)
    ap.add_argument("--csrc", action="append", default=[],
                    help="NAME=DIR: another source directory to time")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS: the current source built with extra nvcc flags")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--inputs", default="path",
                    help="comma list: path (the default set above), imbalanced")
    args = ap.parse_args()
    args.inputs = args.inputs.split(",")
    versions = {"current": (str(_build.CSRC), [])}
    if args.baseline_csrc:
        versions["base"] = (args.baseline_csrc, [])
    for spec in args.csrc:
        name, src = spec.split("=", 1)
        versions[name] = (src, [])
    for spec in args.variant:
        name, flags = spec.split("=", 1)
        versions[name] = (str(_build.CSRC), flags.split())

    _build.build()
    inputs = []
    if "path" in args.inputs:
        inputs = record_path_inputs(torch, np, bt, knn_cuda)
        q0, data0, dn0, ids0 = inputs[0][1]
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        nq0, ks0 = ids0.shape
        c0 = data0.shape[0]
        inputs.append(("uniform", (q0, data0, dn0, torch.randint(
            0, c0, (nq0, ks0), device="cuda", generator=gen))))
        inputs.append(("hub only", (q0, data0, dn0,
                                    torch.arange(ks0, device="cuda").repeat(nq0, 1).contiguous())))
        inputs.append(("wide", k3_wide_inputs(torch, gen, nq0)))
        for nq in (32768, 16384, 4096):
            inputs.append((f"wide, {nq:,} queries", k3_wide_inputs(torch, gen, nq)))
    if "imbalanced" in args.inputs:
        inputs += record_imbalanced_inputs(torch, np, bt, knn_cuda)
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        fns, regs = build(versions, Path(tmp))
        for label, (q, data3, dn2, top_sub) in inputs:
            nq, d = q.shape
            c32 = data3.shape[0]
            ks = top_sub.shape[1]
            work = torch.empty(rescore_cuda.workspace_ints(nq, ks, c32), device="cuda",
                               dtype=torch.int32)
            outs = {v: torch.empty((nq, ks * 32), device="cuda") for v in versions}

            def call(v, q=q, data3=data3, dn2=dn2, top_sub=top_sub, work=work, outs=outs,
                     nq=nq, ks=ks, d=d, c32=c32):
                fn, scratch = fns[v]
                ptrs = [q.data_ptr(), data3.data_ptr(), dn2.data_ptr(), top_sub.data_ptr(),
                        outs[v].data_ptr()]
                err = (fn(*ptrs, work.data_ptr(), nq, ks, d, c32, stream) if scratch
                       else fn(*ptrs, nq, ks, d, stream))
                if err:
                    raise RuntimeError(f"{v}: rescore_subchunks_launch returned {err}")

            names = list(versions)
            times = {v: [] for v in names}
            for r in range(args.rounds):
                for v in (names if r % 2 == 0 else names[::-1]):
                    times[v].append(cuda_ms(torch, lambda v=v: call(v), args.reps))
            want = rescore_cuda.rescore_subchunks_plain(q, data3, dn2, top_sub)
            plain_ms = cuda_ms(torch, lambda: rescore_cuda.rescore_subchunks_plain(
                q, data3, dn2, top_sub), 3)
            torch.cuda.synchronize()
            inf = torch.isinf(want)
            scale = torch.where(inf, 0.0, want.abs()).amax(1, keepdim=True)
            agree, worst = {}, {}
            for v in versions:
                got = outs[v]
                same_inf = torch.equal(inf, torch.isinf(got)) and bool((got[inf] < 0).all())
                diff = torch.where(inf, 0.0, got - want).abs()
                worst[v] = float((diff / scale).max())
                agree[v] = bool(same_inf and bool((diff <= K1_TOL * scale).all()))
            ok = ok and all(agree.values())
            buckets = k3_bucket_stats(torch, top_sub, c32,
                                      rescore_cuda.kernel_plan(nq, ks, c32)[1])
            bound_ms, bound_by = k3_bound_ms(nq, ks, d, buckets["unique"])
            results[label] = {
                "shape": [nq, ks, d, c32], "buckets": buckets,
                "kernels": ({v: device_kernels(torch, lambda v=v: call(v), args.reps)
                             for v in names} if args.profile else None),
                "ms": {v: float(np.median(times[v])) for v in names}, "rounds_ms": times,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "agrees_with_plain": agree, "worst_rel_err": worst,
            }
            print(f"  {label} {results[label]['shape']}: buckets mean {buckets['mean']:.3f}, unique {buckets['unique']}, "
                  f"median {buckets['median']}, p99 {buckets['p99']}, max {buckets['max']}, "
                  f"segments/item max {buckets['segments_per_item_max']} mean "
                  f"{buckets['segments_per_item_mean']:.2f}; "
                  + ", ".join(f"{v} {results[label]['ms'][v]:.4f} ms" for v in names)
                  + f", plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
                  f"agree {agree}", flush=True)
            if args.profile:
                print(f"    kernels [runs, ms] a call: {results[label]['kernels']}", flush=True)
            del outs, work, want
    print(json.dumps({"inputs": results, "ptxas": regs, "all_agree": ok}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
