#!/usr/bin/env python3
"""K1's bf16 mode, the current kernel against an earlier commit's, on the card.

    python3 tools/k1_bf16_ab.py [--baseline-csrc DIR] [--reps 5] [--rounds 3]

Builds csrc/chunk_max.cu and, with --baseline-csrc, the chunk_max.cu in DIR
(for example an earlier commit's sources, unpacked by git archive), all nvcc
started together, with ptxas's report of each bf16 kernel's registers and
spills. Then times mode 0 (bf16) of both at chip_smoke.py's main-path
operands (100352^2 x 64, seed 42) in rounds: each round times every
version in turn, forwards then backwards, and a version's time is the
median over the rounds of the median of --reps CUDA-event timings. The
current kernel stores its maxima query-major, (N_q, N_d/32); a baseline
from before it stores them data-major, (N_d/32, N_q) (--baseline-layout
query for one that does not). Reports the largest difference between the
versions relative to each query column's max |score| and whether they are
bit for bit identical, the library call (torch.matmul in bf16, then the
32-row max, as chip_smoke.py times it) in the same rounds, the bound,
and the L2 bytes the current kernel's TMA loads read, counted from the
shapes (each 256-row data tile reads every query row once). Prints one JSON
line, then the card's name and power limit.
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
    from batchelor_torch import _build
    from split_walk_ab import ptxas_summary

    jobs = []
    for name, src in versions.items():
        out = out_dir / f"libchunk_max-{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
               str(Path(src) / "chunk_max.cu")]
        jobs.append((name, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    fns, regs = {}, {}
    for name, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} chunk_max.cu:\n{log}")
        fn = ctypes.CDLL(str(out)).chunk_max_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
        regs[name] = [{"kernel": k, "registers": r, "spill_stores": s, "spill_loads": l}
                      for k, r, s, l in ptxas_summary(log) if "bf16" in k]
    return fns, regs


def main():
    import torch

    if not torch.cuda.is_available():
        print("k1_bf16_ab: needs a CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    sys.path[:0] = [root, here]
    import numpy as np

    from batchelor_torch import _build
    from batchelor_torch.ops import knn_cuda
    from chip_smoke import (BF16_FLOP_PER_S, DIMS, HBM_BYTES_PER_S, N_CELLS, SEED, cuda_ms,
                            simulate)

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline-csrc", default=None)
    ap.add_argument("--baseline-layout", default="data", choices=["data", "query"])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    versions = {"current": str(_build.CSRC)}
    if args.baseline_csrc:
        versions["base"] = args.baseline_csrc
    query_major = {"current": True, "base": args.baseline_layout == "query"}

    with tempfile.TemporaryDirectory() as tmp:
        fns, regs = build(versions, Path(tmp))
        rng = np.random.default_rng(SEED)
        b1 = torch.from_numpy(simulate(rng, N_CELLS, DIMS)).cuda()
        b2 = torch.from_numpy(simulate(rng, N_CELLS, DIMS, shift=0.8)).cuda()
        q, x = knn_cuda._pass1_operands(b1, b2, torch.ones(N_CELLS, dtype=torch.bool,
                                                           device="cuda"), bf16=True)
        nq, dp = q.shape
        nd = x.shape[0]
        stream = torch.cuda.current_stream().cuda_stream
        outs = {v: torch.empty((nq, nd // 32) if query_major[v] else (nd // 32, nq),
                               device="cuda") for v in versions}

        def call(v):
            err = fns[v](q.data_ptr(), x.data_ptr(), outs[v].data_ptr(), nq, nd, dp, 0, stream)
            if err:
                raise RuntimeError(f"{v}: chunk_max_launch returned {err}")

        def library():                  # chip_smoke.py phase 2's yardstick for bf16
            for q0 in range(0, nq, 8192):
                (x @ q[q0:q0 + 8192].T).view(nd // 32, 32, -1).amax(1)

        timed = {**{v: (lambda v=v: call(v)) for v in versions}, "library": library}
        names = list(timed)
        times = {n: [] for n in names}
        for r in range(args.rounds):
            for n in (names if r % 2 == 0 else names[::-1]):
                times[n].append(cuda_ms(torch, timed[n], args.reps))
        torch.cuda.synchronize()
        views = {v: outs[v].t() if query_major[v] else outs[v] for v in versions}
        ref = views["current"]
        scale = ref.abs().amax(0, keepdim=True)
        diffs = {v: float(((views[v] - ref).abs() / scale).max()) for v in versions}
        identical = {v: bool(torch.equal(views[v].view(torch.int32), ref.view(torch.int32)))
                     for v in versions}
        del outs, views, ref
    flops = 2.0 * nq * nd * dp
    io_bytes = (nq + nd) * dp * 2 + (nd // 32) * nq * 4
    n_dt = -(-nd // 256)
    result = {
        "shape": [nq, nd, dp],
        "ms": {n: float(np.median(times[n])) for n in names},
        "rounds_ms": times,
        "max_rel_diff_vs_current": diffs,
        "bit_identical_to_current": identical,
        "bound_ms": max(flops / BF16_FLOP_PER_S, io_bytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / BF16_FLOP_PER_S >= io_bytes / HBM_BYTES_PER_S
        else "bytes",
        "current_l2_read_bytes": n_dt * nq * dp * 2 + n_dt * 256 * dp * 2,
        "ptxas": regs,
    }
    print(json.dumps(result), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
