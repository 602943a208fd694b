#!/usr/bin/env python3
"""K4's bf16 mode, the current kernel against an earlier commit's, on the card.

    python3 tools/k4_bf16_ab.py [--baseline-csrc DIR] [--csrc NAME=DIR ...]
                                [--reps 5] [--rounds 3]

Builds csrc/pass1_norm.cu and, with --baseline-csrc, the pass1_norm.cu in
DIR (for example an earlier commit's sources, unpacked by git archive), all
nvcc started together, with ptxas's report of the registers and spills of
each version's bf16 kernel. Then times mode 0 (bf16) of both on
chip_smoke.py phase 6's operands (the precision probe's 98304^2 x 50
normal data, seed 0, padded to 64 features, rows 1000-1099 masked) in
rounds: each round times every version in turn, forwards then backwards,
and a version's time is the median over the rounds of the median of --reps
CUDA-event timings.

The current kernel takes q and x in bf16 and stores its maxima
query-major, (N_q, N_d/32): "current" times it with the casts from fp32
that pass1_scores makes before it, "current_kernel" the kernel alone on
operands cast before. A baseline from before it (--baseline-layout data)
takes fp32 q and x and stores data-major, (N_d/32, N_q); --baseline-layout
query times a baseline of the current kind, and each --csrc NAME=DIR
times one more copy of the sources of the current kind. Reports the largest
difference between the versions relative to each query column's max |score|
(the same entries -inf in both), the library call (torch.addmm in bf16,
then the 32-row max, as chip_smoke.py times it) and addmm's out_dtype form
(bf16 operands, an fp32 bias and result) in the same rounds, and the
bound. Prints one JSON line, then the card's name and power limit.
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
        out = out_dir / f"libpass1_norm-{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
               str(Path(src) / "pass1_norm.cu")]
        jobs.append((name, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    fns, regs = {}, {}
    for name, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} pass1_norm.cu:\n{log}")
        fn = ctypes.CDLL(str(out)).pass1_norm_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
        regs[name] = [{"kernel": k, "registers": r, "spill_stores": s, "spill_loads": l}
                      for k, r, s, l in ptxas_summary(log) if "bf16" in k]
    return fns, regs


def main():
    import torch

    if not torch.cuda.is_available():
        print("k4_bf16_ab: needs a CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    sys.path[:0] = [root, here]
    import numpy as np

    from batchelor_torch import _build
    from batchelor_torch.ops import pass1_cuda
    from chip_smoke import (BF16_FLOP_PER_S, DIMS, HBM_BYTES_PER_S, PROBE_N, cuda_ms,
                            k4_bf16_library)

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline-csrc", default=None)
    ap.add_argument("--baseline-layout", default="data", choices=["data", "query"])
    ap.add_argument("--csrc", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    versions = {"current": str(_build.CSRC)}
    if args.baseline_csrc:
        versions["base"] = args.baseline_csrc
    query_major = {"current": True, "base": args.baseline_layout == "query"}
    for spec in args.csrc:
        name, src = spec.split("=", 1)
        versions[name] = src
        query_major[name] = True

    with tempfile.TemporaryDirectory() as tmp:
        fns, regs = build(versions, Path(tmp))
        rng = np.random.default_rng(0)                  # the probe's seed and data
        query = torch.from_numpy(rng.normal(size=(PROBE_N, DIMS)).astype(np.float32)).cuda()
        data = torch.from_numpy(rng.normal(size=(PROBE_N, DIMS)).astype(np.float32)).cuda()
        valid = torch.ones(PROBE_N, dtype=torch.bool, device="cuda")
        valid[1000:1100] = False
        q, x, dn = pass1_cuda.pass1_operands(query, data, valid)
        del query, data
        nq, dp = q.shape
        nd = x.shape[0]
        qb, xb = q.to(torch.bfloat16), x.to(torch.bfloat16)
        stream = torch.cuda.current_stream().cuda_stream
        outs = {v: torch.empty((nq, nd // 32) if query_major[v] else (nd // 32, nq),
                               device="cuda") for v in versions}

        def call(v, cast):
            if query_major[v]:
                a, b = (q.to(torch.bfloat16), x.to(torch.bfloat16)) if cast else (qb, xb)
            else:
                a, b = q, x
            err = fns[v](a.data_ptr(), b.data_ptr(), dn.data_ptr(), outs[v].data_ptr(),
                         nq, nd, dp, 0, stream)
            if err:
                raise RuntimeError(f"{v}: pass1_norm_launch returned {err}")

        neg_dn = -dn[:, None]

        def library_fp32_out():         # addmm's out_dtype: bf16 operands, fp32 result
            xl, ql = x.to(torch.bfloat16), q.to(torch.bfloat16)
            for q0 in range(0, nq, 8192):
                s = torch.addmm(neg_dn, xl, ql[q0:q0 + 8192].T, alpha=2.0,
                                out_dtype=torch.float32)
                s.view(nd // 32, 32, -1).amax(1)

        timed = {"current": lambda: call("current", True),
                 "current_kernel": lambda: call("current", False)}
        for v in versions:
            if v != "current":
                timed[v] = lambda v=v: call(v, True)
        timed["library"] = lambda: k4_bf16_library(torch, q, x, neg_dn)
        timed["library_fp32_out"] = library_fp32_out
        names = list(timed)
        times = {n: [] for n in names}
        for r in range(args.rounds):
            for n in (names if r % 2 == 0 else names[::-1]):
                times[n].append(cuda_ms(torch, timed[n], args.reps))
        torch.cuda.synchronize()
        views = {v: outs[v].t() if query_major[v] else outs[v] for v in versions}
        ref = views["current"]
        inf = torch.isinf(ref)
        scale = torch.where(inf, 0.0, ref.abs()).amax(0, keepdim=True)
        diffs, same_inf = {}, {}
        for v in versions:
            same_inf[v] = bool(torch.equal(inf, torch.isinf(views[v])))
            diffs[v] = float((torch.where(inf, 0.0, views[v] - ref).abs() / scale).max())
        masked_subchunks_inf = bool(torch.isneginf(ref[32:34]).all())
        del outs, views, ref, inf, scale
    flops = 2.0 * nq * nd * dp
    io_bytes = (nq + nd) * dp * 4 + nd * 4 + (nd // 32) * nq * 4
    result = {
        "shape": [nq, nd, dp],
        "ms": {n: float(np.median(times[n])) for n in names},
        "rounds_ms": times,
        "max_rel_diff_vs_current": diffs,
        "same_inf_as_current": same_inf,
        "masked_subchunks_neg_inf": masked_subchunks_inf,
        "bound_ms": max(flops / BF16_FLOP_PER_S, io_bytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / BF16_FLOP_PER_S >= io_bytes / HBM_BYTES_PER_S
        else "bytes",
        "ptxas": regs,
    }
    print(json.dumps(result), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
