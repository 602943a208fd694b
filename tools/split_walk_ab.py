#!/usr/bin/env python3
"""The split modes' query walk, timed walk length against walk length on the card.

    python3 tools/split_walk_ab.py [--walks 1,8,16] [--reps 5] [--rounds 3]
                                   [--baseline-csrc DIR]

csrc/split_mma.cuh runs K1's and K4's fp32 split modes; at dp = 64 a CTA
keeps its data tile's bf16 parts and walks over SPLIT_MMA_QWALK query
tiles, fetching the next one ahead with cp.async (1: one tile per CTA,
both operands staged per tile, as at other widths). This script builds
csrc/chunk_max.cu and csrc/pass1_norm.cu once per walk length
(-DSPLIT_MMA_QWALK=W; all nvcc started together, with ptxas's report of
each split kernel's registers and spills), then times K1 split3 and
six_pass at chip_smoke.py's 100352^2 x 64 operands and K4 high3 and
highest at its 98304^2 x 64 ones. Each round times every walk in turn,
forwards then backwards; a kernel's time for a walk is the median over
its rounds of the median of --reps CUDA-event timings. Every walk must
give the same output bit for bit (the walk changes no sum). With
--baseline-csrc, the chunk_max.cu and pass1_norm.cu in DIR (for example
an earlier commit's, unpacked by git archive) are built and timed as the
walk "base", in the same rounds, and their largest difference from the
first walk's output is reported relative to each query column's max
|score|. Prints one JSON line, then the card's name and power limit.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path


def ptxas_summary(log):
    """[(kernel, registers, spill stores, spill loads)] from nvcc -Xptxas -v."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return rows


def build(walks, out_dir, baseline):
    from batchelor_torch import _build

    jobs = []
    for walk in walks:
        src, flags = ((Path(baseline), []) if walk == "base"
                      else (_build.CSRC, [f"-DSPLIT_MMA_QWALK={walk}"]))
        for name in ("chunk_max", "pass1_norm"):
            out = out_dir / f"lib{name}-walk{walk}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", *flags,
                   "-o", str(out), str(src / f"{name}.cu")]
            jobs.append((walk, name, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs, regs = {}, {}
    for walk, name, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu, walk {walk}:\n{log}")
        lib = ctypes.CDLL(str(out))
        fn = getattr(lib, f"{name}_launch")
        n_ptr = 3 if name == "chunk_max" else 4
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[walk, name] = fn
        regs[f"{name} walk {walk}"] = [
            {"kernel": k, "registers": r, "spill_stores": s, "spill_loads": l}
            for k, r, s, l in ptxas_summary(log) if "split" in k]
    return libs, regs


def main():
    import torch

    if not torch.cuda.is_available():
        print("split_walk_ab: needs a CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import numpy as np

    from batchelor_torch.ops import knn_cuda, pass1_cuda
    from chip_smoke import DIMS, N_CELLS, PROBE_N, SEED, cuda_ms, simulate

    ap = argparse.ArgumentParser()
    ap.add_argument("--walks", default="1,8,16")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--baseline-csrc", default=None)
    args = ap.parse_args()
    walks = args.walks.split(",") + (["base"] if args.baseline_csrc else [])

    with tempfile.TemporaryDirectory() as tmp:
        libs, regs = build(walks, Path(tmp), args.baseline_csrc)
        rng = np.random.default_rng(SEED)
        b1 = torch.from_numpy(simulate(rng, N_CELLS, DIMS)).cuda()
        b2 = torch.from_numpy(simulate(rng, N_CELLS, DIMS, shift=0.8)).cuda()
        k1q, k1x = knn_cuda._pass1_operands(b1, b2, torch.ones(N_CELLS, dtype=torch.bool,
                                                                 device="cuda"))
        rng = np.random.default_rng(0)                  # the precision probe's data
        pq = torch.from_numpy(rng.normal(size=(PROBE_N, DIMS)).astype(np.float32)).cuda()
        px = torch.from_numpy(rng.normal(size=(PROBE_N, DIMS)).astype(np.float32)).cuda()
        k4q, k4x, k4dn = pass1_cuda.pass1_operands(pq, px, torch.ones(
            PROBE_N, dtype=torch.bool, device="cuda"))
        stream = torch.cuda.current_stream().cuda_stream

        def call(walk, case, out):
            name, mode = case
            if name == "chunk_max":
                q, x = k1q, k1x
                err = libs[walk, name](q.data_ptr(), x.data_ptr(), out.data_ptr(),
                                       q.shape[0], x.shape[0], q.shape[1], mode, stream)
            else:
                q, x = k4q, k4x
                err = libs[walk, name](q.data_ptr(), x.data_ptr(), k4dn.data_ptr(),
                                       out.data_ptr(), q.shape[0], x.shape[0], q.shape[1],
                                       mode, stream)
            if err:
                raise RuntimeError(f"{name} walk {walk} mode {mode}: cudaError {err}")

        cases = {"K1 split3": ("chunk_max", 1), "K1 six_pass": ("chunk_max", 2),
                 "K4 high3": ("pass1_norm", 1), "K4 highest": ("pass1_norm", 2)}
        result = {}
        for label, case in cases.items():
            nq, nd = (k1q if case[0] == "chunk_max" else k4q).shape[0], \
                (k1x if case[0] == "chunk_max" else k4x).shape[0]
            outs = {w: torch.empty((nd // 32, nq), device="cuda") for w in walks}
            times = {w: [] for w in walks}
            for r in range(args.rounds):
                for w in (walks if r % 2 == 0 else walks[::-1]):
                    times[w].append(cuda_ms(torch, lambda: call(w, case, outs[w]), args.reps))
            torch.cuda.synchronize()
            ref = outs[walks[0]]
            if not all(torch.equal(outs[w], ref) for w in walks if w != "base"):
                raise AssertionError(f"{label}: the walks disagree")
            result[label] = {str(w): float(np.median(times[w])) for w in walks}
            result[label]["rounds_ms"] = {str(w): times[w] for w in walks}
            if "base" in outs:
                sentinel = ref.abs() > 1e29               # K1's masked and padding rows
                scale = torch.where(sentinel, 0.0, ref.abs()).amax(0, keepdim=True)
                diff = torch.where(sentinel, 0.0, outs["base"] - ref).abs()
                rel = float((diff / scale).max())
                result[label]["base_max_rel_diff"] = rel
            print(f"{label}: " + ", ".join(f"walk {w} {result[label][str(w)]:.3f} ms"
                                           for w in walks), flush=True)
            del outs
    print(json.dumps({"split_walk_ms": result, "ptxas": regs,
                      "shapes": {"K1": list(k1q.shape) + [k1x.shape[0]],
                                 "K4": list(k4q.shape) + [k4x.shape[0]]}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
