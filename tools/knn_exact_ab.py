#!/usr/bin/env python3
"""K5 (csrc/knn_exact.cu) against the tiled exact search it replaces, on the card.

    python3 tools/knn_exact_ab.py [--csrc NAME=DIR ...] [--shapes LABEL,...]
                                  [--reps 3] [--rounds 3]

Builds csrc/knn_exact.cu and the knn_exact.cu of each --csrc DIR (an
edited copy of csrc/ with its headers), all nvcc started together, with
ptxas's registers and spills of each kernel. Data: the hca_bone_marrow configuration's 8 x 47,250
PCs (gpubench/generator.py, seed 42, d = 50). Shapes, k = 20: the atlas's
last merge step in both directions (47,250 x 330,750 and 330,750 x
47,250), its tricube search (47,250 queries over 36,000 cells of the left
side), scIB's largest search (10,727 x 23,000) and its smallest batch's
(1,022 x 23,000). Each round times every version and ``_knn_tiled`` (the
search as it was: fp32 products, the elementwise epilogue, the running
merge through K2) in turn, forwards then backwards; a time is the median
over the rounds of the median of --reps CUDA-event timings, the norms and
the range merge included. Prints each shape's ms, G scores/s and share of
the 67 TFLOP/s fp32 FMA peak (2 d flops a score), then one JSON line and
the card's name and power limit. Exits non-zero if a version's neighbours
differ from ``_knn_tiled``'s on a row whose k-th and (k+1)-th distances
lie more than eight ulps of their terms apart, or a distance differs by
more than 1e-5 of its terms.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

FP32_FMA_FLOPS = 67e12
K = 20
SHAPES = ("mnn_l2r", "mnn_r2l", "tricube", "scib_large", "scib_small")


def build(versions, out_dir):
    """versions: name -> source dir -> {name: (launch, slots)}."""
    from batchelor_torch import _build
    from split_walk_ab import ptxas_summary

    jobs = []
    for name, src in versions.items():
        out = out_dir / f"libknn_exact-{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
               str(Path(src) / "knn_exact.cu")]
        jobs.append((name, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    fns, regs = {}, {}
    for name, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} knn_exact.cu:\n{log}")
        lib = ctypes.CDLL(str(out))
        launch = lib.knn_exact_launch
        launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5
        launch.restype = ctypes.c_int
        slots = lib.knn_exact_slots
        slots.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        slots.restype = ctypes.c_int
        fns[name] = (launch, slots)
        regs[name] = [{"kernel": k, "registers": r, "spill_stores": s, "spill_loads": l}
                      for k, r, s, l in ptxas_summary(log)]
    return fns, regs


def k5_call(torch, launch, slots_fn, q, x, valid, k):
    """The wrapper's steps (knn_exact_cuda.knn_exact) with another library."""
    from batchelor_torch.ops.knn_exact_cuda import _operands, plan_ranges

    nq, d = q.shape
    nd = x.shape[0]
    q, x, qn, dn = _operands(q, x, valid)
    idx = torch.empty((nq, k), device="cuda", dtype=torch.long)
    sq = torch.empty((nq, k), device="cuda", dtype=torch.float32)
    slots = ctypes.c_int(0)
    if slots_fn(d, k, x.data_ptr() % 16, ctypes.addressof(slots)) != 0:
        raise RuntimeError("knn_exact_slots failed")
    ranges, per = plan_ranges(nq, nd, k, slots.value)
    part_s = part_i = None
    if ranges > 1:
        part_s = torch.empty((ranges, nq, k), device="cuda")
        part_i = torch.empty((ranges, nq, k), device="cuda", dtype=torch.int32)
    err = launch(q.data_ptr(), x.data_ptr(), qn.data_ptr(), dn.data_ptr(), nq, nd, d, k, ranges,
                 per, part_s.data_ptr() if part_s is not None else None,
                 part_i.data_ptr() if part_i is not None else None, idx.data_ptr(),
                 sq.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"knn_exact_launch returned {err}")
    return idx, sq


def main():
    import torch

    if not torch.cuda.is_available():
        print("knn_exact_ab: needs a CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    sys.path[:0] = [root, here]
    import numpy as np

    from batchelor_torch import _build
    from batchelor_torch.ops.knn import _knn_tiled
    from chip_smoke import cuda_ms, knn_agreement
    from gpubench.generator import make_batches

    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", default=[],
                    help="NAME=DIR: another source directory to time")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    versions = {"current": str(_build.CSRC)}
    for spec in args.csrc:
        name, src = spec.split("=", 1)
        versions[name] = src

    cfg = json.loads(Path(root, "gpubench/configs/hca_bone_marrow.json").read_text())
    batches = make_batches(cfg, "pcs", 42, torch.device("cuda"))
    left, right = torch.cat(batches[:7]), batches[7]
    gen = torch.Generator(device="cuda").manual_seed(42)
    involved = left[torch.randperm(left.shape[0], device="cuda", generator=gen)[:36_000]]
    mid = torch.cat(batches[2:4])
    cases = {"mnn_l2r": (right, left), "mnn_r2l": (left, right), "tricube": (right, involved),
             "scib_large": (batches[0][:10_727], mid[:23_000]),
             "scib_small": (batches[1][:1_022], mid[:23_000])}
    ok = True
    shapes = {}
    with tempfile.TemporaryDirectory() as tmp:
        fns, regs = build(versions, Path(tmp))
        print(json.dumps({"ptxas": regs}), flush=True)
        for label in args.shapes.split(","):
            q, x = (t.contiguous() for t in cases[label])
            nq, d = q.shape
            nd = x.shape[0]
            valid = torch.ones(nd, device="cuda", dtype=torch.bool)
            want_i, want_sq = _knn_tiled(q, x, K + 1, valid)
            timed = {"tiled": lambda q=q, x=x, valid=valid: _knn_tiled(q, x, K, valid)}
            for v, (launch, slots_fn) in fns.items():
                timed[v] = (lambda q=q, x=x, valid=valid, launch=launch, slots_fn=slots_fn:
                            k5_call(torch, launch, slots_fn, q, x, valid, K))
            names = list(timed)
            times = {nm: [] for nm in names}
            for r in range(args.rounds):
                for nm in (names if r % 2 == 0 else names[::-1]):
                    times[nm].append(cuda_ms(torch, timed[nm], args.reps))
            checks = {}
            for v in fns:
                rows, differ, err = knn_agreement(torch, timed[v](), want_i, want_sq, q, x, K)
                checks[v] = {"rows_compared": rows, "rows_differ": differ, "max_err": err}
                ok = ok and differ == 0 and err <= 1e-5
            ms = {nm: float(np.median(times[nm])) for nm in names}
            flops = 2.0 * d * nq * nd
            shapes[label] = {
                "nq": nq, "nd": nd, "d": d, "k": K, "ms": ms, "rounds_ms": times,
                "g_scores_per_s": {nm: nq * nd / ms[nm] / 1e6 for nm in names},
                "fp32_fma_peak_pct": {nm: 100.0 * flops / (ms[nm] * 1e-3) / FP32_FMA_FLOPS
                                      for nm in names},
                "checks": checks,
            }
            print(f"  {label} ({nq} x {nd}): " + ", ".join(
                f"{nm} {ms[nm]:.3f} ms ({shapes[label]['fp32_fma_peak_pct'][nm]:.1f}% of fp32)"
                for nm in names) + f"; {checks}", flush=True)
            del want_i, want_sq
            torch.cuda.empty_cache()
    print(json.dumps({"shapes": shapes, "all_agree": ok}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
