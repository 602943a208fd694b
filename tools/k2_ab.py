#!/usr/bin/env python3
"""K2 (topk_rows), the current kernel against an earlier commit's, on the card.

    python3 tools/k2_ab.py [--baseline-csrc DIR] [--csrc NAME=DIR ...]
                           [--variant NAME=FLAGS ...] [--reps 10] [--rounds 3]

Builds csrc/topk_rows.cu and, with --baseline-csrc, the topk_rows.cu in DIR
(for example an earlier commit's sources, unpacked by git archive), the
topk_rows.cu in each --csrc DIR, and each --variant (the current source
with extra nvcc flags, for example steps8=-DTOPK_ROWS_STEPS=8), all nvcc
started together, with ptxas's report
of each kernel's registers and spills. Then, at k = 20, on chip_smoke.py's
timed inputs (normal rows with planted ties and -inf pads, seed 42) at
(100352, 3136), (100000, 640), (16384, 8212) and (16384, 640), and on
merge rows at (16384, 8212) (the tricube search's running merge: the 20
best of an earlier tile, sorted, then a fresh tile of 8192 scores), times
every version and torch.topk in rounds: each round times them in turn,
forwards then backwards, and a time is the median over the rounds of the
median of --reps CUDA-event timings. Each version's values and columns must
equal the plain version's (a stable sort) bit for bit. Prints one JSON line
with each shape's times and bound (bytes at 3.35 TB/s), then the card's
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
    """versions: name -> (source dir, extra nvcc flags)."""
    from batchelor_torch import _build
    from split_walk_ab import ptxas_summary

    jobs = []
    for name, (src, flags) in versions.items():
        out = out_dir / f"libtopk_rows-{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o", str(out),
               str(Path(src) / "topk_rows.cu")]
        jobs.append((name, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    fns, regs = {}, {}
    for name, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} topk_rows.cu:\n{log}")
        fn = ctypes.CDLL(str(out)).topk_rows_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
        regs[name] = [{"kernel": k, "registers": r, "spill_stores": s, "spill_loads": l}
                      for k, r, s, l in ptxas_summary(log)]
    return fns, regs


def merge_rows(torch, gen, n, tile, k):
    """The running merge's input: an earlier tile's k best, sorted, then a tile."""
    best = torch.randn(n, tile, device="cuda", generator=gen).topk(k, dim=1).values
    return torch.cat([best, torch.randn(n, tile, device="cuda", generator=gen)], 1)


def main():
    import torch

    if not torch.cuda.is_available():
        print("k2_ab: needs a CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(here), here]
    import numpy as np

    from batchelor_torch import _build
    from batchelor_torch.ops import topk_cuda
    from chip_smoke import K, K2_TIMED, SEED, cuda_ms, k2_bound_ms, k2_input

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline-csrc", default=None)
    ap.add_argument("--csrc", action="append", default=[],
                    help="NAME=DIR: another source directory to time")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS: the current source built with extra nvcc flags")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    versions = {"current": (str(_build.CSRC), [])}
    if args.baseline_csrc:
        versions["base"] = (args.baseline_csrc, [])
    for spec in args.csrc:
        name, src = spec.split("=", 1)
        versions[name] = (src, [])
    for spec in args.variant:
        name, flags = spec.split("=", 1)
        versions[name] = (str(_build.CSRC), flags.split())

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    inputs = [(f"{n}x{w}", k2_input(torch, gen, n, w)) for n, w, k in K2_TIMED if k == K]
    inputs.append(("16384x8212 merge", merge_rows(torch, gen, 16384, 8192, K)))
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    shapes = {}
    with tempfile.TemporaryDirectory() as tmp:
        fns, regs = build(versions, Path(tmp))
        for label, x in inputs:
            n, w = x.shape
            outs = {v: (torch.empty((n, K), device="cuda"),
                        torch.empty((n, K), device="cuda", dtype=torch.int32)) for v in versions}

            def call(v, x=x, n=n, w=w, outs=outs):
                err = fns[v](x.data_ptr(), outs[v][0].data_ptr(), outs[v][1].data_ptr(),
                             n, w, K, stream)
                if err:
                    raise RuntimeError(f"{v}: topk_rows_launch returned {err}")

            timed = {**{v: (lambda v=v: call(v)) for v in versions},
                     "torch.topk": lambda x=x: torch.topk(x, K, dim=1)}
            names = list(timed)
            times = {nm: [] for nm in names}
            for r in range(args.rounds):
                for nm in (names if r % 2 == 0 else names[::-1]):
                    times[nm].append(cuda_ms(torch, timed[nm], args.reps))
            pv, pi = topk_cuda.topk_rows_plain(x, K)
            torch.cuda.synchronize()
            same = {v: bool(torch.equal(outs[v][0], pv) and torch.equal(outs[v][1], pi))
                    for v in versions}
            ok = ok and all(same.values())
            shapes[label] = {
                "shape": [n, w], "k": K,
                "ms": {nm: float(np.median(times[nm])) for nm in names},
                "rounds_ms": times,
                "bound_ms": k2_bound_ms(n, w, K),
                "identical_to_plain": same,
            }
            print(f"  {label}: " + ", ".join(f"{nm} {shapes[label]['ms'][nm]:.4f} ms"
                                             for nm in names) + f"; identical {same}",
                  flush=True)
            del outs
    print(json.dumps({"shapes": shapes, "ptxas": regs, "all_identical": ok}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
