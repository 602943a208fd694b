#!/usr/bin/env python3
"""The fused merge step's segment sums: where non-pair candidates add.

    python3 tools/segment_sums_ab.py [--n 100000] [--rounds 2]

``pair_segment_sums`` adds each neighbour position's left rows into the
right cells' segments with ``index_add_``. The form the JAX package uses
sends every candidate that is not a pair to one trash row; the port's form
lets a non-pair candidate in the window add zeros to its own segment. Both
give the same sums (adding a zero leaves a sum as it was). This script runs
``fused_merge_step`` ("auto", chip_smoke.py's 2 x n x 50 simulation, seed
42, k = 20) with each form in one process, in turns (trash row, own
segment, own segment, trash row, ...), each call under torch.profiler
after a warm-up, and prints each run's wall ms, device ms, idle share and
the ms of its ``index_add_`` kernels, the largest difference between the
two forms' outputs relative to max |right|, and the card's name and power
limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def trash_row_sums(l_rows, l2r, mutual, n_segments, *, lo=0):
    """pair_segment_sums as the JAX package writes it: every candidate that
    is not a pair in the window goes to the trash row."""
    import torch

    dt = l_rows.dtype
    shape = (n_segments + 1, l_rows.shape[1])
    lsums = torch.zeros(shape, device=l_rows.device, dtype=dt)
    counts = torch.zeros(n_segments + 1, device=l_rows.device, dtype=dt)
    for p in range(l2r.shape[1]):
        col = l2r[:, p]
        inr = mutual[:, p] & (col >= lo) & (col < lo + n_segments)
        seg = torch.where(inr, col - lo, n_segments).long()
        w = inr.to(dt)
        lsums = lsums + torch.zeros(shape, device=l_rows.device, dtype=dt).index_add_(
            0, seg, l_rows * w[:, None])
        counts = counts + torch.zeros(n_segments + 1, device=l_rows.device,
                                      dtype=dt).index_add_(0, seg, w)
    return lsums[:n_segments], counts[:n_segments]


def main():
    import torch

    if not torch.cuda.is_available():
        print("segment_sums_ab: needs a CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import numpy as np

    import batchelor_torch as bt
    from batchelor_torch import _build
    from batchelor_torch.ops import correction, merge_math
    from chip_smoke import simulate

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    _build.build()
    rng = np.random.default_rng(42)
    left = torch.from_numpy(simulate(rng, args.n, 50)).cuda()
    right = torch.from_numpy(simulate(rng, args.n, 50, shift=0.8)).cuda()
    forms = {"trash_row": trash_row_sums, "own_segment": correction.pair_segment_sums}
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    outs = {}
    order = ["trash_row", "own_segment", "own_segment", "trash_row"] * args.rounds
    for form in order:
        merge_math.pair_segment_sums = forms[form]
        step = lambda: bt.fused_merge_step(left, right, 20, 20, 20, knn_method="auto")
        step()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=act) as prof:
            t0 = time.perf_counter()
            out = step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device_ms = index_add_ms = 0.0
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = evt.time_range.elapsed_us() / 1e3
            device_ms += ms
            if "indexFuncLargeIndex" in evt.name or "index_add" in evt.name:
                index_add_ms += ms
        outs[form] = out.right
        print(json.dumps({"form": form, "wall_ms": wall_ms, "device_ms": device_ms,
                          "idle_share": 1.0 - device_ms / wall_ms,
                          "index_add_ms": index_add_ms}), flush=True)
    merge_math.pair_segment_sums = correction.pair_segment_sums
    scale = float(outs["trash_row"].abs().max())
    diff = float((outs["own_segment"] - outs["trash_row"]).abs().max()) / scale
    print(json.dumps({"max_abs_diff_rel": diff}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
