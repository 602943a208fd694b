#!/usr/bin/env python3
"""Where the port's paths spend their time on the card.

    python3 tools/profile_main_path.py [--n 100000] [--genes 2000]
                                       [--paths reduced_mnn,fast_mnn] [--trace trace.json]
                                       [--knn-method auto]

Runs each path twice in one process, each run under torch.profiler: the
first run pays the process's first-use costs, the second is the steady
state. reduced_mnn runs on two n x 50 fp32 batches, fast_mnn on two
n x genes batches from gene space (d = 50); both with chip_smoke.py's
simulation (seed 42), k = 20 and knn_method="auto" (or --knn-method, e.g.
"chunked": fp32 selection through K1's split3 mode). For each run it
prints the wall seconds, the summed device time of the kernels and the
device's idle share (1 - device time / wall time), the kernels by device
time, the host operations by self host time, and the host time of each
span; with --trace it also writes the last run's Chrome trace. Ends with
the card's name and power limit. The kernels are built before the first
run.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_main_path: needs a CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import numpy as np

    import batchelor_torch as bt
    from batchelor_torch import _build
    from chip_smoke import simulate

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--genes", type=int, default=2_000)
    ap.add_argument("--paths", default="reduced_mnn,fast_mnn")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--knn-method", default="auto", choices=["auto", "chunked", "bf16", "exact"])
    args = ap.parse_args()
    build_s = _build.build()
    print(json.dumps({"build_s": build_s}), flush=True)

    def device_us(evt):
        return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    on_device = torch.autograd.DeviceType.CUDA
    for path in args.paths.split(","):
        rng = np.random.default_rng(42)
        width = 50 if path == "reduced_mnn" else args.genes
        batches = [torch.from_numpy(simulate(rng, args.n, width)).cuda(),
                   torch.from_numpy(simulate(rng, args.n, width, shift=0.8)).cuda()]
        entry = getattr(bt, path)
        kw = {} if path == "reduced_mnn" else {"d": 50}
        for run in ("first", "second"):
            rec = bt.MetricsRecorder()
            with torch.profiler.profile(activities=acts) as prof, rec.activate():
                t0 = time.perf_counter()
                entry(batches, k=20, knn_method=args.knn_method, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            events = prof.key_averages()
            # device-side kernels only: aten ops and the span annotations also
            # carry device time, which would count each kernel twice
            kernels = [e for e in events
                       if e.device_type == on_device and device_us(e) > 0
                       and not e.key.startswith(("aten::", "fastmnn/"))]
            kernels.sort(key=device_us, reverse=True)
            device_s = sum(device_us(e) for e in kernels) / 1e6
            tag = {"path": path, "knn_method": args.knn_method, "run": run}
            print(json.dumps({**tag, "n": args.n, "width": width, "wall_s": wall,
                              "device_s": device_s, "device_idle_share": 1.0 - device_s / wall}),
                  flush=True)
            for e in kernels[:14]:
                print(json.dumps({**tag, "kernel": e.key[:100], "calls": e.count,
                                  "device_ms": device_us(e) / 1e3}), flush=True)
            host = sorted((e for e in events if e.device_type != on_device),
                          key=lambda e: e.self_cpu_time_total, reverse=True)
            for e in host[:8]:
                print(json.dumps({**tag, "host_op": e.key[:100], "calls": e.count,
                                  "self_host_ms": e.self_cpu_time_total / 1e3}), flush=True)
            print(json.dumps({**tag, "spans_host_s": {k: sum(v) for k, v in rec.spans.items()},
                              "counters": dict(rec.counters)}), flush=True)
        del batches
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
