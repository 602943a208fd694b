#!/usr/bin/env python3
"""The benchmark of batchelor_torch on the card: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's inputs on the card from the seed (its entry module,
``gpubench/entries/<entry>.py``), calls the cell's entry once to warm
every shape, then, with ``--trace 0``, calls it back to back
for ``--seconds`` (a closed loop: one caller, each call ending in
``torch.cuda.synchronize()``, only whole calls in the window) and reports
the cell's end-to-end metrics; with ``--trace 1`` it profiles a few calls
and reports the per-layer metrics. Then it frees the program's state and
the entry module judges a sample of the window's outputs (one call drawn
from the seed, and the last) against the plain reference on the same
inputs. Set-up's parts are printed first;
the numbers compared, each beside its limit, are the last lines on
standard error; the last line of standard output is the result. No card,
or fewer cards than the cell asks for, is an error: nothing runs on the
CPU.
"""
import time

_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BANNED = ("jax", "jaxlib", "flax", "batchelor_tpu")


def _power_limit_w():
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(smi.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _p95(values):
    s = sorted(values)
    pos = 0.95 * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


class _Ctx:
    """What a per-layer metric's reader sees."""

    def __init__(self, cell, trace):
        self.config = cell.config
        self.traffic = cell.traffic
        self.trace = trace


def run_cell(cell, bt, seed: int, seconds: float, trace: bool, device, start: float):
    """One run of ``cell``: set-up, the window (or the traced calls), the
    judgement. Returns (result dict, set-up parts, readings). ``start`` is
    the host clock at the process's start; the card is not looked for."""
    import torch

    from gpubench import harness

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    parts = {}
    t = time.perf_counter()
    inputs = cell.entry.make_inputs(cell, seed, dev)
    sync()
    parts["data_s"] = time.perf_counter() - t
    entry = getattr(bt, cell.traffic["entry"])
    output = cell.entry.output
    kwargs = dict(harness.call_args(cell), device=dev)
    n_cells = sum(int(b) for b in cell.config["batches"])

    t = time.perf_counter()
    entry(inputs, **kwargs)
    sync()
    parts["warm_call_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - start

    draw = random.Random(seed)
    kept = {}
    times = []
    # set-up's objects (torch, the program, the data) move out of the
    # collector's reach, so a full collection in the window walks only what
    # the calls made, and not the imports, at times that differ by process
    gc.collect()
    gc.freeze()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    trace_path = None
    if not trace:
        w0 = time.perf_counter()
        while True:
            c0 = time.perf_counter()
            res = entry(inputs, **kwargs)
            sync()
            c1 = time.perf_counter()
            times.append(c1 - c0)
            if draw.random() < 1.0 / len(times):         # one call drawn evenly
                kept["drawn"] = output(res)
            if c1 - w0 >= seconds:
                break
        window_s = time.perf_counter() - w0
    else:
        from torch.profiler import ProfilerActivity, profile, schedule

        n_traced = int(cell.traffic.get("trace_calls", 3))
        trace_path = Path(tempfile.mkdtemp(prefix="gpubench-")) / "trace.json"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=n_traced, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(str(trace_path))) as prof:
            entry(inputs, **kwargs)
            sync()
            prof.step()
            w0 = time.perf_counter()
            for _ in range(n_traced):
                c0 = time.perf_counter()
                res = entry(inputs, **kwargs)
                sync()
                c1 = time.perf_counter()
                times.append(c1 - c0)
                if draw.random() < 1.0 / len(times):
                    kept["drawn"] = output(res)
                prof.step()             # the last one stops and exports the trace
            window_s = c1 - w0
    gc.unfreeze()
    kept["last"] = output(res)
    del res
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    metrics = {}
    breakdown = None
    busy = None
    if not trace:
        values = {
            "cells_per_s": len(times) * n_cells / window_s,
            "call_ms_p95": 1e3 * _p95(times),
            "peak_mem_gib": peak / 2 ** 30,
            "setup_s": setup_s,
        }
        # "<quantity>.<part>" is <quantity> in the cells it lists, under a bound of its own
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
    else:
        from gpubench.trace import read_chrome_trace

        tr = read_chrome_trace(str(trace_path), len(times))
        os.unlink(trace_path)
        os.rmdir(trace_path.parent)
        ctx = _Ctx(cell, tr)
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = tr.breakdown()
        busy = tr.busy_s
        wall = tr.wall_s

    # the reference runs once the window's numbers are read and the
    # program's state is freed, so it sets no peak and no time
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    correct, worst, checks, failed = cell.entry.judge(cell, kept, inputs)
    reference_s = time.perf_counter() - t

    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak),
                   "power_limit_w": _power_limit_w() if on_card else None}
    if trace:
        device_info["busy_s"] = busy
        device_info["window_s"] = wall
    result = {"correct": bool(correct), "attempted": len(times), "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    extra = {"readings": worst, "reference_s": reference_s, "outputs_judged": sorted(kept),
             "calls": len(times), "window_s": window_s}
    return result, parts, extra


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one process with few threads: a call's host work is Python and small
    # CPU ops, and eight-wide thread pools only contend with it and with
    # the host's neighbours, which spreads the host-bound cells' rates
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # and on two fixed cores, the last two it may use: the host-bound
    # calls then keep their caches and do not migrate between cores
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-2:])
    t = time.perf_counter()
    import torch

    from gpubench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import batchelor_torch as bt
        from batchelor_torch import _build
    except ImportError as e:
        print(f"gpubench: the program is not here ({e})", file=sys.stderr)
        return 2
    parts = {"imports_s": time.perf_counter() - t}
    t = time.perf_counter()
    _build.build()
    parts["kernel_build_s"] = time.perf_counter() - t

    result, more, extra = run_cell(cell, bt, args.seed, args.seconds, bool(args.trace), "cuda", _START)
    parts.update(more)
    print(json.dumps({"setup_parts": parts}), flush=True)
    print(json.dumps({"run": extra}), flush=True)

    found = sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))
    if found:
        print(f"gpubench: the process loaded {found}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} <= {c['limit']!r}", file=sys.stderr)
    if not result["checks"]:
        print(f"check: no limits for {args.workload}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
