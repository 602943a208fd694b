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

A cell on n > 1 cards runs as n processes, one a card
(``gpubench/ranks.py``), each through the same ``run_cell``: this one is
rank 0, starts the others with hidden arguments, orders every call, times
it on its own clock until every rank has synchronized its card, reads the
peak of the fullest card, profiles the traced calls on every rank (the
per-layer metrics and the breakdown are rank 0's, the busy time the ranks'
mean) and judges the outputs it kept, while every rank computes a share
of the reference's searches.
"""
import time

_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

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


def _argv(cell_name: str, seed: int, seconds: float, trace: bool) -> list:
    return ["--workload", cell_name, "--seed", str(seed), "--seconds", repr(seconds),
            "--trace", str(int(trace))]


def _profiler(on_card: bool, n_traced: int, trace_path: Path):
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    return profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=n_traced, repeat=1),
                   on_trace_ready=lambda p: p.export_chrome_trace(str(trace_path)))


def _trace_path() -> Path:
    return Path(tempfile.mkdtemp(prefix="gpubench-")) / "trace.json"


def _read_trace(trace_path: Path, calls: int):
    from gpubench.trace import read_chrome_trace

    tr = read_chrome_trace(str(trace_path), calls)
    os.unlink(trace_path)
    os.rmdir(trace_path.parent)
    return tr


def _start_world(cell_name: str, chips: int, root: Path, seed: int, seconds: float, trace: bool,
                 device_kind: str):
    from gpubench import ranks

    return ranks.World.start(Path(__file__).resolve(), _argv(cell_name, seed, seconds, trace),
                             chips, root, device_kind)


def run_cell(cell, bt, seed: int, seconds: float, trace: bool, device, start: float, world=None):
    """One run of ``cell``: set-up, the window (or the traced calls), the
    judgement. Returns (result dict, set-up parts, readings) on rank 0 and
    None on another rank. ``start`` is the host clock at the process's
    start; the card is not looked for.

    A cell on n > 1 chips runs as n ranks (``gpubench/ranks.py``), each
    through this function: rank 0 starts the others (unless ``world``
    holds them already) and orders each call; every call ends when every
    rank has synchronized its card; rank 0 alone times, keeps outputs and
    reads metrics, and every rank shares the reference's searches."""
    import torch

    if world is None:
        world = _start_world(cell.name, cell.chips, cell.root, seed, seconds, trace,
                             torch.device(device).type)
    try:
        out = _run(cell, bt, seed, seconds, trace, device, start, world)
        world.close()
    except BaseException:
        world.abort()
        raise
    return out


def _run(cell, bt, seed, seconds, trace, device, start, world):
    import torch

    from gpubench import harness, ranks

    lead = world.rank == 0
    dev = world.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    parts = {}
    t = time.perf_counter()
    inputs = cell.entry.make_inputs(cell, seed, dev)
    sync()
    parts["data_s"] = time.perf_counter() - t
    if world.size > 1:
        t = time.perf_counter()
        world.join()
        world.same_inputs(ranks.checksum(inputs))
        parts["ranks_s"] = time.perf_counter() - t
    call = harness.entry_call(cell, bt, dev)
    output = cell.entry.output
    n_cells = sum(int(b) for b in cell.config["batches"])

    def one_call():
        res = call(inputs)
        sync()
        world.done()
        return res

    t = time.perf_counter()
    one_call()
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
    n_traced = int(cell.traffic.get("trace_calls", 3))
    trace_path = _trace_path() if trace else None
    with contextlib.ExitStack() as stack:
        prof = stack.enter_context(_profiler(on_card, n_traced, trace_path)) if trace else None
        if prof is not None:
            one_call()                  # the profiled warm-up
            prof.step()
        w0 = c1 = time.perf_counter()
        while True:
            # rank 0 decides, on its own clock, whether every rank calls again
            more = len(times) < n_traced if trace else not times or c1 - w0 < seconds
            c0 = time.perf_counter()
            if world.order(ranks.CALL if more else ranks.STOP) != ranks.CALL:
                break
            res = one_call()
            c1 = time.perf_counter()
            times.append(c1 - c0)
            if lead and draw.random() < 1.0 / len(times):      # one call drawn evenly
                kept["drawn"] = output(res)
            if prof is not None:
                prof.step()             # the last one stops and exports the trace
        window_s = c1 - w0
    gc.unfreeze()
    if lead:
        kept["last"] = output(res)
    del res
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    tr = _read_trace(trace_path, len(times)) if trace else None
    calls = 1 + len(times) + int(trace)
    every = world.gather({"calls": calls, "peak": peak, "busy_s": None if tr is None else tr.busy_s})

    # the reference runs once the window's numbers are read and the
    # program's state is freed, so it sets no peak and no time; on several
    # cards every rank takes a share of its searches
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    if world.size == 1:
        verdict = cell.entry.judge(cell, kept, inputs)
    else:
        verdict = cell.entry.judge(cell, kept if lead else None, inputs, world)
    reference_s = time.perf_counter() - t
    if not lead:
        return None
    correct, worst, checks, failed = verdict

    peak = max(r["peak"] for r in every)
    metrics = {}
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
        ctx = _Ctx(cell, tr)
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak),
                   "power_limit_w": _power_limit_w() if on_card else None}
    if trace:
        # every rank's busy time, averaged over the cards; the window is rank 0's
        device_info["busy_s"] = sum(r["busy_s"] for r in every) / len(every)
        device_info["window_s"] = tr.wall_s
    result = {"correct": bool(correct), "attempted": len(times), "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    extra = {"readings": worst, "reference_s": reference_s, "outputs_judged": sorted(kept),
             "calls": len(times), "window_s": window_s,
             "calls_by_rank": [r["calls"] for r in every]}
    return result, parts, extra


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    from gpubench import ranks

    ranks.add_worker_args(ap)       # a worker of a cell on several cards, started by rank 0
    args = ap.parse_args(argv)
    rank = args.rank or 0

    if rank:
        ranks.die_with_parent(args.parent)

    # one process with few threads: a call's host work is Python and small
    # CPU ops, and eight-wide thread pools only contend with it and with
    # the host's neighbours, which spreads the host-bound cells' rates
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # and on two fixed cores, the last two it may use (a worker of rank r:
    # the two before rank r - 1's): the host-bound calls then keep their
    # caches and do not migrate between cores
    os.sched_setaffinity(0, ranks.cores(rank, args.world or 1, os.sched_getaffinity(0)))
    if rank:
        return _worker(args, ranks)
    # the other ranks of a cell on several cards start first, so that their
    # imports run beside this one's
    world = _start_world(args.workload, _chips(args.workload), ROOT, args.seed, args.seconds,
                         bool(args.trace), "cuda")
    try:
        return _rank0_main(args, world)
    except BaseException:
        world.abort()
        raise


def _chips(workload: str) -> int:
    """The cards the cell asks for, read before anything heavy is imported
    (1 for a name that ``harness.load_cell`` will refuse)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return next((int(w["chips"]) for w in bench["workloads"] if w["name"] == workload), 1)


def _rank0_main(args, world) -> int:
    t = time.perf_counter()
    import torch

    from gpubench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        world.abort()
        return 2
    try:
        import batchelor_torch as bt
        from batchelor_torch import _build
    except ImportError as e:
        print(f"gpubench: the program is not here ({e})", file=sys.stderr)
        world.abort()
        return 2
    parts = {"imports_s": time.perf_counter() - t}
    t = time.perf_counter()
    _build.build()                  # before the other ranks join, which wait for it
    parts["kernel_build_s"] = time.perf_counter() - t

    result, more, extra = run_cell(cell, bt, args.seed, args.seconds, bool(args.trace), "cuda",
                                   _START, world)
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


def _worker(args, ranks) -> int:
    """Rank ``args.rank`` of a cell on several cards: the cell from rank
    0's files, this rank's device, the program, then its share of the run.
    It builds no kernel: rank 0 builds them all before it joins the
    groups, and no rank calls the program before every rank has joined."""
    import batchelor_torch as bt
    from gpubench import harness

    cell = harness.load_cell(args.workload, Path(args.root))
    world = ranks.World.of_worker(args)
    run_cell(cell, bt, args.seed, args.seconds, bool(args.trace), args.device, _START, world)
    return 0


if __name__ == "__main__":
    sys.exit(main())
