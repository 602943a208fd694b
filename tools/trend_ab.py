#!/usr/bin/env python3
"""The trend fit on the card (K6) against the host's numpy, on the quick_correct cell's moments.

    python3 tools/trend_ab.py [--seed 2147486301] [--reps 3] [--out FILE]

Draws the scib_immune_human_counts configuration's counts at --seed
(``gpubench/entries/quick_correct.py::draw_counts``), normalizes them as
``quick_correct`` does (``multi_batch_norm``, the configuration's
``min_mean``) and takes each batch's fp32 mean and variance on the card.
For each of the ten batches: ``fit_trend_var`` on host arrays (numpy) and
on the card tensors, each fitted and evaluated at every gene's mean, timed
as the median of --reps (the card's ending in a synchronize); K6 alone
(``trend_cuda.local_linear`` on the batch's sorted log-ratio at every gene,
its sort of the queries included, CUDA events) beside its bound (24 fp64
flops a query and window point over both passes, at 33.5 TFLOP/s); the
largest gap of the card's ``tech`` from the host's over the host's RMS,
and from the host's with ties of the means in the stable order that the
card sorts them in; and whether the batch's top ``hvg_n`` genes by ``bio``
are the same. Then the same for the combined decomposition. Prints a
table, one JSON line (also to --out) and the card's name and power limit.
Needs a card.
"""
import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def stable_local_linear(d, np):
    """The host smoother with tied means in a stable order, as the card sorts them."""
    def smoother(x, y, span):
        order = np.argsort(x, kind="stable")
        return d._sorted_local_linear(x[order], y[order], d._window(span, x.size))
    return smoother


def timed(torch, fn, reps, card):
    times, out = [], None
    for _ in range(reps):
        if card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if card:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, sorted(times)[len(times) // 2] * 1e3


def event_ms(torch, fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def gap(np, got, want):
    return float(np.max(np.abs(got - want)) / math.sqrt(float(np.mean(want**2))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2147486301)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import batchelor_torch as bt
    from batchelor_torch.correct import diagnostics as d
    from batchelor_torch.ops import trend_cuda
    from chip_smoke import k6_bound_ms, k6_operands
    from gpubench import harness

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    cell = harness.load_cell("scib_immune_human_counts.quick_correct")
    cfg = cell.config
    hvg_n = int(cfg["hvg_n"])
    counts = cell.entry.draw_counts(cfg, args.seed, dev)
    logs = bt.multi_batch_norm(counts, min_mean=float(cfg["min_mean"]), device=dev).logcounts
    del counts
    moments = [(lg.mean(0), torch.var(lg, dim=0, correction=1)) for lg in logs]
    del logs
    torch.cuda.synchronize()

    def decompose(mean, total, tech):
        tech = np.asarray(tech, dtype=np.float64)
        return {"mean": mean, "total": total, "tech": tech, "bio": total - tech}

    def top(bio):
        order = np.argsort(-bio, kind="stable")
        return set(order[bio[order] > 0][:hvg_n].tolist())

    rows, host_decs, stable_decs, card_decs = [], [], [], []
    print(f"{'batch':>5} {'points':>6} {'window':>6} {'host ms':>9} {'card ms':>8} {'K6 ms':>7} "
          f"{'bound ms':>8} {'gap':>9} {'gap stable':>10} {'hvgs':>5}", flush=True)
    for b, (mean, total) in enumerate(moments):
        m_host, v_host = mean.cpu().numpy(), total.cpu().numpy()
        host, host_ms = timed(torch, lambda: d.fit_trend_var(m_host, v_host)(m_host),
                              args.reps, False)
        with mock.patch.object(d, "_local_linear", stable_local_linear(d, np)):
            stable = d.fit_trend_var(m_host, v_host)(m_host)
        card, card_ms = timed(torch, lambda: d.fit_trend_var(mean, total)(mean), args.reps, True)
        card = card.cpu().numpy()
        xs, ratio, window = k6_operands(torch, mean, total)
        q = mean.double()
        k6_ms = event_ms(torch, lambda: trend_cuda.local_linear(xs, ratio, q, window), args.reps)
        bound_ms = k6_bound_ms(q.numel(), window)
        h, s, c = (decompose(m_host, v_host, t) for t in (host, stable, card))
        host_decs.append(h)
        stable_decs.append(s)
        card_decs.append(c)
        row = {"batch": b, "points": int(xs.numel()), "window": window, "host_ms": host_ms,
               "card_ms": card_ms, "k6_ms": k6_ms, "k6_bound_ms": bound_ms,
               "tech_gap": gap(np, c["tech"], h["tech"]),
               "tech_gap_stable": gap(np, c["tech"], s["tech"]),
               "hvgs_equal": top(c["bio"]) == top(h["bio"])}
        rows.append(row)
        print(f"{b:>5} {row['points']:>6} {window:>6} {host_ms:>9.1f} {card_ms:>8.2f} "
              f"{k6_ms:>7.4f} {bound_ms:>8.4f} {row['tech_gap']:>9.2e} "
              f"{row['tech_gap_stable']:>10.2e} {str(row['hvgs_equal']):>5}", flush=True)

    def combined(decs):
        return {f: sum(x[f] for x in decs) / len(decs) for f in ("mean", "total", "tech", "bio")}

    h, s, c = combined(host_decs), combined(stable_decs), combined(card_decs)
    total_row = {"fields_gap": {f: gap(np, c[f], h[f]) for f in ("mean", "total", "tech", "bio")},
                 "fields_gap_stable": {f: gap(np, c[f], s[f]) for f in ("tech", "bio")},
                 "hvgs_equal": top(c["bio"]) == top(h["bio"]),
                 "hvgs_equal_stable": top(c["bio"]) == top(s["bio"]),
                 "host_ms": sum(r["host_ms"] for r in rows),
                 "card_ms": sum(r["card_ms"] for r in rows),
                 "k6_ms": sum(r["k6_ms"] for r in rows)}
    print(f"combined: {total_row}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    line = {"seed": args.seed, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "batches": rows, "combined": total_row}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
