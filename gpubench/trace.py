"""From a torch.profiler Chrome trace to what the per-layer metrics read.

The arithmetic follows ``tools/profile_main_path.py``: only device
operations count as device time (kernels, memory copies and sets; the
profiler's annotations and aten rows would count each kernel twice), and
the idle share is 1 - busy / wall. Here busy is the union of the device
operations' intervals, not their sum; wall is the span of the profiler's
step annotations, which ends where the last traced call's step does, so
the profiler's own shutdown and the trace's export lie outside it. Each
operation is attributed to
the program's ``record_function`` range (a ``trace_span`` name such as
``fastmnn/pca``) whose host interval holds its launch: the launch and the
operation share a correlation id in the trace. The seconds that the
program's spans record on the host are enqueue times and are not read.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Trace", "read_chrome_trace"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
_STEP = "ProfilerStep#"
_SHORT_GAP_US = 10.0


@dataclass
class Trace:
    """Device operations of ``calls`` traced calls.

    ``ops``: (name, category, start us, duration us, range or None);
    ``wall_s``: the traced steps' span (the device operations' span where
    the trace holds no steps)."""

    ops: List[Tuple[str, str, float, float, Optional[str]]]
    calls: int
    wall_s: float
    busy_s: float
    gaps: Dict[str, float] = field(default_factory=dict)

    def launches_per_call(self) -> float:
        return sum(1 for op in self.ops if op[1] == "kernel") / self.calls

    def device_ms_per_call(self, ranges: Sequence[str]) -> float:
        us = sum(op[3] for op in self.ops if op[4] in ranges)
        return us / 1e3 / self.calls

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = defaultdict(float)
        for name, _, _, dur, _ in self.ops:
            by_name[name[:120]] += dur / 1e6
        ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: kv[1], reverse=True)[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


class _Ranges:
    """Host intervals of the named ranges, for 'which range holds time t'."""

    def __init__(self, events):
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events)
        self.starts = [s[0] for s in spans]
        self.spans = spans

    def at(self, t: float) -> Optional[str]:
        """The innermost range open at ``t``: the latest to start that has
        not ended."""
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(-1, i - 64), -1):
            if self.spans[j][1] >= t:
                return self.spans[j][2]
        return None


def _gap_labels(host, ranges: _Ranges, gaps: List[Tuple[float, float]]) -> Dict[str, float]:
    """Seconds of idle device time by what the host was doing as each gap
    began: the innermost host event then open, inside its program range."""
    host = sorted(host, key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        if b - a < _SHORT_GAP_US:
            out[f"gaps under {_SHORT_GAP_US:g} us each"] += (b - a) / 1e6
            continue
        t = a + 1e-3
        i = bisect.bisect_right(starts, t)
        inner = None
        for e in host[max(0, i - 400):i]:
            if e["ts"] <= t <= e["ts"] + e["dur"] and (inner is None or e["dur"] < inner["dur"]):
                inner = e
        where = ranges.at(t) or "outside the program's ranges"
        what = inner["name"][:80] if inner is not None else "no host event"
        out[f"{where}: {what}"] += (b - a) / 1e6
    return dict(out)


RANGE_PREFIXES = ("fastmnn/", "driver/")


def read_chrome_trace(path: str, calls: int, prefix: Tuple[str, ...] = RANGE_PREFIXES) -> Trace:
    """Reduce the Chrome trace of ``calls`` calls, one profiler step each;
    ranges are the annotations whose names start with one of ``prefix``
    (fastMNN's layers and the distributed driver's step and pair gather)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    launches = {}
    host, named, steps, device = [], [], [], []
    for e in events:
        cat = e.get("cat", "")
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e["ts"]
        if cat == "user_annotation":
            if e["name"].startswith(prefix):
                named.append(e)
            elif e["name"].startswith(_STEP):
                steps.append(e)
                continue
        if cat in _HOST_CATS:
            host.append(e)
        elif cat in _DEVICE_CATS:
            device.append(e)
    ranges = _Ranges(named)
    ops = []
    for e in device:
        t = launches.get(e.get("args", {}).get("correlation"))
        ops.append((e["name"], e["cat"], float(e["ts"]), float(e["dur"]),
                    None if t is None else ranges.at(t)))
    busy = _union([(ts, ts + dur) for _, _, ts, dur, _ in ops])
    if steps:
        lo = min(s["ts"] for s in steps)
        hi = max(s["ts"] + s["dur"] for s in steps)
    elif busy:
        lo, hi = busy[0][0], busy[-1][1]
    else:
        lo = hi = 0.0
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    busy_s = sum(b - a for a, b in busy) / 1e6
    return Trace(ops=ops, calls=calls, wall_s=(hi - lo) / 1e6, busy_s=busy_s,
                 gaps=_gap_labels(host, ranges, gaps))
