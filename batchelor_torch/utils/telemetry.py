"""Tracing and metrics: the observability surface of the port.

Counterpart of ``batchelor_tpu/utils/telemetry.py``. ``trace_span`` marks a
region for a running ``torch.profiler`` (``record_function``) and, while a
``MetricsRecorder`` is active, records it there: its edges on the host's
wall clock (``time.time_ns()``, the clock of a profiler trace's ``ts`` plus
``baseTimeNanoseconds``, so the records lie over a device trace), its parent
span, the call it belongs to, its attributes and, with ``device_time``, its
time on the card. With neither a profiler nor a recorder active a span
costs one check and enters nothing. The recorder also keeps counters: the
merge counters ``merge_steps``, ``mnn_pairs`` and ``cells_merged``, and
``knn/<path>/{searches,scores,flops,bytes}`` of each search.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

import torch

__all__ = ["trace_span", "MetricsRecorder", "get_recorder", "set_recorder"]

_recorder: Optional["MetricsRecorder"] = None


def get_recorder() -> Optional["MetricsRecorder"]:
    return _recorder


def set_recorder(rec: Optional["MetricsRecorder"]) -> Optional["MetricsRecorder"]:
    global _recorder
    old = _recorder
    _recorder = rec
    return old


_BARE = contextlib.nullcontext()


def trace_span(name: str, **attrs):
    """A ``torch.profiler`` annotation while a profiler runs and, while a
    recorder is active, one entry of its ``records``. With neither active
    it is a shared no-op context, so the cost is this one check."""
    profiling = torch.autograd._profiler_enabled()
    if _recorder is None and not profiling:
        return _BARE
    return _span(_recorder, profiling, name, attrs)


@contextlib.contextmanager
def _span(rec: Optional["MetricsRecorder"], profiling: bool, name: str,
          attrs: Dict[str, Any]):
    idx = None if rec is None else rec.open_span(name, attrs)
    try:
        # record_function costs ~10 us even with no profiler to see it
        with torch.profiler.record_function(name) if profiling else _BARE:
            yield
    finally:
        if rec is not None:
            rec.close_span(idx)


class MetricsRecorder:
    """Spans and counters of one run, kept in memory until written out.

    ``records`` holds one dict a span, in the order the spans opened:
    ``name``; ``start_ns`` and ``end_ns`` (``time.time_ns()``); ``parent``,
    the index of the enclosing span's record or None; ``call``, the number
    of the outermost span among the run's outermost spans, which every span
    inside it shares; ``attrs``; and, once ``summary()`` has read it,
    ``device_ms`` where the span was timed on the card.

    ``device_time``: also record a pair of CUDA events a span on the current
    stream (once CUDA is in use). The events come from a pool and are read
    only in ``summary()``, after one synchronize, so a call under the
    recorder waits on the card no more often than without it.
    """

    def __init__(self, device_time: bool = False):
        self.device_time = device_time
        self.records: List[Dict[str, Any]] = []
        self.counters: Dict[str, float] = defaultdict(float)
        self._open: List[int] = []
        self._calls = 0
        self._timed: Dict[int, tuple] = {}      # record index -> (start, end) events unread
        self._pool: List[torch.cuda.Event] = []
        self._device_counts: List[tuple] = []   # (counter, device tensor) unread

    def _event(self) -> torch.cuda.Event:
        ev = self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def open_span(self, name: str, attrs: Dict[str, Any]) -> int:
        if self._open:
            parent = self._open[-1]
            call = self.records[parent]["call"]
        else:
            parent, call = None, self._calls
            self._calls += 1
        idx = len(self.records)
        self.records.append({"name": name, "start_ns": time.time_ns(), "end_ns": None,
                             "parent": parent, "call": call, "attrs": attrs})
        self._open.append(idx)
        if self.device_time and torch.cuda.is_initialized():
            self._timed[idx] = (self._event(), None)
        return idx

    def close_span(self, idx: int) -> None:
        if idx in self._timed:
            self._timed[idx] = (self._timed[idx][0], self._event())
        self.records[idx]["end_ns"] = time.time_ns()
        self._open.remove(idx)

    @property
    def spans(self) -> Dict[str, List[float]]:
        """Host seconds of each closed span, by name."""
        out: Dict[str, List[float]] = defaultdict(list)
        for r in self.records:
            if r["end_ns"] is not None:
                out[r["name"]].append((r["end_ns"] - r["start_ns"]) / 1e9)
        return dict(out)

    def add(self, name: str, value=1.0) -> None:
        """Add to a counter. A count held in a card tensor is read in
        ``summary()``, so counting waits on nothing."""
        if isinstance(value, torch.Tensor):
            if value.device.type != "cpu":
                self._device_counts.append((name, value))
                return
            value = value.item()
        self.counters[name] += value

    def _read_device(self) -> None:
        closed = [(i, s, e) for i, (s, e) in self._timed.items() if e is not None]
        if not closed and not self._device_counts:
            return
        torch.cuda.synchronize()
        for i, start, end in closed:
            self.records[i]["device_ms"] = start.elapsed_time(end)
            self._pool += [start, end]
            del self._timed[i]
        for name, value in self._device_counts:
            self.counters[name] += value.item()
        self._device_counts.clear()

    def summary(self) -> Dict[str, Any]:
        """Per span name: ``count``, ``total_s`` and ``max_s`` of host wall
        time, and ``device_ms`` (their total on the card) where timed; and
        the counters."""
        self._read_device()
        spans: Dict[str, Dict[str, float]] = {}
        for r in self.records:
            if r["end_ns"] is None:
                continue
            s = (r["end_ns"] - r["start_ns"]) / 1e9
            agg = spans.setdefault(r["name"], {"count": 0, "total_s": 0.0, "max_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += s
            agg["max_s"] = max(agg["max_s"], s)
            if "device_ms" in r:
                agg["device_ms"] = agg.get("device_ms", 0.0) + r["device_ms"]
        return {"spans": spans, "counters": dict(self.counters)}

    def dump_json(self) -> str:
        """The summary and every record, as JSON."""
        out = self.summary()
        out["records"] = self.records
        return json.dumps(out, sort_keys=True, default=str)

    @contextlib.contextmanager
    def activate(self):
        old = set_recorder(self)
        try:
            yield self
        finally:
            set_recorder(old)
