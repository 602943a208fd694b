"""What a run of one cell needs, found by name: its configuration, traffic
mix, limits, entry module and metrics (from ``BENCHMARK.json`` and the
files under ``gpubench/``), the program's call, and fastMNN's judgement of
its outputs against the plain reference.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` reads
``gpubench/configs/<config>.json`` (the file its configuration names),
``gpubench/traffic/<traffic>.json``, ``gpubench/limits/<cell>.json`` and
``gpubench/entries/<entry>.py``, where ``<entry>`` is the traffic's
``"entry"``, the program's function that the cell calls. The entry module
makes the call's inputs from the seed, says what is judged of a call and
judges it (``make_inputs``, ``output``, ``judge``, ``READINGS``; optionally
``FAULTS`` with ``planted`` and ``control``, which ``readings.py`` reads).
A per-layer metric ``<name>`` is read by ``gpubench/metrics/<name>.py``. A
later cell, entry or metric adds those files and entries, and no code.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import math
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gpubench import compare, reference

__all__ = ["ROOT", "HERE", "Cell", "load_cell", "entry_module", "call_args", "program_output",
           "reference_outputs", "control_selection", "judge_outputs", "metric_reader"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Optional[Dict[str, float]]
    end_to_end: List[dict]
    per_layer: List[dict]
    entry: ModuleType


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its data files and
    entry module, all under ``root/gpubench/``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    here = root / HERE.name
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    limits_file = here / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else None
    entry = entry_module(traffic["entry"], here / "entries")
    unknown = set(limits or ()) - set(entry.READINGS)
    if unknown:
        raise ValueError(f"{limits_file} limits {sorted(unknown)}, which the entry "
                         f"{traffic['entry']!r} does not read (its READINGS: {list(entry.READINGS)})")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        entry=entry,
    )


def _load(path: Path, module_name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry_module(entry: str, directory: Path = HERE / "entries") -> ModuleType:
    """``directory/<entry>.py``: the inputs, output and judgement of the
    program's function ``entry``."""
    path = directory / f"{entry}.py"
    if not path.is_file():
        raise FileNotFoundError(f"the entry {entry!r} has no module: {path} is not there")
    return _load(path, f"gpubench.entries.{entry}")


def call_args(cell: Cell) -> dict:
    """The entry's keyword arguments: the traffic's ``args``, where a value
    ``"config:<key>"`` takes the configuration's ``<key>``."""
    out = {}
    for key, value in cell.traffic["args"].items():
        if isinstance(value, str) and value.startswith("config:"):
            value = cell.config[value[len("config:"):]]
        out[key] = value
    return out


def program_output(result) -> dict:
    """What is judged of one call: the corrected coordinates, each merge
    step's pairs and, from gene space, the PCA's rotation and centers."""
    out = {"corrected": result.corrected,
           "pairs": [info.pairs for info in result.merge_info]}
    if getattr(result, "rotation", None) is not None:
        out["rotation"] = result.rotation
        out["centers"] = result.centers
    return out


def reference_outputs(cell: Cell, inputs, follows: Sequence, precision: str = "fp64",
                      selection: str = "exact") -> List[dict]:
    """The plain reference (or, at a lower precision, the control) on the
    same inputs and with the same sizes as the program's call: the PCA
    once, then one merge for each entry of ``follows``, a judged output's
    pair lists to follow (``reference.merge``) or None for the reference's
    own."""
    args = call_args(cell)
    ar = reference.Arith(precision)
    with torch.no_grad():
        if cell.traffic["input"] == "genes":
            pcs, rotation, centers = reference.pca(ar, inputs, int(args["d"]))
            pca_out = {"rotation": rotation, "centers": centers}
        else:
            pcs, pca_out = [ar.cast(b) for b in inputs], {}
        outs = []
        for follow in follows:
            corrected, pairs = reference.merge(ar, pcs, int(args["k"]), float(args["ndist"]),
                                               selection, follow)
            outs.append({"corrected": corrected, "pairs": pairs, **pca_out})
    return outs


def _pairs_key(pairs) -> str:
    digest = hashlib.sha256()
    for p in pairs:
        digest.update(np.ascontiguousarray(p, dtype=np.int64).tobytes() + b"|")
    return digest.hexdigest()


def control_selection(cell: Cell) -> str:
    """The MNN searches' selection one precision below the traffic's."""
    return "fp8" if cell.traffic["selection"] == "bf16" else "exact"


def judge_outputs(cell: Cell, outputs: Dict[str, dict], inputs):
    """(correct, worst readings, checks, number of outputs that failed):
    each output against the reference that follows its pairs, computed
    once for each distinct set of pairs, and against the reference's own
    merge, which no output's pairs steer."""
    keys = {name: _pairs_key(out["pairs"]) for name, out in outputs.items()}
    distinct = {}
    for name, key in keys.items():
        distinct.setdefault(key, outputs[name]["pairs"])
    own, *followed = reference_outputs(cell, inputs, [None] + list(distinct.values()))
    refs = dict(zip(distinct, followed))
    worst: Dict[str, float] = {}
    failed = 0
    for name, out in outputs.items():
        values = {**compare.readings(out, refs[keys[name]]), **compare.own_readings(out, own)}
        ok, _ = compare.judge(values, cell.limits)
        failed += not ok
        for k, v in values.items():
            old = worst.get(k)
            if old is None or (not math.isnan(old) and not v <= old):
                worst[k] = v                  # the larger, or NaN for good
    correct, checks = compare.judge(worst, cell.limits)
    return correct and failed == 0, worst, checks, failed


def metric_reader(name: str):
    """``read(ctx)`` of ``gpubench/metrics/<name>.py``."""
    return _load(HERE / "metrics" / f"{name}.py", f"gpubench.metrics.{name}").read
