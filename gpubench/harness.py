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
``bind``, which makes the function a call runs where the program's entry
is not called as ``entry(inputs, **args, device=...)``, ``output_readings``,
each output's readings apart, and ``FAULTS`` with ``planted`` and
``control``, which ``readings.py`` reads). The entry of a cell on several
cards judges on every rank: ``judge(cell, outputs, inputs, world)``, with
the outputs on rank 0 alone (``judge_outputs``).
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

__all__ = ["ROOT", "HERE", "Cell", "load_cell", "entry_module", "call_args", "entry_call",
           "program_output",
           "reference_outputs", "control_selection", "output_readings", "judge_outputs",
           "metric_reader"]

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
    root: Path = ROOT


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
        entry=entry, root=root,
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


def entry_call(cell: Cell, bt, device):
    """The function that one call of the cell runs on its inputs: the
    entry module's ``bind(cell, bt, device)`` where it has one (made once,
    at set-up), else the program's ``entry`` with the traffic's arguments
    on ``device``."""
    bind = getattr(cell.entry, "bind", None)
    if bind is not None:
        return bind(cell, bt, device)
    entry = getattr(bt, cell.traffic["entry"])
    kwargs = dict(call_args(cell), device=device)
    return lambda inputs: entry(inputs, **kwargs)


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
                      selection: str = "exact", share=None) -> List[dict]:
    """The plain reference (or, at a lower precision, the control) on the
    same inputs and with the same sizes as the program's call: the PCA
    once, then one merge for each entry of ``follows``, a judged output's
    pair lists to follow (``reference.merge``) or None for the reference's
    own. ``share``: the ranks that compute it together (``reference.Arith``)."""
    args = call_args(cell)
    ar = reference.Arith(precision, share)
    with torch.no_grad():
        if cell.traffic["input"] == "genes":
            pcs, rotation, centers = reference.pca(ar, inputs, int(args["d"]))
            pca_out = {"rotation": rotation, "centers": centers}
        else:
            pcs, pca_out = [ar.cast(b) for b in inputs], {}
        outs = []
        first = None                # the first step's own pairs, the same in every merge
        for follow in follows:
            corrected, pairs = reference.merge(ar, pcs, int(args["k"]), float(args["ndist"]),
                                               selection, follow, first)
            first = pairs[0]
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


def output_readings(cell: Cell, outputs: Optional[Dict[str, dict]], inputs,
                    world=None) -> Optional[Dict[str, Dict[str, float]]]:
    """Each output's readings: against the reference that follows its
    pairs, computed once for each distinct set of pairs, and against the
    reference's own merge, which no output's pairs steer.

    On a ``world`` of several ranks every rank calls this with the same
    inputs, rank 0 with the outputs and the others with None: rank 0's
    pairs go to every rank, the reference's searches are shared out over
    the ranks' cards, and rank 0 alone gets the readings."""
    distinct, keys = {}, {}
    for name, out in (outputs or {}).items():
        keys[name] = _pairs_key(out["pairs"])
        distinct.setdefault(keys[name], out["pairs"])
    follows = list(distinct.values())
    if world is not None and world.size > 1:
        follows = world.gather(follows)[0]
    own, *followed = reference_outputs(cell, inputs, [None] + follows, share=world)
    if outputs is None:
        return None
    refs = dict(zip(distinct, followed))
    sizes = [int(b.shape[0]) for b in inputs]
    return {name: {**compare.readings(out, refs[keys[name]], sizes),
                   **compare.own_readings(out, own)}
            for name, out in outputs.items()}


def judge_outputs(cell: Cell, outputs: Optional[Dict[str, dict]], inputs, world=None):
    """(correct, worst readings, checks, number of outputs that failed)
    of ``output_readings``; None on a rank other than 0."""
    each = output_readings(cell, outputs, inputs, world)
    if each is None:
        return None
    worst: Dict[str, float] = {}
    failed = 0
    for values in each.values():
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
