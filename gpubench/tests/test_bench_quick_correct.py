"""The ``quick_correct`` cell cut to a CPU's size and made in a test's
directory from the cell's own files (its configuration with fewer cells
and genes, its traffic, its limits and its entry module), found by name
and run through ``run.run_cell``: the sound run is correct; the control,
and the program with each of the entry's faults planted, are not."""
import json
import shutil
import time

import pytest
import torch

import batchelor_torch as bt
from gpubench import harness, run

CELL = "scib_immune_human_counts.quick_correct"
SEED = 2 ** 31 + 41


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    root = tmp_path_factory.mktemp("quick_cell")
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in bench["workloads"] if w["name"] == CELL)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((harness.ROOT / cfg_entry["file"]).read_text())
    config.update(batches=[400, 300, 250], genes=600, hvg_n=150)
    config["counts"]["bio_genes"] = 150
    bench.update(configs=[cfg_entry], workloads=[w], per_layer=[])
    files = {"BENCHMARK.json": bench, cfg_entry["file"]: config}
    for rel, data in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(json.dumps(data))
    for rel in (f"gpubench/traffic/{w['traffic']}.json", f"gpubench/limits/{CELL}.json",
                "gpubench/entries/quick_correct.py"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(harness.ROOT / rel, root / rel)
    c = harness.load_cell(CELL, root=root)
    assert c.entry.__file__ == str(root / "gpubench/entries/quick_correct.py")
    return c


def _run(cell):
    return run.run_cell(cell, bt, SEED, 0.2, False, "cpu", time.perf_counter())


def test_sound_run_is_correct(cell):
    result, _, extra = _run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == set(cell.limits)
    assert set(extra["readings"]) == set(cell.entry.READINGS)


def test_control_is_not_correct(cell):
    inputs = cell.entry.make_inputs(cell, SEED, torch.device("cpu"))
    correct, worst, checks, failed = cell.entry.judge(
        cell, {"control": cell.entry.control(cell, inputs)}, inputs)
    assert not correct and failed == 1


@pytest.mark.parametrize("fault", ["unrescaled_size_factors", "hvgs_by_total",
                                   "trend_without_curve", "floored_trend", "half_pairs"])
def test_planted_fault_is_not_correct(cell, fault):
    assert fault in cell.entry.FAULTS
    with cell.entry.planted(fault):
        result, _, _ = _run(cell)
    assert not result["correct"]
    assert result["failed"] >= 1
