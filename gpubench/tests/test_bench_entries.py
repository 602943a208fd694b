"""A cell made of files alone. An entry module for a port entry that no
cell of the benchmark calls (``rescale_batches``), a configuration, a
traffic mix and limits are written beside a ``BENCHMARK.json`` of their
own, found by name and run through ``run.run_cell``, with nothing under
``gpubench/`` written: the sound run is correct and the run with a fault
of the module's own planted is not. A cell whose entry has no module, or
whose limits name a number its entry does not read, fails where it is
loaded."""
import json
import time

import pytest

import batchelor_torch as bt
from gpubench import harness, run

ENTRY = '''"""The entry ``rescale_batches``: every batch's genes scaled in count
space down to the lowest batch average (batchelor's rescaleBatches)."""
import contextlib
from unittest import mock

import torch

from gpubench import compare

READINGS = ("rows_err_max",)
FAULTS = ("one_batch_uncorrected",)


def make_inputs(cell, seed, device):
    """log2(1 + Poisson counts): shared gene rates, each batch sequenced
    twice as deep as the one before it."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    rates = 4 * torch.rand(int(cell.config["genes"]), generator=g, device=device)
    return [torch.log2(1 + torch.poisson(rates.expand(int(n), -1) * 2.0 ** i, generator=g))
            for i, n in enumerate(cell.config["batches"])]


def output(result):
    return {"corrected": result.corrected}


def _reference(inputs):
    unlogged = [2.0 ** b.double() - 1 for b in inputs]
    means = [u.mean(0) for u in unlogged]
    lowest = torch.stack(means).min(0).values
    return torch.cat([torch.log2(1 + u * torch.nan_to_num(lowest / m, nan=0.0))
                      for u, m in zip(unlogged, means)])


def judge(cell, outputs, inputs):
    want = _reference(inputs)
    errs = [float((out["corrected"].double() - want).abs().max()) for out in outputs.values()]
    failed = sum(not compare.judge({"rows_err_max": e}, cell.limits)[0] for e in errs)
    worst = {"rows_err_max": max(errs)}
    correct, checks = compare.judge(worst, cell.limits)
    return correct and failed == 0, worst, checks, failed


@contextlib.contextmanager
def planted(name):
    import batchelor_torch

    original = batchelor_torch.rescale_batches

    def last_left(batches, *args, **kwargs):
        res = original(batches, *args, **kwargs)
        res.corrected[-batches[-1].shape[0]:] = batches[-1]
        return res
    with mock.patch.object(batchelor_torch, "rescale_batches", last_left):
        yield
'''


def _write_cell(root, entry="rescale_batches", limits=None):
    bench = {
        "command": ["python3", "gpubench/run.py"], "paths": ["gpubench"], "run_seconds": 1,
        "configs": [{"name": "toy_counts", "source": "a test's own", "reduced": [],
                     "file": "gpubench/configs/toy_counts.json", "why": "a test"}],
        "workloads": [{"name": "toy_counts.rescale", "config": "toy_counts",
                       "traffic": "rescale", "chips": 1, "why": "a test"}],
        "end_to_end": [{"name": "cells_per_s", "unit": "cells/s", "better": "higher",
                        "bound": 0.25, "source": "host_clock"},
                       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                        "source": "host_clock"}],
        "per_layer": [],
    }
    files = {
        "BENCHMARK.json": bench,
        "gpubench/configs/toy_counts.json": {"name": "toy_counts", "batches": [300, 200, 150],
                                             "genes": 40},
        "gpubench/traffic/rescale.json": {"entry": entry, "args": {"log_base": 2.0}},
        "gpubench/limits/toy_counts.rescale.json": limits or {"rows_err_max": 1e-4},
    }
    for rel, data in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(json.dumps(data))
    (root / "gpubench/entries").mkdir()
    (root / "gpubench/entries/rescale_batches.py").write_text(ENTRY)


def test_a_cell_of_files_alone_runs_and_is_judged(tmp_path):
    _write_cell(tmp_path)
    cell = harness.load_cell("toy_counts.rescale", root=tmp_path)
    assert cell.entry.__file__ == str(tmp_path / "gpubench/entries/rescale_batches.py")
    assert not (harness.HERE / "entries" / "rescale_batches.py").exists()

    result, _, extra = run.run_cell(cell, bt, 2 ** 31 + 11, 0.2, False, "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"cells_per_s", "setup_s"}
    assert extra["readings"]["rows_err_max"] < 1e-5

    with cell.entry.planted("one_batch_uncorrected"):
        result, _, extra = run.run_cell(cell, bt, 2 ** 31 + 12, 0.2, False, "cpu",
                                        time.perf_counter())
    assert not result["correct"]
    assert result["failed"] >= 1
    assert extra["readings"]["rows_err_max"] > 0.5


@pytest.mark.parametrize("fault", ["entry_without_module", "limit_not_read"])
def test_a_cell_that_cannot_be_judged_fails_where_it_is_loaded(tmp_path, fault):
    if fault == "entry_without_module":
        _write_cell(tmp_path, entry="regress_batches")
        missing = tmp_path / "gpubench/entries/regress_batches.py"
        with pytest.raises(FileNotFoundError, match=str(missing)):
            harness.load_cell("toy_counts.rescale", root=tmp_path)
    else:
        _write_cell(tmp_path, limits={"rows_err_max": 1e-4, "pairs_miss": 0.1})
        with pytest.raises(ValueError, match="pairs_miss"):
            harness.load_cell("toy_counts.rescale", root=tmp_path)
