"""A run of each cell at a tiny size on the CPU, past the harness's look
for a card: sound, it is correct; with each fault planted in the timed
path, it is not."""
import time

import pytest

import batchelor_torch as bt
from gpubench import faults, run
from _tiny import tiny_cell

CELLS = ("hca_bone_marrow.fast_mnn_auto", "scib_immune_human.fast_mnn",
         "hca_bone_marrow.reduced_mnn_exact")


def _run(cell, seed, trace=False):
    result, parts, extra = run.run_cell(cell, bt, seed, 0.2, trace, "cpu", time.perf_counter())
    return result


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = _run(tiny_cell(name), 2 ** 31 + 5)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == set(tiny_cell(name).limits)
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault):
    with faults.planted(fault):
        result = _run(tiny_cell(name), 2 ** 31 + 6)
    assert not result["correct"]
    assert result["failed"] >= 1


def test_traced_run_on_the_cpu_reports_no_device_metric():
    result = _run(tiny_cell("scib_immune_human.fast_mnn"), 17, trace=True)
    assert result["correct"]
    assert result["metrics"] == {}          # no device operations to read
    assert result["device"]["window_s"] > 0
