"""A run of each cell at a tiny size on the CPU, past the harness's look
for a card: sound, it is correct; with each of its entry module's faults
planted in the timed path, it is not. And the entry modules read what the
harness's fastMNN judgement reads, bit for bit."""
import time

import pytest
import torch

import batchelor_torch as bt
from gpubench import faults, generator, harness, run
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
    cell = tiny_cell(name)
    assert fault in cell.entry.FAULTS
    with cell.entry.planted(fault):
        result = _run(cell, 2 ** 31 + 6)
    assert not result["correct"]
    assert result["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_entry_module_reads_what_the_harness_read(name):
    """The entry module's inputs, output and judgement against the calls
    that ``run_cell`` made before the entry modules: the same batches, and
    the same worst readings and checks to the last bit."""
    cell, cpu, seed = tiny_cell(name), torch.device("cpu"), 2 ** 31 + 7
    inputs = cell.entry.make_inputs(cell, seed, cpu)
    direct_inputs = generator.make_batches(cell.config, cell.traffic["input"], seed, cpu)
    assert len(inputs) == len(direct_inputs)
    assert all(torch.equal(a, b) for a, b in zip(inputs, direct_inputs))
    res = getattr(bt, cell.traffic["entry"])(inputs, device=cpu, **harness.call_args(cell))
    via_entry = cell.entry.judge(cell, {"last": cell.entry.output(res)}, inputs)
    direct = harness.judge_outputs(cell, {"last": harness.program_output(res)}, direct_inputs)
    bits = lambda readings: {k: float(v).hex() for k, v in readings.items()}  # noqa: E731
    assert bits(via_entry[1]) == bits(direct[1])
    assert set(via_entry[1]) == set(cell.entry.READINGS)
    assert via_entry[0] == direct[0] and via_entry[2] == direct[2] and via_entry[3] == direct[3]


def test_traced_run_on_the_cpu_reports_no_device_metric():
    result = _run(tiny_cell("scib_immune_human.fast_mnn"), 17, trace=True)
    assert result["correct"]
    assert result["metrics"] == {}          # no device operations to read
    assert result["device"]["window_s"] > 0
