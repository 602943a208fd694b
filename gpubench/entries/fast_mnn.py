"""The entry ``fast_mnn``: fastMNN on batches of log-expression.

Inputs: the configuration's batches from ``gpubench/generator.py``, made
on the device from the seed in the space the traffic names (``"input"``).
Judged of a call: the corrected coordinates, each merge step's pairs and
the PCA's rotation and centers (``harness.program_output``), against the
plain float64 reference that follows the call's pairs and against the
reference's own merge (``harness.judge_outputs``). The control is the
reference one precision below (TF32 products, and fp8 selection where the
traffic selects in bf16); the faults are ``gpubench/faults.py``'s.
"""
from gpubench import generator, harness
from gpubench.faults import FAULTS, planted  # noqa: F401

READINGS = ("centers_err", "pairs_miss", "rows_err_p50", "batch_rows_err_p50", "rows_err_max",
            "own_rows_err_p50")

output = harness.program_output
judge = harness.judge_outputs


def make_inputs(cell, seed: int, device):
    return generator.make_batches(cell.config, cell.traffic["input"], seed, device)


def control(cell, inputs) -> dict:
    """The control's output: the reference in the program's place, one
    precision below what the configuration states."""
    return harness.reference_outputs(cell, inputs, [None], "tf32", harness.control_selection(cell))[0]
