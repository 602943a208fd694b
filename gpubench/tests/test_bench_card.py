"""On the card only: a cut-down cell runs through the timed and the traced
path, correct, with every per-layer metric it lists and no share above
100%. Skips without a card; the decision is made inside the test."""
import time

import pytest
import torch

from _tiny import tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_cut_down_cell_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import batchelor_torch as bt
    from gpubench import run

    cell = tiny_cell("hca_bone_marrow.fast_mnn_auto", batches=(6000, 5000, 4000), genes=500)
    result, parts, extra = run.run_cell(cell, bt, 2 ** 31 + 99, 1.0, trace, "cuda",
                                        time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert set(result["metrics"]) == {m["name"] for m in cell.per_layer}
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["metrics"]["mnn_search_roofline"]["value"] <= 100
    else:
        assert result["metrics"]["cells_per_s"]["value"] > 0
