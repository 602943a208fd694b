"""More cases of the port's reduced_mnn against the JAX package's (CPU, fp64).

The helpers and tolerances are those of test_torch_fast_mnn.py; the cases
are split over two files so the test workers run them side by side.
"""
import numpy as np
import pytest
import torch

from batchelor_torch import reduced_mnn as t_reduced_mnn
from test_torch_fast_mnn import _assert_same, _both, _case, _toy

torch.set_num_threads(2)

CASES = ["min_batch_skip", "prop_k_names", "toy_two", "toy_three", "toy_tree"]


@pytest.mark.parametrize("name", CASES)
def test_reduced_mnn_matches_jax_more(name, rng):
    inputs, kw = _case(name, rng)
    _assert_same(*_both(inputs, **kw))


def test_reduced_mnn_orthogonalization_toys_values():
    """The exact geometric toys of tests/test_fast_mnn.py hold in the port."""
    core, b1, b2 = _toy()
    c = t_reduced_mnn([core, b1], k=1, device="cpu").corrected.numpy()
    assert np.allclose(c[:, 0], 5.5, atol=1e-8)
    assert np.allclose(c[:, 1], np.concatenate([core[:, 1], b1[:, 1]]), atol=1e-8)
    c = t_reduced_mnn([core, b1, b2], k=1, device="cpu").corrected.numpy()
    assert np.allclose(c, 5.5, atol=1e-8)


def test_reduced_mnn_cell_names_and_recorder(rng):
    from batchelor_torch import MetricsRecorder

    b = [rng.normal(size=(60, 8)), rng.normal(size=(70, 8)) + 1]
    names = [[f"a{i}" for i in range(60)], None]
    rec = MetricsRecorder()
    with rec.activate():
        out = t_reduced_mnn(b, cell_names=names, device="cpu")
    assert out.cell_names.shape == (130,) and out.cell_names[0] == "a0"
    assert out.cell_names[60] == ""
    assert rec.counters["merge_steps"] == 1.0
    assert rec.counters["cells_merged"] == 130.0
    assert rec.counters["mnn_pairs"] == float(out.merge_info[0].pairs.shape[0])
    assert rec.spans["fastmnn/mnn_search"]


def test_reduced_mnn_rejects_checkpoint_dir(rng, tmp_path):
    # checkpoint_dir works (tests/test_torch_checkpoint.py); a store written
    # for another merge tree is rejected
    b = [rng.normal(size=(30, 4)) + s for s in (0.0, 1.0, 2.0)]
    t_reduced_mnn(b, checkpoint_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="merge tree"):
        t_reduced_mnn(b, merge_order=[2, 0, 1], checkpoint_dir=str(tmp_path), device="cpu")
