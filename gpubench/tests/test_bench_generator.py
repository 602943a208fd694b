"""The generator repeats under a seed and differs across seeds."""
import torch

from gpubench import generator
from _tiny import tiny_cell


def test_same_seed_same_batches_other_seed_others():
    cell = tiny_cell("hca_bone_marrow.fast_mnn_auto")
    seed = 2 ** 31 + 12345
    a = generator.make_batches(cell.config, "genes", seed, torch.device("cpu"))
    b = generator.make_batches(cell.config, "genes", seed, torch.device("cpu"))
    c = generator.make_batches(cell.config, "genes", seed + 1, torch.device("cpu"))
    assert [x.shape for x in a] == [(400, 200), (300, 200), (250, 200)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    pcs = generator.make_batches(cell.config, "pcs", seed, torch.device("cpu"))
    assert [x.shape[1] for x in pcs] == [cell.config["d"]] * 3
