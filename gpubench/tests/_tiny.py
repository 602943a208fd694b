"""A cell of ``BENCHMARK.json`` cut to a size that a CPU test can hold."""
import copy

from gpubench import harness


def tiny_cell(name: str, batches=(400, 300, 250), genes: int = 200):
    cell = harness.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["batches"] = list(batches)
    cell.config["genes"] = genes
    return cell
