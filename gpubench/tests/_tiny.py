"""A cell of ``BENCHMARK.json`` cut to a size that a CPU test can hold."""
import copy
import json
import shutil

from gpubench import harness


def tiny_cell(name: str, batches=(400, 300, 250), genes: int = 200):
    cell = harness.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["batches"] = list(batches)
    cell.config["genes"] = genes
    return cell


def tiny_root(root, name: str, batches=(400, 300), chips=None, entry=None, entry_source=None):
    """The cell ``name`` cut to ``batches`` (and ``chips`` cards) as files
    under ``root``: a ``BENCHMARK.json``, the configuration, traffic mix and
    limits, and the entry modules, which a cell's other ranks read by name.
    ``entry_source`` is written as ``gpubench/entries/<entry>.py`` and
    named as the traffic's entry. Returns the loaded cell."""
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in bench["workloads"] if w["name"] == name)
    if chips is not None:
        w["chips"] = chips
    cfg_file = next(c["file"] for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((harness.ROOT / cfg_file).read_text())
    config["batches"] = list(batches)
    traffic = json.loads((harness.HERE / "traffic" / f"{w['traffic']}.json").read_text())
    here = root / harness.HERE.name
    shutil.copytree(harness.HERE / "entries", here / "entries")
    if entry_source is not None:
        (here / "entries" / f"{entry}.py").write_text(entry_source)
        traffic["entry"] = entry
    shutil.copytree(harness.HERE / "limits", here / "limits")
    files = {root / "BENCHMARK.json": bench, root / cfg_file: config,
             here / "traffic" / f"{w['traffic']}.json": traffic}
    for path, data in files.items():
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(data))
    return harness.load_cell(name, root)
