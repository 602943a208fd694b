"""Every cell, configuration, traffic mix, limit and metric of
BENCHMARK.json is found by name and parses."""
import json
import re

import pytest

from gpubench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


FASTMNN_READINGS = {"centers_err", "pairs_miss", "rows_err_p50", "batch_rows_err_p50", "rows_err_max",
                    "own_rows_err_p50"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_with_its_files(cell):
    c = harness.load_cell(cell)
    assert c.chips in (1, 4)
    assert c.config["name"] == cell.split(".")[0]
    assert sum(c.config["batches"]) > 0
    # the traffic's entry finds its module by name
    assert c.entry.__file__ == str(harness.HERE / "entries" / f"{c.traffic['entry']}.py")
    for name in ("make_inputs", "output", "judge"):
        assert callable(getattr(c.entry, name)), name
    assert c.limits, "every cell has its limits file"
    # every limit is of a number that the entry's judgement reads
    assert set(c.limits) <= set(c.entry.READINGS)
    if hasattr(c.entry, "FAULTS"):
        assert c.entry.FAULTS and callable(c.entry.planted)
    # each quantity under its own name or a "<quantity>.<part>" of it
    assert {m["name"].split(".")[0] for m in c.end_to_end} >= {"cells_per_s", "peak_mem_gib", "setup_s"}
    assert c.per_layer
    if c.traffic["entry"] in ("fast_mnn", "reduced_mnn", "distributed_fast_mnn"):
        assert c.config["d"] == c.config["generator"]["rank"]
        assert c.traffic["input"] in ("genes", "pcs")
        args = harness.call_args(c)
        assert args["k"] == c.config["k"]
        assert set(c.limits) <= FASTMNN_READINGS
        assert ("centers_err" in c.limits) == (c.traffic["input"] == "genes")
        pca_read = {"centers_err"} if c.traffic["input"] == "genes" else set()
        assert set(c.entry.READINGS) == FASTMNN_READINGS - {"centers_err"} | pca_read


def test_names_and_metric_readers():
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] == "cells_per_s"
    for c in BENCH["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
