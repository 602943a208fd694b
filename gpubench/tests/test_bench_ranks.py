"""The harness's multi-rank path on the CPU: a cut of the four-card cell
``tenx_brain_1_3m.distributed_exact`` run through ``run.run_cell`` as
worlds of 2 and 3 ranks over gloo (the program's group is gloo on the
CPU, where it is NCCL between cards). The ranks make the same inputs and
the same calls, rank 0 judges the run correct, each fault of the entry
module planted on every rank makes it not correct, a worker that fails
makes rank 0 fail with no child left, ``readings.py`` plants its faults on
every rank, and a cell on one card starts no worker. Every rank judges:
rank 0 its kept outputs, all of them a share of the reference's searches."""
import json
import os
import time
from pathlib import Path

import pytest

import batchelor_torch as bt
from gpubench import ranks, readings, run
from _tiny import tiny_cell, tiny_root

CELL = "tenx_brain_1_3m.distributed_exact"
SEED = 2 ** 31 + 21
BATCHES = (400, 300)

# an entry that is the distributed one with one change on some ranks
WRAPPED = '''import os

import torch.distributed as dist

from gpubench.entries.distributed_fast_mnn import *  # noqa: F401,F403
from gpubench.entries import distributed_fast_mnn as base

FAULT = {fault!r}
CHANGE = {change!r}


def make_inputs(cell, seed, device):
    inputs = base.make_inputs(cell, seed, device)
    if CHANGE == "inputs_differ":
        inputs[0][0, 0] += int(os.environ.get("LOCAL_RANK", "0"))
    return inputs


def bind(cell, bt, device):
    if CHANGE == "rank_1_raises" and dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails at set-up")
    call = base.bind(cell, bt, device)
    if not FAULT:
        return call

    def planted_call(inputs):                   # on every rank, in every call
        with base.planted(FAULT):
            return call(inputs)
    return planted_call
'''


def _cell(tmp_path, world, fault=None, change=None):
    source = WRAPPED.format(fault=fault, change=change) if fault or change else None
    return tiny_root(tmp_path, CELL, BATCHES, chips=world, entry="distributed_wrapped",
                     entry_source=source)


def _run(cell, seed=SEED):
    return run.run_cell(cell, bt, seed, 0.2, False, "cpu", time.perf_counter())


def _children():
    """This process's children that run a rank of the benchmark."""
    me, out = os.getpid(), []
    for proc in Path("/proc").iterdir():
        if not proc.name.isdigit():
            continue
        try:
            ppid = int((proc / "stat").read_text().rsplit(")", 1)[1].split()[1])
            cmd = (proc / "cmdline").read_bytes().decode(errors="replace")
        except (OSError, IndexError, ValueError):
            continue
        if ppid == me and "gpubench" in cmd:
            out.append(int(proc.name))
    return out


@pytest.mark.parametrize("world", [2, 3])
def test_ranks_make_the_same_calls_and_rank_0_judges_correct(tmp_path, world):
    result, parts, extra = _run(_cell(tmp_path, world))
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["device"]["count"] == world
    # every rank: the warm call and the window's calls, in step
    assert extra["calls_by_rank"] == [1 + result["attempted"]] * world
    assert "ranks_s" in parts                   # the groups formed and the inputs agreed
    assert set(result["metrics"]) == {"cells_per_s", "peak_mem_gib", "setup_s"}
    assert _children() == []


def test_ranks_that_make_different_inputs_fail(tmp_path):
    with pytest.raises(RuntimeError, match="different inputs"):
        _run(_cell(tmp_path, 2, change="inputs_differ"))
    assert _children() == []


def test_a_worker_that_raises_fails_rank_0_and_leaves_no_child(tmp_path):
    t = time.perf_counter()
    with pytest.raises(Exception):
        _run(_cell(tmp_path, 2, change="rank_1_raises"))
    assert time.perf_counter() - t < ranks.TIMEOUT_S
    assert _children() == []


@pytest.mark.parametrize("fault", ["unchanged", "half_pairs", "sums_not_reduced", "altered_row"])
def test_a_fault_on_every_rank_is_not_correct(tmp_path, fault):
    result, _, extra = _run(_cell(tmp_path, 2, fault=fault))
    assert not result["correct"]
    assert result["failed"] >= 1
    if fault == "unchanged":
        # the right batch uncorrected: its median reads it, the median over
        # every row (here the left batch's, which is only centred) does not
        values = extra["readings"]
        assert values["batch_rows_err_p50"] > 1e3 * values["rows_err_p50"]


def test_readings_plant_faults_on_every_rank(tmp_path):
    cell = _cell(tmp_path, 2)
    rows = []
    summary = readings.read_cell(cell, bt, [SEED, SEED + 1], 1, 1, "cpu", rows.append)
    assert [(r["seed"], r["side"]) for r in rows] == (
        [(SEED, "program"), (SEED, "control")]
        + [(SEED, f"fault:{f}") for f in cell.entry.FAULTS] + [(SEED + 1, "program")])
    limits = cell.limits

    def fails(values):
        return any(not values[k] <= v for k, v in limits.items())

    assert not fails(summary["program_max"]), summary["program_max"]
    # at this size the control need not fail the cell's limits; it reads above the program
    assert summary["control_min"]["rows_err_p50"] > 10 * summary["program_max"]["rows_err_p50"]
    for name, values in summary["faults_min"].items():
        assert fails(values), (name, values)
    assert _children() == []


def test_a_cell_on_one_card_starts_no_worker(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a cell on one card started a worker")
    monkeypatch.setattr(ranks.subprocess, "Popen", refuse)
    result, parts, extra = _run(tiny_cell("hca_bone_marrow.reduced_mnn_exact"), SEED)
    assert result["correct"], result["checks"]
    assert extra["calls_by_rank"] == [1 + result["attempted"]]
    assert "ranks_s" not in parts


def test_rank_cores_are_their_own():
    allowed = list(range(32))
    got = [ranks.cores(r, 4, allowed) for r in range(4)]
    assert got == [[30, 31], [28, 29], [26, 27], [24, 25]]
    assert ranks.cores(0, 1, allowed) == [30, 31]
    few = [ranks.cores(r, 4, range(6)) for r in range(4)]
    assert few == [[4, 5], [3], [2], [1]]


def test_checksum_is_exact_and_sees_one_bit():
    import torch

    a = [torch.randn(50, 7, generator=torch.Generator().manual_seed(1))]
    b = [a[0].clone()]
    assert ranks.checksum(a) == ranks.checksum(b)
    b[0].view(-1).view(torch.int32)[13] ^= 1
    assert ranks.checksum(a) != ranks.checksum(b)


def test_benchmark_has_one_cell_on_four_cards():
    bench = json.loads((Path(run.__file__).resolve().parent.parent / "BENCHMARK.json").read_text())
    four = [w["name"] for w in bench["workloads"] if w["chips"] == 4]
    assert four == [CELL]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
