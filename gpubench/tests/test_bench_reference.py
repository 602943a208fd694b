"""The plain reference against itself at a tiny size, and the program on
the CPU against it."""
import threading

import numpy as np
import pytest
import torch

import batchelor_torch as bt
from gpubench import compare, generator, harness, reference
from _tiny import tiny_cell

CPU = torch.device("cpu")


def test_reference_is_its_own_match_and_commutes_with_a_rotation():
    cell = tiny_cell("hca_bone_marrow.reduced_mnn_exact")
    pcs = generator.make_batches(cell.config, "pcs", 7, CPU)
    ref, followed = harness.reference_outputs(cell, pcs, [None, None])
    ref2 = harness.reference_outputs(cell, pcs, [ref["pairs"]])[0]
    for again in (compare.readings(ref, followed), compare.readings(ref, ref2)):
        assert again["pairs_miss"] == 0.0 and again["rows_err_max"] == 0.0
    q = torch.linalg.qr(torch.randn(50, 50, dtype=torch.float64,
                                    generator=torch.Generator().manual_seed(3)))[0]
    corrected, pairs = reference.merge(reference.Arith("fp64"), [(b.double() @ q) for b in pcs],
                                       k=20, ndist=3.0)
    turned = {"corrected": corrected @ q.T, "pairs": pairs}
    values = compare.readings(turned, ref)
    assert values["pairs_miss"] == 0.0
    assert values["rows_err_max"] < 1e-10


def test_gene_space_reference_pca_is_orthonormal_and_sorted():
    cell = tiny_cell("scib_immune_human.fast_mnn")
    genes = generator.make_batches(cell.config, "genes", 8, CPU)
    pcs, rotation, centers = reference.pca(reference.Arith("fp64"), genes, 50)
    eye = rotation.T @ rotation
    assert torch.allclose(eye, torch.eye(50, dtype=eye.dtype), atol=1e-10)
    # each batch weighs the same: the PCs' weighted second moments are the
    # Gram matrix's eigenvalues, in descending order
    moments = sum((p * p).sum(0) / p.shape[0] for p in pcs)
    assert bool((moments[:-1] >= moments[1:]).all())
    assert centers.shape == (200,)


def test_the_program_on_the_cpu_matches_the_reference():
    for name in ("scib_immune_human.fast_mnn", "hca_bone_marrow.reduced_mnn_exact"):
        cell = tiny_cell(name)
        inputs = generator.make_batches(cell.config, cell.traffic["input"], 9, CPU)
        entry = getattr(bt, cell.traffic["entry"])
        out = harness.program_output(entry(inputs, device=CPU, **harness.call_args(cell)))
        values = compare.readings(out, harness.reference_outputs(cell, inputs, [out["pairs"]])[0])
        assert values["pairs_miss"] < 1e-3
        assert values["rows_err_max"] < 1e-3


def test_the_control_reads_well_above_the_program():
    """The control (TF32 products, bf16 outside them, fp8 selection where the
    traffic selects in bf16) reads at least three times what the program
    reads on the rows' median, and the exact cells' limits hold it as not
    correct. (On the CPU the program's "auto" search is exact, so the
    "auto" cell's limits, which leave room for its bf16 selection on the
    card, are no test of the control at this size.)"""
    for name in ("hca_bone_marrow.fast_mnn_auto", "scib_immune_human.fast_mnn",
                 "hca_bone_marrow.reduced_mnn_exact"):
        cell = tiny_cell(name, batches=(900, 700, 500))
        inputs = generator.make_batches(cell.config, cell.traffic["input"], 10, CPU)
        entry = getattr(bt, cell.traffic["entry"])
        out = harness.program_output(entry(inputs, device=CPU, **harness.call_args(cell)))
        prog = compare.readings(out, harness.reference_outputs(cell, inputs, [out["pairs"]])[0])
        ctl_out = harness.reference_outputs(cell, inputs, [None], "tf32",
                                            harness.control_selection(cell))[0]
        ctl = compare.readings(ctl_out, harness.reference_outputs(cell, inputs, [ctl_out["pairs"]])[0])
        assert ctl["rows_err_p50"] >= 3 * prog["rows_err_p50"]
        assert ctl["centers_err"] >= 3 * prog["centers_err"] if "centers_err" in ctl else True
        if cell.traffic["selection"] != "bf16":
            ok, _ = compare.judge(ctl, cell.limits)
            assert not ok


def test_batch_median_reads_the_corrected_batch_where_the_first_holds_half():
    """Two batches of 50 rows: the median over all rows is the first
    batch's, which the merge only centres; an error in the second batch
    alone shows in ``batch_rows_err_p50`` and leaves ``rows_err_p50``."""
    g = torch.Generator().manual_seed(5)
    want = torch.randn(100, 10, dtype=torch.float64, generator=g)
    pairs = [np.array([[0, 50], [1, 51]])]
    got = want.clone()
    got[50:] += 0.2 * torch.randn(50, 10, dtype=torch.float64, generator=g)
    values = compare.readings({"corrected": got, "pairs": pairs},
                              {"corrected": want, "pairs": pairs}, sizes=[50, 50])
    assert values["rows_err_p50"] == 0.0
    assert values["batch_rows_err_p50"] > 0.05
    assert "batch_rows_err_p50" not in compare.readings({"corrected": got, "pairs": pairs},
                                                        {"corrected": want, "pairs": pairs})


class _Board:
    """Ranks as threads of one process: ``gather`` meets at a barrier."""

    def __init__(self, size):
        self.size, self.box, self.barrier = size, [None] * size, threading.Barrier(size)

    def rank(self, r):
        board = self

        class Share:
            rank, size = r, board.size

            def gather(self, obj):
                board.box[r] = obj
                board.barrier.wait()
                out = list(board.box)
                board.barrier.wait()
                return out
        return Share()


@pytest.mark.parametrize("selection", ["exact", "fp8"])
def test_a_reference_shared_over_ranks_is_the_reference_alone(monkeypatch, selection):
    """Each of 3 ranks searches a share of the query blocks and they gather
    the rows: every rank's merge is the one process's, bit for bit."""
    monkeypatch.setattr(reference, "_BLOCK_ELEMS", 4000)    # several blocks a search
    cell = tiny_cell("hca_bone_marrow.reduced_mnn_exact", batches=(230, 170, 90))
    pcs = [b.double() for b in generator.make_batches(cell.config, "pcs", 12, CPU)]
    alone = reference.merge(reference.Arith("fp64"), pcs, 20, 3.0, selection)
    board, got = _Board(3), [None] * 3

    def rank(r):
        got[r] = reference.merge(reference.Arith("fp64", board.rank(r)), pcs, 20, 3.0, selection)
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for corrected, pairs in got:
        assert torch.equal(corrected, alone[0])
        assert all(np.array_equal(a, b) for a, b in zip(pairs, alone[1]))


@pytest.mark.parametrize("name", ["hca_bone_marrow.fast_mnn_auto", "scib_immune_human.fast_mnn",
                                  "hca_bone_marrow.reduced_mnn_exact",
                                  "hca_bone_marrow.reduced_mnn_auto"])
def test_reusing_the_first_steps_own_pairs_changes_no_reading(name):
    """A judgement's followed merge takes the first step's own pairs from
    the reference's own merge (``first_pairs``); searched again alone, it
    is the same merge, so every reading of the one-card cells stays.
    (``quick_correct``'s reference searches every step itself.)"""
    cell = tiny_cell(name)
    inputs = generator.make_batches(cell.config, cell.traffic["input"], 13, CPU)
    out = harness.program_output(harness.entry_call(cell, bt, CPU)(inputs))
    own, followed = harness.reference_outputs(cell, inputs, [None, out["pairs"]])
    alone = harness.reference_outputs(cell, inputs, [out["pairs"]])[0]
    assert torch.equal(followed["corrected"], alone["corrected"])
    assert all(np.array_equal(a, b) for a, b in zip(followed["pairs"], alone["pairs"]))
    assert compare.readings(out, followed) == compare.readings(out, alone)
