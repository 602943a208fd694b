"""The port's helpers, device policy and import boundary.

The numpy helpers (batching, trees) are copies of the JAX package's and are
held against them; telemetry keeps the same surface. The import guard
proves that batchelor_torch pulls in neither jax nor batchelor_tpu.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from batchelor_torch import convert, device
from batchelor_torch.utils import batching as tb
from batchelor_torch.utils import telemetry as tt
from batchelor_torch.utils import trees as ttr
from batchelor_tpu.utils import batching as jb
from batchelor_tpu.utils import trees as jtr

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_no_jax_in_the_port():
    code = (
        "import importlib, pkgutil, sys\n"
        "import batchelor_torch\n"
        "for m in pkgutil.walk_packages(batchelor_torch.__path__, 'batchelor_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'batchelor_tpu'))]\n"
        "assert not bad, bad\n"
        "new = ['ops.cosine_norm', 'ops.pca', 'ops.lowrank', 'ops.rescore_cuda', 'ops.pass1_cuda',\n"
        "       'ops.residual', 'ops.normalization', 'ops.stats', 'correct.diagnostics',\n"
        "       'correct.linear', 'correct.cluster_mnn', 'correct.dispatch', 'correct.experiments',\n"
        "       'native.bindings', 'io.csr', 'ops.pca_outofcore', 'correct.outofcore', '__main__',\n"
        "       'parallel', 'parallel.mesh', 'parallel.distributed', 'parallel.ring',\n"
        "       'parallel.driver', 'parallel.multihost']\n"
        "assert all('batchelor_torch.' + m in sys.modules for m in new)\n"
        "print('ok', len([m for m in sys.modules if m.startswith('batchelor_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok") and int(out.stdout.split()[1]) >= 20


def test_entry_points_default_to_cuda(monkeypatch, rng):
    import batchelor_torch as bt
    from batchelor_torch import find_mutual_nn, query_knn, reduced_mnn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = [rng.normal(size=(20, 3)), rng.normal(size=(20, 3))]
    counts = [rng.poisson(3.0, size=(20, 8)).astype(float) for _ in range(2)]
    pairs = [np.array([[0, 20], [1, 21], [2, 22]])]
    labels, batch = np.arange(40) % 3, np.repeat([0, 1], 20)
    ds = [bt.SingleCellDataset(assays={"logcounts": m}) for m in b]
    stores = [bt.CSRCells.from_dense(c) for c in counts]
    for call in (lambda: reduced_mnn(b), lambda: query_knn(b[0], b[1], 2),
                 lambda: find_mutual_nn(b[0], b[1], 2, 2),
                 lambda: convert.from_numpy(b[0]), lambda: device.resolve_device("cuda"),
                 lambda: bt.cluster_mnn(b, clusters=[labels[:20], labels[20:]]),
                 lambda: bt.kmeans_clusters(b[0], 2),
                 lambda: bt.rescale_batches(b), lambda: bt.regress_batches(b),
                 lambda: bt.no_correct(b), lambda: bt.multi_batch_norm(counts),
                 lambda: bt.model_gene_var(b[0]),
                 lambda: bt.mnn_delta_variance(b, pairs),
                 lambda: bt.mnn_delta_variance_blocked(b, pairs),
                 lambda: bt.cluster_abundance_test(labels, batch),
                 lambda: bt.cluster_abundance_var(labels, batch),
                 lambda: bt.batch_correct(b, params=bt.NoCorrectParams()),
                 lambda: bt.correct_experiments(ds, params=bt.NoCorrectParams()),
                 lambda: bt.quick_correct(counts, hvg_n=4),
                 lambda: list(bt.device_dense_blocks(stores[0])),
                 lambda: bt.multi_batch_pca_csr(stores, d=2),
                 lambda: bt.quick_correct_csr(stores, hvg_n=4),
                 lambda: bt.regress_batches_csr(stores),
                 lambda: bt.mnn_correct_csr(stores),
                 lambda: bt.cluster_mnn_csr(stores, clusters=[labels[:20], labels[20:]]),
                 lambda: bt.mnn_delta_variance_blocked(stores, pairs),
                 lambda: bt.make_cells_mesh()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert device.resolve_device("cpu") == torch.device("cpu")
    res = bt.quick_correct(counts, hvg_n=4, params=bt.NoCorrectParams(), device="cpu")
    assert res.corrected.corrected.device.type == "cpu"


def test_gene_space_entry_points_default_to_cuda(monkeypatch, rng):
    from batchelor_torch import fast_mnn, multi_batch_pca

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = [rng.normal(size=(20, 6)), rng.normal(size=(25, 6))]
    for call in (lambda: fast_mnn(b, d=2), lambda: multi_batch_pca(b, d=2),
                 lambda: fast_mnn(np.concatenate(b), batch=np.repeat([0, 1], [20, 25]))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    res = fast_mnn(b, d=2, k=3, device="cpu")
    assert res.corrected.device.type == "cpu" and res.rotation.shape == (6, 2)


def test_from_numpy_and_result_to_numpy(rng):
    a = rng.normal(size=(5, 3))
    t = convert.from_numpy(a, device="cpu")
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float64
    lst = convert.from_numpy([a, None, a.astype(np.float32)], device="cpu")
    assert lst[1] is None and lst[2].dtype == torch.float32
    assert convert.from_numpy(a, device="cpu", dtype=torch.float32).dtype == torch.float32
    from batchelor_torch import reduced_mnn

    res = reduced_mnn([rng.normal(size=(30, 4)), rng.normal(size=(30, 4)) + 1], k=5,
                      device="cpu")
    out = convert.result_to_numpy(res)
    assert isinstance(out.corrected, np.ndarray) and out.corrected.shape == (60, 4)
    assert isinstance(res.corrected, torch.Tensor)


def test_full_fp32_matmul_restores_setting():
    old = torch.backends.cuda.matmul.allow_tf32
    with device.full_fp32_matmul():
        assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 == old


@pytest.mark.parametrize("restrict", [None, [0, 2, 5, 6], np.arange(9) % 2 == 0])
def test_divide_into_batches_matches_jax(restrict, rng):
    x = rng.normal(size=(9, 3))
    batch = np.array(["b", "a", "c", "a", "b", "c", "a", "b", "c"])
    j = jb.divide_into_batches(x, batch, restrict=restrict)
    t = tb.divide_into_batches(x, batch, restrict=restrict)
    assert j.names == t.names and np.array_equal(j.reorder, t.reorder)
    for a, b in zip(j.batches, t.batches):
        assert np.array_equal(a, b)
    if restrict is None:
        assert t.restricted is None
    else:
        for a, b in zip(j.restricted, t.restricted):
            assert np.array_equal(a, b)


def test_batching_helpers_match_jax(rng):
    order, ncells = [2, 0, 1], [3, 4, 2]
    assert np.array_equal(jb.restore_original_order(order, ncells),
                          tb.restore_original_order(order, ncells))
    perm = rng.permutation(9)
    pairs = [rng.integers(0, 9, size=(5, 2)), np.zeros((0, 2), np.int64)]
    for a, b in zip(jb.reindex_pairings(pairs, perm), tb.reindex_pairings(pairs, perm)):
        assert np.array_equal(a, b)
    names = [["x", "y"], None]
    assert np.array_equal(jb.generate_cell_names(names, [2, 3]),
                          tb.generate_cell_names(names, [2, 3]))
    assert tb.generate_cell_names([None, None], [2, 3]) is None
    for lr, rr in ((None, None), (np.array([1]), None), (None, np.array([0, 2]))):
        j, t = jb.combine_restrict(3, lr, 4, rr), tb.combine_restrict(3, lr, 4, rr)
        assert (j is None and t is None) or np.array_equal(j, t)
    assert np.array_equal(tb.subset_to_index(["b", "a"], 2, ["a", "b"]), [1, 0])
    batches = [np.zeros((4, 3)), np.zeros((5, 3))]
    for restr in ([None, [1, 2]], [np.array([True, False, True, False]), None]):
        j, t = jb.check_restrictions(batches, restr), tb.check_restrictions(batches, restr)
        for a, b in zip(j, t):
            assert (a is None and b is None) or np.array_equal(a, b)
    with pytest.raises(ValueError):
        tb.check_batch_consistency([np.zeros((2, 3)), np.zeros((2, 4))])
    with pytest.raises(ValueError):
        tb.check_restrictions(batches, [[], None])
    mats = [rng.normal(size=(3, 4)), rng.normal(size=(2, 3))]
    names = [["a", "b", "c", "d"], ["d", "b", "a"]]
    for kw in ({}, {"subset": ["d", "a"]}, {"subset": ["d"], "keep_all": True}):
        (jm, jn), (tm, tn) = jb.intersect_rows(mats, names, **kw), tb.intersect_rows(mats, names, **kw)
        assert jn == tn and all(np.array_equal(a, b) for a, b in zip(jm, tm))


@pytest.mark.parametrize("order", [None, [2, 0, 1, 3], [[0, 1], [2, 3]], [[0, [1, 2]], 3],
                                   ["d", "a", "b", "c"]])
def test_merge_tree_walk_matches_jax(order):
    names = ["a", "b", "c", "d"]
    batches = [np.full((i + 2, 2), float(i)) for i in range(4)]

    def walk(mod):
        tree = mod.create_tree_predefined(batches, None, order, names)
        steps = []
        while isinstance(tree, list):
            left, right, path = mod.get_next_merge(tree)
            steps.append((list(left.index), list(right.index), list(path)))
            merged = mod.MergeNode(index=left.index + right.index, data=None,
                                   restrict=None, origin=np.zeros(0))
            tree = mod.update_tree(tree, path, merged)
        return steps

    assert walk(jtr) == walk(ttr)
    assert jtr.binarize_tree([[0], 1, [2, 3, 4]]) == ttr.binarize_tree([[0], 1, [2, 3, 4]])
    with pytest.raises(ValueError):
        ttr.create_tree_predefined(batches, None, [0, 0, 1, 2])


# ``walk_merge_tree`` alone, driven by a fake engine: a node's data is the
# global ids of its cells, a step concatenates the two sides and pairs the
# first rows and the last rows of the two sides, and auto-merge's counts
# come from a fixed table.
WALK_SIZES = (3, 2, 4, 1)
WALK_STARTS = (0, 3, 5, 9)
# (left batches, right batches) -> MNN pairs; the first maximum, 7, is
# (3, 0) in column-major order and (2, 1) in row-major order
WALK_COUNTS = {((1,), (0,)): 5, ((2,), (0,)): 3, ((2,), (1,)): 7, ((3,), (0,)): 7,
               ((3,), (1,)): 2, ((3,), (2,)): 6, ((3, 0), (1,)): 4, ((3, 0), (2,)): 7,
               ((2, 1), (3, 0)): 9}


class _FakeEngine:
    def __init__(self):
        self.steps, self.counts = [], []

    def leaves(self):
        return [ttr.MergeNode.leaf(i, np.arange(s, s + n))
                for i, (s, n) in enumerate(zip(WALK_STARTS, WALK_SIZES))]

    def step(self, mdx, left, right):
        self.steps.append((mdx, list(left.index), list(right.index)))
        node = ttr.MergeNode(index=list(left.index) + list(right.index),
                             data=np.concatenate([left.data, right.data]), restrict=None,
                             origin=np.concatenate([left.origin, right.origin]))
        pairs = np.array([[0, 0], [left.data.shape[0] - 1, right.data.shape[0] - 1]])
        return ttr.StepOutcome(node=node, pairs=pairs, lost_var=np.full(4, mdx / 10),
                               batch_size=float(mdx), skipped=mdx == 1)

    def count(self, a, b):
        self.counts.append((tuple(a.index), tuple(b.index)))
        return WALK_COUNTS[tuple(a.index), tuple(b.index)]


class _MemoryStore:
    """``MergeCheckpointer``'s interface, in memory."""

    def __init__(self):
        self.saved, self.completed_steps = {}, 0

    def save_step(self, mdx, tree_path, chosen, node, diag):
        self.saved[mdx] = (tree_path, chosen, node, dict(diag))
        self.completed_steps = max(self.completed_steps, mdx + 1)

    def load_step(self, mdx, device):
        return self.saved[mdx]


def _walk(engine, **kw):
    return ttr.walk_merge_tree(engine.leaves(), engine.step, count=engine.count, **kw)


def _first_last(batches):
    """Global ids of the first and the last cell of a node of ``batches``."""
    return WALK_STARTS[batches[0]], WALK_STARTS[batches[-1]] + WALK_SIZES[batches[-1]] - 1


def _same_walk(a, b):
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    for x, y in zip(a[2], b[2]):
        assert (x.left, x.right, x.batch_size, x.skipped) == (y.left, y.right, y.batch_size,
                                                              y.skipped)
        assert np.array_equal(x.pairs, y.pairs) and np.array_equal(x.lost_var, y.lost_var)


def test_walk_merge_tree_follows_a_nested_order_with_name_leaves():
    names = ["a", "b", "c", "d"]
    engine = _FakeEngine()
    data, labels, infos = _walk(engine, merge_order=[["c", "a"], ["d", "b"]], names=names)
    # the right branch first, then the left, then the root
    assert engine.steps == [(0, [3], [1]), (1, [2], [0]), (2, [2, 0], [3, 1])]
    assert engine.counts == []
    assert np.array_equal(data, np.arange(10))          # input order restored
    assert list(labels) == [names[b] for b, n in enumerate(WALK_SIZES) for _ in range(n)]
    assert [(i.left, i.right) for i in infos] == [(["d"], ["b"]), (["c"], ["a"]),
                                                  (["c", "a"], ["d", "b"])]
    for (_, left, right), info in zip(engine.steps, infos):
        # the pairs index the output, so they name the sides' first and last cells
        assert np.array_equal(data[info.pairs], np.array(list(zip(_first_last(left),
                                                                  _first_last(right)))))
    assert [(i.batch_size, i.skipped) for i in infos] == [(0.0, False), (1.0, True),
                                                          (2.0, False)]
    assert all(type(i.batch_size) is float and type(i.skipped) is bool for i in infos)


def test_walk_merge_tree_auto_merge_takes_the_first_maximum_column_major():
    engine = _FakeEngine()
    data, labels, infos = _walk(engine, auto_merge=True)
    assert engine.steps == [(0, [3], [0]), (1, [2], [1]), (2, [2, 1], [3, 0])]
    # every pair counted once at the start, then the merged node against the rest
    assert engine.counts == [((1,), (0,)), ((2,), (0,)), ((2,), (1,)), ((3,), (0,)),
                             ((3,), (1,)), ((3,), (2,)), ((3, 0), (1,)), ((3, 0), (2,)),
                             ((2, 1), (3, 0))]
    assert np.array_equal(data, np.arange(10))
    assert list(labels) == [b for b, n in enumerate(WALK_SIZES) for _ in range(n)]
    for (_, left, right), info in zip(engine.steps, infos):
        assert np.array_equal(data[info.pairs], np.array(list(zip(_first_last(left),
                                                                  _first_last(right)))))


@pytest.mark.parametrize("auto_merge", [False, True])
@pytest.mark.parametrize("stored", [1, 2])
def test_walk_merge_tree_resumes_after_stored_steps(stored, auto_merge):
    order = None if auto_merge else [[2, 0], [3, 1]]
    store = _MemoryStore()
    full = _walk(_FakeEngine(), merge_order=order, auto_merge=auto_merge, checkpointer=store)
    assert store.completed_steps == 3
    store.completed_steps = stored
    engine = _FakeEngine()
    resumed = _walk(engine, merge_order=order, auto_merge=auto_merge, checkpointer=store)
    assert [s[0] for s in engine.steps] == list(range(stored, 3))
    _same_walk(resumed, full)
    if auto_merge:       # the stored counts are taken up: only the new node is counted
        assert len(engine.counts) == 2 - stored
    else:                # a store of another tree is refused
        store.completed_steps = stored
        with pytest.raises(ValueError, match="merge tree"):
            _walk(_FakeEngine(), merge_order=[[3, 1], [2, 0]], checkpointer=store)


def test_walk_merge_tree_full_resume_counts_nothing():
    store = _MemoryStore()
    full = _walk(_FakeEngine(), auto_merge=True, checkpointer=store)
    engine = _FakeEngine()
    _same_walk(_walk(engine, auto_merge=True, checkpointer=store), full)
    assert engine.steps == [] and engine.counts == []


def test_telemetry_surface():
    rec = tt.MetricsRecorder()
    assert tt.get_recorder() is None
    with rec.activate():
        assert tt.get_recorder() is rec
        with tt.trace_span("unit/span", step=0):
            pass
        rec.add("merge_steps")
        rec.add("mnn_pairs", 7.0)
    assert tt.get_recorder() is None
    s = rec.summary()
    assert s["counters"] == {"merge_steps": 1.0, "mnn_pairs": 7.0}
    assert s["spans"]["unit/span"]["count"] == 1
    assert rec.records[0]["attrs"]["step"] == 0
    assert '"merge_steps": 1.0' in rec.dump_json()
