"""The port's dispatch API and pipelines against the JAX package's, on the CPU
in fp64, and the port's export surface.

Covers the dispatch, quick_correct, correct_experiments and apply_multi
cases of tests/test_diagnostics_api.py and every case of
tests/test_experiments_parity.py: each runs the batchelor_tpu function and
its batchelor_torch counterpart (``device="cpu"``) on the same numpy
inputs. A fastMNN result is held as test_torch_fast_mnn_gene.py holds one:
pairs identical in every step, corrected values and rotation within 1e-8
after turning each port column to the sign of JAX's; the other engines'
corrected values within 1e-8; HVGs identical and the variance model within
1e-10; datasets by their assays (1e-8), metadata, names and warnings. The
JAX calls cost seconds, so the cases share shapes and JAX's compiled code.
"""
import ast
import os
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import batchelor_torch as bt
import batchelor_tpu as bj
from batchelor_torch import convert
from test_torch_fast_mnn_gene import _assert_same as _same_mnn
from jax_trend import port_trend_in_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX package's exports that the port does not have yet: none since the
# parallel layer (ROADMAP Queue 1 item 10).
STILL_TO_PORT = []


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_result(j, t):
    if isinstance(t, bt.MNNResult) and t.rotation is not None:
        _same_mnn(j, t)
        return
    if isinstance(t, bt.MNNResult):                    # classic mnnCorrect: gene space
        for a, b in zip(j.merge_info, t.merge_info):
            assert np.array_equal(a.pairs, b.pairs)
    assert np.allclose(np.asarray(j.corrected), _np(t.corrected), atol=1e-8, rtol=0)
    assert np.array_equal(np.asarray(j.batch), np.asarray(t.batch))
    for f in ("cell_names", "gene_names"):
        a, b = getattr(j, f, None), getattr(t, f, None)
        assert (a is None and b is None) or list(a) == list(b), f


def _same_dataset(j, t):
    assert set(j.assays) == set(t.assays)
    for nm in j.assays:
        a, b = np.asarray(j.assays[nm]), np.asarray(t.assays[nm])
        assert a.shape == b.shape, nm
        if nm not in ("reconstructed",):
            assert np.allclose(a, b, atol=1e-8), nm
    assert set(j.reduced) == set(t.reduced)
    assert set(j.cell_meta) == set(t.cell_meta)
    for nm in j.cell_meta:
        assert np.array_equal(np.asarray(j.cell_meta[nm]), np.asarray(t.cell_meta[nm])), nm
    assert set(j.gene_meta) == set(t.gene_meta)
    assert set(j.metadata) == set(t.metadata) and set(j.alts) == set(t.alts)
    assert j.gene_names == t.gene_names and j.cell_names == t.cell_names


# ------------------------------------------------------------------ exports


def test_export_surface_covers_the_jax_package():
    tree = ast.parse(open(os.path.join(REPO, "batchelor_tpu", "__init__.py")).read())
    names = [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
             for a in node.names]
    missing = sorted(n for n in names if n not in bt.__all__)
    assert missing == sorted(STILL_TO_PORT)
    assert all(hasattr(bt, n) for n in bt.__all__)
    from batchelor_torch.correct.cluster_mnn import kmeans_clusters
    assert bt.kmeans_clusters is kmeans_clusters


# ----------------------------------------------------------------- dispatch


PARAMS = {
    "fast": (lambda m: m.FastMNNParams(d=10)),
    "classic": (lambda m: m.ClassicMNNParams(var_adj=False)),
    "rescale": (lambda m: m.RescaleParams()),
    "regress": (lambda m: m.RegressParams(keep=[0])),
    "none": (lambda m: m.NoCorrectParams()),
    "default": (lambda m: None),
}


@pytest.fixture(scope="module")
def dispatch_inputs():
    rng = np.random.default_rng(42)
    b1 = np.abs(rng.normal(size=(60, 30))) + 0.1
    b2 = np.abs(rng.normal(size=(70, 30))) + 0.6
    jax_out = {name: bj.batch_correct([jnp.asarray(b1), jnp.asarray(b2)], params=p(bj))
               for name, p in PARAMS.items()}
    return b1, b2, jax_out


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_batch_correct_dispatch_matches_jax(name, dispatch_inputs):
    b1, b2, jax_out = dispatch_inputs
    t = bt.batch_correct([b1, b2], params=PARAMS[name](bt), device="cpu")
    _same_result(jax_out[name], t)
    shape = {"fast": (130, 10), "default": (130, 30)}.get(name, (130, 30))
    assert tuple(t.corrected.shape) == shape


def test_batch_correct_extension_and_names(rng):
    class MyParams(bt.BatchelorParams):
        pass

    seen = {}

    @bt.register_correction(MyParams)
    def _mine(batches, batch, restrict, subset_row, correct_all, batch_names, p, device=None):
        seen["device"] = device
        return "custom"

    assert bt.batch_correct([np.zeros((3, 2)), np.zeros((4, 2))], params=MyParams(),
                            device="cpu") == "custom"
    assert seen["device"] == torch.device("cpu")
    with pytest.raises(TypeError, match="no correction registered"):
        bt.batch_correct([np.zeros((3, 2))], params=bt.BatchelorParams(), device="cpu")
    b1, b2 = rng.normal(size=(20, 10)), rng.normal(size=(25, 10))
    kw = dict(cell_names=[[f"a{i}" for i in range(20)], None],
              gene_names=[f"g{i}" for i in range(10)], subset_row=np.arange(4))
    j = bj.batch_correct([jnp.asarray(b1), jnp.asarray(b2)], params=bj.NoCorrectParams(), **kw)
    t = bt.batch_correct([b1, b2], params=bt.NoCorrectParams(), device="cpu", **kw)
    _same_result(j, t)
    assert t.cell_names[0] == "a0" and t.cell_names[20] == ""
    assert list(t.gene_names) == [f"g{i}" for i in range(4)]
    kw = dict(cell_names=[[f"a{i}" for i in range(20)], [f"b{i}" for i in range(25)]],
              gene_names=[f"g{i}" for i in range(10)], subset_row=np.arange(4))
    _same_result(bj.rescale_batches([jnp.asarray(b1), jnp.asarray(b2)], **kw),
                 bt.rescale_batches([b1, b2], device="cpu", **kw))


# ------------------------------------------------------------ quick_correct


@pytest.fixture(scope="module")
def counts():
    rng = np.random.default_rng(7)
    c1 = rng.poisson(5.0, size=(80, 100)).astype(np.float64)
    c2 = rng.poisson(10.0, size=(90, 100)).astype(np.float64)
    return c1, c2


@pytest.mark.parametrize("single", [False, True])
def test_quick_correct_matches_jax(single, counts):
    c1, c2 = counts
    p = dict(hvg_n=40)
    if single:
        order = np.random.default_rng(3).permutation(170)
        x, batch = np.concatenate([c1, c2])[order], np.repeat([1, 0], [80, 90])[order]
        with port_trend_in_jax():
            j = bj.quick_correct(jnp.asarray(x), batch, params=bj.FastMNNParams(d=10), **p)
        t = bt.quick_correct(x, batch, params=bt.FastMNNParams(d=10), device="cpu", **p)
    else:
        names = [[f"g{i}" for i in range(100)], [f"g{i}" for i in range(99, -1, -1)]]
        c2r = c2[:, ::-1]                      # the same genes in another order
        with port_trend_in_jax():
            j = bj.quick_correct([c1, c2r], params=bj.FastMNNParams(d=10), gene_names=names,
                                 **p)
        t = bt.quick_correct([c1, c2r], params=bt.FastMNNParams(d=10), gene_names=names,
                             device="cpu", **p)
    assert np.array_equal(j.hvgs, t.hvgs) and t.hvgs.shape == (40,)
    for f in ("mean", "total", "tech", "bio"):
        assert np.allclose(getattr(j.dec, f), getattr(t.dec, f), atol=1e-10, rtol=0), f
    _same_mnn(j.corrected, t.corrected)
    assert tuple(t.corrected.corrected.shape) == (170, 10)
    assert tuple(t.corrected.rotation.shape) == (100, 10)     # correct_all=True
    with pytest.raises(ValueError, match="batch"):
        bt.quick_correct(c1, device="cpu")


# ------------------------------------------------------ correct_experiments


def _mkds(mod, rng, n, g=20, prefix="c", extra_meta=None, gene_meta=None):
    gm = {"symbol": np.array([f"s{i}" for i in range(g)], dtype=object)}
    gm.update(gene_meta or {})
    cm = {"label": np.arange(n) % 3}
    cm.update(extra_meta or {})
    return mod.SingleCellDataset(
        assays={"logcounts": rng.normal(size=(n, g)),
                "counts": rng.poisson(3, size=(n, g)).astype(float)},
        gene_names=[f"g{i}" for i in range(g)],
        cell_names=[f"{prefix}{i}" for i in range(n)],
        cell_meta=cm, gene_meta=gm,
    )


def _both(case, seed=11):
    """The case's inputs built twice from one seed: (JAX datasets, port datasets)."""
    return case(bj, np.random.default_rng(seed)), case(bt, np.random.default_rng(seed))


def _conflicts(mod, rng):
    return [_mkds(mod, rng, 40, prefix="x", extra_meta={"batch": np.zeros(40)},
                  gene_meta={"rotation": np.zeros(20)}),
            _mkds(mod, rng, 40, prefix="y", extra_meta={"batch": np.ones(40)},
                  gene_meta={"rotation": np.zeros(20)})]


def _flaky(mod, rng):
    return [_mkds(mod, rng, 40, gene_meta={"flaky": np.arange(20)}),
            _mkds(mod, rng, 40, gene_meta={"flaky": np.arange(20) + 1})]


def _mixed_names(mod, rng):
    d1, d2 = _mkds(mod, rng, 40, prefix="a"), _mkds(mod, rng, 40, prefix="b")
    d2.cell_names = None
    return [d1, d2]


def _single(mod, rng):
    ds = _mkds(mod, rng, 80, prefix="z")
    ds.alts["adt"] = _mkds(mod, rng, 80, g=5)
    ds.metadata["note"] = "hello"
    return [ds]


# (inputs, options, engine): the cases about the grafting of fastMNN's own
# output (its reconstructed assay, rotation and merge_info) run fastMNN;
# the bookkeeping the engine does not touch runs noCorrect, which costs the
# JAX package no compilation
EXPERIMENTS = {
    "grafts_and_conflicts": (_conflicts, {}, "FastMNNParams"),
    "gene_meta": (_flaky, {}, "NoCorrectParams"),
    "cell_names_mixed": (_mixed_names, {}, "NoCorrectParams"),
    "add_single": (_single, {"batch": np.repeat([0, 1], 40)}, "FastMNNParams"),
    "add_single_subset": (_single, {"batch": np.repeat([0, 1], 40), "subset_row": np.arange(10)},
                          "NoCorrectParams"),
    "add_single_false": (_single, {"batch": np.repeat([0, 1], 40), "add_single": False},
                         "NoCorrectParams"),
}


@pytest.mark.parametrize("name", sorted(EXPERIMENTS))
def test_correct_experiments_matches_jax(name):
    case, kw, engine = EXPERIMENTS[name]
    jin, tin = _both(case)
    outs, msgs = [], []
    for mod, inputs, extra in ((bj, jin, {}), (bt, tin, {"device": "cpu"})):
        params = getattr(mod, engine)(**({"d": 4} if engine == "FastMNNParams" else {}))
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            outs.append(mod.correct_experiments(inputs, params=params, **kw, **extra))
        msgs.append(sorted(str(w.message) for w in rec if "ignoring" in str(w.message)))
    j, t = outs
    assert msgs[0] == msgs[1]
    _same_dataset(j, t)
    if engine == "FastMNNParams":
        rj, rt = np.asarray(j.assays["reconstructed"]), np.asarray(t.assays["reconstructed"])
        assert np.allclose(rj, rt, atol=1e-8 * np.abs(rj).max())  # signs cancel in gene space
        assert tuple(t.reduced["corrected"].shape) == (80, 4) and "merge_info" in t.metadata
    else:
        assert np.allclose(np.asarray(j.assays["corrected"]), _np(t.assays["corrected"]))
    if name == "grafts_and_conflicts":
        assert any("cell_meta" in m for m in msgs[1]) and any("gene_meta" in m for m in msgs[1])
        assert set(np.asarray(t.cell_meta["batch"]).tolist()) == {0, 1}
        assert "logcounts" in t.assays and "counts" in t.assays
        assert "label" in t.cell_meta and "symbol" in t.gene_meta
    if name == "gene_meta":
        assert any("flaky" in m for m in msgs[1]) and "flaky" not in t.gene_meta
    if name == "add_single":
        assert "adt" in t.alts and t.metadata["note"] == "hello" and "merge_info" in t.metadata
    if name == "add_single_subset":
        assert tuple(t.assays["logcounts"].shape) == (80, 10)
        assert list(t.gene_meta["symbol"]) == [f"s{i}" for i in range(10)]
    if name == "add_single_false":
        assert "logcounts" not in t.assays
    if name == "cell_names_mixed":
        assert t.cell_names[40:] == [""] * 40


# -------------------------------------------------------------- apply_multi


def _with_alts(mod, rng):
    out = [_mkds(mod, rng, 40, prefix="p"), _mkds(mod, rng, 40, prefix="q")]
    for ds in out:
        ds.alts["spike"] = _mkds(mod, rng, 40, g=6)
    return out


def test_apply_multi_simplify_matches_jax():
    jin, tin = _both(_with_alts)
    j = bj.apply_multi(jin, bj.correct_experiments, params=bj.NoCorrectParams())
    t = bt.apply_multi(tin, bt.correct_experiments, params=bt.NoCorrectParams(), device="cpu")
    assert isinstance(t, bt.SingleCellDataset) and t.n_cells == 80
    _same_dataset(j, t)
    _same_dataset(j.alts["spike"], t.alts["spike"])


def test_apply_multi_unsimplifiable_and_args_match_jax():
    jin, tin = _both(_with_alts)

    def correct(mod, **extra):
        return lambda inputs: mod.batch_correct(
            [x.assay("logcounts") for x in inputs], params=mod.RegressParams(), **extra)

    j = bj.apply_multi(jin, correct(bj))
    t = bt.apply_multi(tin, correct(bt, device="cpu"))
    assert set(t) == set(j) == {"main", "spike"}
    for nm in t:
        _same_result(j[nm], t[nm])
    calls = []

    def fn(inputs, **kw):
        calls.append(kw)
        return bt.no_correct([x.assay("logcounts") for x in inputs], device="cpu")

    out = bt.apply_multi(tin, fn, main_args=None, alt_args={"spike": {"marker": 1}},
                         simplify=False)
    assert set(out) == {"spike"} and calls == [{"marker": 1}]

    def boom(inputs):
        raise ValueError("inner")

    with pytest.raises(RuntimeError, match="main experiments"):
        bt.apply_multi(tin, boom)


def test_reconstructed_names_and_batch_size_match_jax(rng):
    b = [rng.normal(size=(40, 20)), rng.normal(size=(40, 20)) + 2.0]
    x, batch = np.concatenate(b), np.array([0, 1] * 40)
    names = [f"cell{i}" for i in range(80)]
    j = bj.fast_mnn(jnp.asarray(x), batch, d=4, cell_names=names, min_batch_skip=None)
    t = bt.fast_mnn(x, batch, d=4, cell_names=names, min_batch_skip=None, device="cpu")
    _same_mnn(j, t)
    assert list(t.cell_names) == names
    assert np.isfinite(t.merge_info[0].batch_size) and t.merge_info[0].batch_size > 0
    rec = t.reconstructed()
    assert isinstance(rec, bt.LowRankOp) and rec.shape == (20, 80)
    dense = (t.rotation @ t.corrected.T).numpy()
    assert np.allclose(t.reconstructed(rows=[1, 2], cols=np.arange(10)).numpy(),
                       dense[[1, 2]][:, :10])
    out = convert.result_to_numpy(t)
    assert isinstance(out.corrected, np.ndarray) and isinstance(t.corrected, torch.Tensor)
