"""The port's spans and counters: the span tree of a merge, the kNN
counters, the recorder's clock against the profiler's, and that no span
enters a profiler annotation while no profiler runs."""
import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import batchelor_torch as bt
from batchelor_torch.utils import telemetry as tt

torch.set_num_threads(2)

SIZES = (40, 30, 35)
K = 5
D = 5

STEP = ("fastmnn/step", [
    ("correction/per_batch_var", []),
    ("correction/per_batch_var", []),
    ("fastmnn/orthogonalize", []),
    ("fastmnn/mnn_search", [("knn/exact", []), ("knn/exact", []),
                            ("mnn/pairs", []), ("mnn/pairs", [])]),
    ("fastmnn/correct", [
        ("correction/per_batch_var", []),
        ("correction/per_batch_var", []),
        ("correction/tricube_search", [("knn/exact", [])]),
    ]),
])
PCA = [("fastmnn/cosine_norm", []),
       ("fastmnn/pca", [("pca/center_scale", []), ("pca/gram", []), ("pca/eigh", []),
                        ("pca/project", []), ("pca/project", [])])]


def _batches(width):
    rng = np.random.default_rng(3)
    base = rng.normal(size=(4, width))
    return [(base[rng.integers(0, 4, n)] + 0.3 * rng.normal(size=(n, width)) + 0.5 * b)
            .astype(np.float32) for b, n in enumerate(SIZES)]


def _tree(records, parent):
    return [(r["name"], _tree(records, i)) for i, r in enumerate(records)
            if r["parent"] == parent]


def _expected_search_counts(merge_info):
    """(searches, scores, flops, bytes) of one call's exact searches from the
    batch sizes and the pairs: per step the two MNN searches and the
    tricube search of the right cells over their MNN-involved cells."""
    out = np.zeros(4)
    n_left = SIZES[0]
    for n_right, info in zip(SIZES[1:], merge_info):
        n_uniq = len(np.unique(info.pairs[:, 1]))
        for nq, nd, k in ((n_left, n_right, K), (n_right, n_left, K),
                          (n_right, n_uniq, min(K, n_uniq))):
            out += (1, nq * nd, 2 * D * nq * nd, (nq + nd) * D * 4 + nq * k * 12)
        n_left += n_right
    return out


@pytest.mark.parametrize("entry", ["fast_mnn", "reduced_mnn"])
def test_merge_span_tree_and_knn_counters(entry):
    if entry == "fast_mnn":
        batches, kw, inner = _batches(20), {"d": D}, PCA
    else:
        batches, kw, inner = _batches(D), {}, []
    rec = bt.MetricsRecorder()
    with rec.activate():
        outs = [getattr(bt, entry)(batches, k=K, device="cpu", **kw) for _ in range(2)]
    call = ("fastmnn/call", inner + [STEP, STEP])
    assert _tree(rec.records, None) == [call, call]
    roots = [i for i, r in enumerate(rec.records) if r["parent"] is None]
    for i, r in enumerate(rec.records):
        root = i
        while rec.records[root]["parent"] is not None:
            root = rec.records[root]["parent"]
        assert r["call"] == roots.index(root)
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            p = rec.records[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] and r["end_ns"] <= p["end_ns"]
    assert [rec.records[i]["attrs"] for i in roots] == [{"entry": entry}] * 2
    steps = [r["attrs"]["step"] for r in rec.records if r["name"] == "fastmnn/step"]
    assert steps == [0, 1, 0, 1]
    for r in rec.records:
        if r["name"] == "knn/exact":
            assert r["attrs"]["mode"] == "exact" and r["attrs"]["nq"] > 0
    want = sum(_expected_search_counts(o.merge_info) for o in outs)
    got = [rec.counters[f"knn/exact/{c}"] for c in ("searches", "scores", "flops", "bytes")]
    assert got == want.tolist()
    scores = sum(r["attrs"]["nq"] * r["attrs"]["nd"] for r in rec.records
                 if r["name"] == "knn/exact")
    assert rec.counters["knn/exact/scores"] == scores
    assert "knn/two_pass/searches" not in rec.counters      # no card: "exact" only
    assert rec.counters["merge_steps"] == 4


def test_recorded_spans_lie_on_the_profiler_clock(tmp_path):
    rec = bt.MetricsRecorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof, rec.activate():
        for i in range(4):
            with tt.trace_span("unit/outer", i=i):
                with tt.trace_span("unit/inner"):
                    torch.ones(1000).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    ann = sorted((e for e in trace["traceEvents"]
                  if e.get("cat") == "user_annotation" and e["name"].startswith("unit/")),
                 key=lambda e: e["ts"])
    assert [e["name"] for e in ann] == [r["name"] for r in rec.records]
    for e, r in zip(ann, rec.records):
        a0 = e["ts"] * 1e3 + base
        a1 = a0 + e["dur"] * 1e3
        assert 0 <= a0 - r["start_ns"] <= 1e6
        assert 0 <= r["end_ns"] - a1 <= 1e6


def test_no_profiler_no_annotation(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tt.get_recorder() is None and not torch.autograd._profiler_enabled()
    with tt.trace_span("unit/span", step=0):
        pass
    out = bt.reduced_mnn(_batches(D), k=K, device="cpu")
    assert out.corrected.shape == (sum(SIZES), D)
    # a recorder alone records the span, with no annotation for no profiler
    rec = bt.MetricsRecorder()
    with rec.activate(), tt.trace_span("unit/span"):
        pass
    assert [r["name"] for r in rec.records] == ["unit/span"]


def test_summary_keeps_its_fields_and_dumps_records():
    rec = bt.MetricsRecorder()
    with rec.activate():
        for _ in range(3):
            with tt.trace_span("unit/a"):
                with tt.trace_span("unit/b", step=2):
                    pass
        with contextlib.suppress(KeyError), tt.trace_span("unit/raises"):
            raise KeyError
        rec.add("unit/count", torch.tensor(4))
    s = rec.summary()
    assert set(s["spans"]) == {"unit/a", "unit/b", "unit/raises"}
    for name, count in (("unit/a", 3), ("unit/b", 3), ("unit/raises", 1)):
        agg = s["spans"][name]
        assert set(agg) == {"count", "total_s", "max_s"}      # no card: no device_ms
        assert agg["count"] == count and 0 <= agg["max_s"] <= agg["total_s"]
        assert agg["total_s"] == pytest.approx(sum(rec.spans[name]))
    assert s["counters"] == {"unit/count": 4.0}
    dumped = json.loads(rec.dump_json())
    assert dumped["records"][1] == {**rec.records[1], "attrs": {"step": 2}}
    assert [r["call"] for r in dumped["records"]] == [0, 0, 1, 1, 2, 2, 3]


def test_quick_correct_spans_and_counters():
    rng = np.random.default_rng(5)
    rates = rng.gamma(1.0, 3.0, size=60)
    counts = [rng.poisson(rates * (1 + 0.5 * b), size=(n, 60)).astype(np.float32)
              for b, n in enumerate(SIZES)]
    rec = bt.MetricsRecorder()
    with rec.activate():
        res = bt.quick_correct(counts, hvg_n=30, params=bt.FastMNNParams(d=D, k=K), device="cpu")
    top = [r["name"] for r in rec.records if r["parent"] is None]
    assert top == ["quickcorrect/normalize", "quickcorrect/model_gene_var", "quickcorrect/correct"]
    call = next(r for r in rec.records if r["name"] == "fastmnn/call")
    assert rec.records[call["parent"]]["name"] == "quickcorrect/correct"
    assert {k: v for k, v in rec.counters.items() if k.startswith("quickcorrect/")} == {
        "quickcorrect/hvgs": 30.0}
    assert len(res.hvgs) == 30
    # one host fit a batch on the CPU, each inside the variance model's span
    assert {k: v for k, v in rec.counters.items() if k.startswith("trend/")} == {
        "trend/host_fits": float(len(SIZES))}
    fits = [r for r in rec.records if r["name"] == "trend/fit"]
    assert [rec.records[r["parent"]]["name"] for r in fits] == ["quickcorrect/model_gene_var"] * 3
    assert all(r["attrs"]["path"] == "host" and r["attrs"]["genes"] == 60 for r in fits)
