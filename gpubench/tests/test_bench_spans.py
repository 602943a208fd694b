"""The program's outer ranges (``fastmnn/call``, ``fastmnn/step``) and its
inner spans named without the ``fastmnn/`` prefix, on a hand-made Chrome
trace: the accepted readings stay as they were, and
``between_layers_idle_ms`` reads the idle that the outer ranges now own."""
import json

import pytest

from gpubench import harness, run
from gpubench.trace import read_chrome_trace


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


# A call as the parent's program traces it, and the same call with the
# outer ranges and the inner spans (pca/gram, pca/eigh, knn/two_pass,
# correction/tricube_search) around the same launches.
_CALL = [
    _x("ProfilerStep#1", "user_annotation", 0, 2000),
    _x("fastmnn/pca", "user_annotation", 100, 400),
    _x("fastmnn/mnn_search", "user_annotation", 600, 400),
    _x("fastmnn/correct", "user_annotation", 1100, 400),
    _x("cudaLaunchKernel", "cuda_runtime", 120, 5, correlation=1),
    _x("cudaLaunchKernel", "cuda_runtime", 300, 5, correlation=2),
    _x("cudaLaunchKernel", "cuda_runtime", 620, 5, correlation=3),
    _x("cudaLaunchKernel", "cuda_runtime", 900, 5, correlation=4),
    _x("cudaLaunchKernel", "cuda_runtime", 1050, 5, correlation=7),
    _x("cudaLaunchKernel", "cuda_runtime", 1150, 5, correlation=5),
    _x("cudaLaunchKernel", "cuda_runtime", 1400, 5, correlation=6),
    _x("aten::nonzero", "cpu_op", 1600, 100),
    _x("gemm", "kernel", 150, 200, correlation=1),
    _x("eigh", "kernel", 400, 100, correlation=2),
    _x("chunk_max", "kernel", 700, 60, correlation=3),
    _x("topk", "kernel", 950, 30, correlation=4),
    _x("cat", "kernel", 1060, 30, correlation=7),
    _x("tricube_gemm", "kernel", 1200, 100, correlation=5),
    _x("add", "kernel", 1420, 20, correlation=6),
    _x("Memcpy DtoH", "gpu_memcpy", 1800, 4, correlation=99),
]
_SPANS = [
    _x("fastmnn/call", "user_annotation", 50, 1850),
    _x("fastmnn/step", "user_annotation", 550, 1000),
    _x("pca/gram", "user_annotation", 110, 90),
    _x("pca/eigh", "user_annotation", 250, 200),
    _x("knn/two_pass", "user_annotation", 610, 340),
    _x("correction/tricube_search", "user_annotation", 1140, 60),
]
_ACCEPTED = ("device_idle_pct", "launches_per_call", "pca_device_ms", "mnn_search_device_ms",
             "mnn_search_roofline", "correct_device_ms")


def _read(tmp_path, events, name):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return read_chrome_trace(str(path), calls=2)


def _ctx(trace):
    return run._Ctx(harness.load_cell("hca_bone_marrow.fast_mnn_auto"), trace)


def test_spans_leave_the_accepted_readings_as_they_were(tmp_path):
    old = _read(tmp_path, _CALL, "old.json")
    new = _read(tmp_path, _CALL + _SPANS, "new.json")
    assert [op[:4] for op in new.ops] == [op[:4] for op in old.ops]
    assert new.busy_s == old.busy_s and new.wall_s == old.wall_s
    for name in _ACCEPTED:
        reader = harness.metric_reader(name)
        assert reader(_ctx(new)) == reader(_ctx(old)) is not None, name
    # the outer ranges take only what no range held: the launch at 1050
    moved = [(o[0], o[4], n[4]) for o, n in zip(old.ops, new.ops) if o[4] != n[4]]
    assert moved == [("cat", None, "fastmnn/step")]
    # idle moves between labels and is not added
    assert sum(new.gaps.values()) == pytest.approx(sum(old.gaps.values()))


def test_between_layers_idle_reads_the_outer_ranges_gaps(tmp_path):
    old = _read(tmp_path, _CALL, "old.json")
    new = _read(tmp_path, _CALL + _SPANS, "new.json")
    reader = harness.metric_reader("between_layers_idle_ms")
    # gaps from 500 (the call's, after the PCA), 1090 (the step's, between
    # search and correction) and 1804 (the call's, after the last op)
    assert reader(_ctx(new)) == pytest.approx((200 + 110 + 196) / 1e3 / 2)
    outside = "outside the program's ranges: no host event"
    assert old.gaps[outside] - new.gaps[outside] == pytest.approx((200 + 110 + 196) / 1e6)
    # the parent's program opens neither range: no reading
    assert reader(_ctx(old)) is None
    assert reader(_ctx(None)) is None
