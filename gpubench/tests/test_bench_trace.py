"""The trace reduction on a hand-made Chrome trace: attribution by the
launch's correlation id, busy as a union, idle gaps by the host's work."""
import json

import pytest

from gpubench.trace import read_chrome_trace


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def test_attribution_union_and_gaps(tmp_path):
    ev = [
        _x("ProfilerStep#1", "user_annotation", 0, 1000),
        _x("fastmnn/pca", "user_annotation", 10, 200),
        _x("fastmnn/mnn_search", "user_annotation", 300, 400),
        _x("cudaLaunchKernel", "cuda_runtime", 20, 5, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 30, 5, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 310, 5, correlation=3),
        _x("aten::nonzero", "cpu_op", 500, 300),
        _x("gemm", "kernel", 100, 100, correlation=1),
        _x("eigh", "kernel", 150, 150, correlation=2),      # overlaps gemm
        _x("topk", "kernel", 400, 50, correlation=3),
        _x("Memcpy DtoH", "gpu_memcpy", 520, 4, correlation=99),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = read_chrome_trace(str(path), calls=2)
    assert tr.busy_s == pytest.approx((200 + 50 + 4) / 1e6)
    assert tr.wall_s == pytest.approx(1000 / 1e6)        # the steps' span
    assert tr.launches_per_call() == 1.5
    assert tr.device_ms_per_call(("fastmnn/pca",)) == pytest.approx(250 / 1e3 / 2)
    assert tr.device_ms_per_call(("fastmnn/mnn_search",)) == pytest.approx(50 / 1e3 / 2)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["eigh", pytest.approx(150e-6)]
    gaps = dict(b["idle_gaps"])
    # 300 -> 400 and 450 -> 520: inside the search's range, no op open
    assert gaps["fastmnn/mnn_search: fastmnn/mnn_search"] == pytest.approx(170e-6)
    assert gaps["fastmnn/mnn_search: aten::nonzero"] == pytest.approx(476e-6)   # 524 -> 1000
    assert gaps["outside the program's ranges: no host event"] == pytest.approx(100e-6)  # 0 -> 100
    assert sum(gaps.values()) == pytest.approx((1000 - 254) / 1e6)


def test_driver_ranges_and_collectives_on_rank_0(tmp_path):
    """The distributed driver's ranges are read beside fastMNN's; NCCL's
    kernels are read by name; the fastMNN layers' readers find nothing."""
    from gpubench import harness, run

    ev = [
        _x("ProfilerStep#1", "user_annotation", 0, 1000),
        _x("driver/step", "user_annotation", 10, 600),
        _x("driver/pairs", "user_annotation", 650, 150),
        _x("knn/exact", "user_annotation", 15, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 20, 5, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 300, 5, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 700, 5, correlation=3),
        _x("knn_exact_kernel", "kernel", 100, 200, correlation=1),
        _x("ncclDevKernel_AllGather_RING_LL", "kernel", 350, 100, correlation=2),
        _x("ncclDevKernel_AllGather_RING_LL", "kernel", 720, 40, correlation=3),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = read_chrome_trace(str(path), calls=2)
    ctx = run._Ctx(harness.load_cell("tenx_brain_1_3m.distributed_exact"), tr)
    read = lambda name: harness.metric_reader(name)(ctx)  # noqa: E731
    assert read("collective_device_ms") == pytest.approx((100 + 40) / 1e3 / 2)
    assert read("driver_step_device_ms") == pytest.approx((200 + 100) / 1e3 / 2)
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 340 / 1000))
    assert read("launches_per_call") == pytest.approx(3 / 2)
    for name in ("mnn_search_device_ms", "correct_device_ms", "between_layers_idle_ms"):
        assert read(name) is None, name
