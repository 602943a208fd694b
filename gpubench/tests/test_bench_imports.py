"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level module names are
compared whole: ``batchelor_torch`` begins with the JAX package's name."""
import subprocess
import sys

from gpubench import harness

BANNED = {"jax", "jaxlib", "flax", "batchelor_tpu"}


def _top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                         cwd=harness.ROOT, capture_output=True, text=True, check=True, timeout=300)
    return {m.split(".")[0] for m in out.stdout.split()}


def test_harness_loads_no_jax():
    metrics = "; ".join(f"harness.metric_reader({m!r})" for m in
                        ("device_idle_pct", "launches_per_call", "pca_device_ms",
                         "mnn_search_device_ms", "mnn_search_roofline", "correct_device_ms",
                         "collective_device_ms", "driver_step_device_ms"))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import batchelor_torch\n"
            "from gpubench import run, readings, harness, faults, trace, work, compare, generator, ranks\n"
            "for e in ('fast_mnn', 'reduced_mnn', 'distributed_fast_mnn'): harness.entry_module(e)\n"
            + metrics)
    loaded = _top_level_after(code)
    assert "batchelor_torch" in loaded
    assert not loaded & BANNED


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level_after("import sys; sys.path.insert(0, '.')\n"
                              "from gpubench import reference, compare, generator")
    assert "batchelor_torch" not in loaded
    assert not loaded & BANNED
