"""The JAX package's pipelines run on the port's trend fit.

The port's ``fit_trend_var`` leaves its smoothed log-ratio unfloored, as
scran's fitTrendVar does; the JAX package floors it at 0, which holds every
trend above its parametric curve. A test that compares something
downstream of the trend (a variance model, HVGs, a delta variance, a
quickCorrect) runs the JAX package inside ``port_trend_in_jax()``, so that
it compares the rest of the pipeline; the trend itself is held to the JAX
package's curve and smoother in
``test_torch_diagnostics.py::test_fit_trend_var_is_the_jax_code``.
"""
import contextlib
from unittest import mock


@contextlib.contextmanager
def port_trend_in_jax():
    import batchelor_tpu.correct.diagnostics as jd
    import batchelor_tpu.correct.outofcore as jo
    import batchelor_tpu.ops.stats as js
    from batchelor_torch.correct.diagnostics import fit_trend_var

    with mock.patch.object(jd, "fit_trend_var", fit_trend_var), \
            mock.patch.object(js, "fit_trend_var", fit_trend_var), \
            mock.patch.object(jo, "fit_trend_var", fit_trend_var):
        yield
