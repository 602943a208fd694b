"""Share of the traced calls' wall time in which no operation ran on the
device: 100 * (1 - busy / wall), busy being the union of the device
operations' intervals and wall the span of the calls' profiler steps
(``gpubench/trace.py``), which leaves the profiler's shutdown out."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops or t.wall_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
