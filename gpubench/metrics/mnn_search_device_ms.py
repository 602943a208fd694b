"""Device milliseconds a call launched inside the program's
``fastmnn/mnn_search`` ranges (every merge step's two searches and the
pairs made from them)."""

RANGES = ("fastmnn/mnn_search",)


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    ms = t.device_ms_per_call(RANGES)
    return ms if ms > 0 else None
