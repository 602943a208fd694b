"""Device milliseconds a call launched inside the program's
``fastmnn/orthogonalize`` and ``fastmnn/correct`` ranges (the replayed
batch vectors, the centring and the tricube search and correction)."""

RANGES = ("fastmnn/orthogonalize", "fastmnn/correct")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    ms = t.device_ms_per_call(RANGES)
    return ms if ms > 0 else None
