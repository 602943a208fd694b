"""Device milliseconds a call launched inside the program's
``fastmnn/cosine_norm`` and ``fastmnn/pca`` ranges."""

RANGES = ("fastmnn/cosine_norm", "fastmnn/pca")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    ms = t.device_ms_per_call(RANGES)
    return ms if ms > 0 else None
