"""Device milliseconds a call launched inside the distributed driver's
``driver/step`` ranges on rank 0's card (each merge step's searches,
membership test, correction and their collectives; the pair gather is
``driver/pairs``, apart)."""

RANGES = ("driver/step",)


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    ms = t.device_ms_per_call(RANGES)
    return ms if ms > 0 else None
