"""Device kernels launched a call (memory copies and sets not counted)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops:
        return None
    return t.launches_per_call()
