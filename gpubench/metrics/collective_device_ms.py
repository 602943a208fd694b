"""Device milliseconds a call of NCCL's kernels (names starting ``nccl``)
on rank 0's card: the all-gathers, all-reduces and the pair gather of the
distributed driver. A collective's kernel runs until its peers' data has
come, so this holds the wait for the slowest rank as well as the
transfer."""

PREFIX = "nccl"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    us = sum(op[3] for op in t.ops if op[1] == "kernel" and op[0].startswith(PREFIX))
    return us / 1e3 / t.calls if us > 0 else None
