"""Idle milliseconds a call in device gaps (of at least 10 us) that began
while the innermost of the program's ``fastmnn/`` ranges open was
``fastmnn/call`` or ``fastmnn/step``: the card waiting on the entry's own
glue between its layers (the host's share of each merge step outside the
orthogonalisation, search and correction, and the call's input checks and
output reorder), not on the harness between calls.

It sums the trace's idle gaps (``Trace.gaps``, labelled
``"<range>: <host event>"``) whose range is one of those two; a program
that opens neither range gives no such label and no reading."""

RANGES = ("fastmnn/call", "fastmnn/step")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    s = sum(v for label, v in t.gaps.items() if label.split(": ", 1)[0] in RANGES)
    return s * 1e3 / t.calls if s > 0 else None
