"""The MNN searches' least time (``gpubench/work.py``: brute-force score
work from the batch sizes, at the card's bf16 peak, or its bytes at the
HBM bandwidth where those take longer) over the device time a call spends
in ``fastmnn/mnn_search``, in percent. Read beside the card's power limit,
which the result line's ``device`` carries."""

from gpubench import work

RANGES = ("fastmnn/mnn_search",)


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    ms = t.device_ms_per_call(RANGES)
    if ms <= 0:
        return None
    cfg = ctx.config
    least = work.mnn_search_least_seconds(cfg["batches"], int(cfg["d"]), int(cfg["k"]))
    return 100.0 * least / (ms / 1e3)
