"""Problems whose plan completed in the window, over the window: from the
first call's start to the last call's end, on the host's clock."""
UNIT, BETTER, SOURCE = "plans/s", "higher", "host_clock"


def read(ctx):
    if not ctx.records or ctx.window_s <= 0:
        return None
    return sum(r.idx.numel() for r in ctx.records) / ctx.window_s
