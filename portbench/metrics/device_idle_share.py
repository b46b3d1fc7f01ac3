"""Share of the profiled calls' wall time in which no operation ran on the
device: 100 (1 - union of device operations / wall time)."""
UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "plans_per_s"


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
