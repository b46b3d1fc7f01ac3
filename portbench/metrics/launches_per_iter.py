"""Device kernels launched in the profiled calls per GN iteration they ran:
the host loop's launches (``core.gn.plan``; the learned loop of
``learn.learned_planner``), the per-call work spread over the iterations."""
UNIT, BETTER, SOURCE = "launches", "lower", "device_trace"
LAYER = "host loop"
MOVES = "plans_per_s"


def read(ctx):
    t = ctx.trace
    if t is None or not t.iterations or not t.kernels:
        return None
    return len(t.kernels) / t.iterations
