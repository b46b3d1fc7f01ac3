"""Device time of the kernels launched inside the encoder's forward
(``models.conv_encoder``; a host range the harness opens from hooks on the
planner's ``variables["conv"]``), per profiled call."""
from portbench import trace as trace_lib

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "encoder"
MOVES = "plans_per_s"


def read(ctx):
    t = ctx.trace
    if t is None or not t.range_counts.get(trace_lib.ENCODER):
        return None
    us = t.ranges[trace_lib.ENCODER]
    return us / 1e3 / t.calls if us > 0 else None
