"""The whole step's share of the chip's peak: the least time of one GN
iteration's work (the trajectory and the SDF taps of its lookups read once,
the update written once, the solve's and the factors' operations:
``bounds.gn_iter_bound_s``) times the iterations run, over the profiled
calls' wall time.  The count is the same whatever engine or kernel does
the step, so it bounds a kernel's gain after the kernel is fused away; in
the learned plan the encoder's and the head's work is left out of the
count (a lower share, never a higher one)."""
from portbench import bounds

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "GN iteration"
MOVES = "plans_per_s"


def read(ctx):
    t = ctx.trace
    if t is None or not t.iterations or t.window_s <= 0:
        return None
    i = t.info
    least = t.iterations * bounds.gn_iter_bound_s(
        i["batch"], i["steps"], i["state_dim"], i["dtype"])
    return 100.0 * least / t.window_s
