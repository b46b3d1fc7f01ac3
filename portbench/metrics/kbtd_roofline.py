"""K-BTD's share of its roofline: the least time of the block-tridiagonal
systems its launches solved (B systems of T + 1 blocks of D a launch,
counted from the shapes: ``bounds.btd_bound_s``) over the device time of
the kernels named ``btd_solve_kernel*``."""
from portbench import bounds

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"
MOVES = "plans_per_s"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    n, us = t.device_us("btd_solve_kernel")
    if not n or us <= 0:
        return None
    i = t.info
    least = n * bounds.btd_bound_s(i["batch"], i["steps"] + 1,
                                   i["state_dim"], i["dtype"])
    return 100.0 * least / (us / 1e6)
