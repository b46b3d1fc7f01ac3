"""From the process's start to the window's: imports, CUDA, the kernel
library (built on a checkout's first run), the pool, the weights and the
warm-up calls."""
UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(ctx):
    return ctx.setup_s
