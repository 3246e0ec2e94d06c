"""sim.launches_per_step: the kernels, memcpys and memsets the devices ran
in the traced window, per step. A count: it repeats exactly."""


def read(ctx):
    n = ctx.trace.count()
    return n / ctx.steps if n and ctx.steps else None
