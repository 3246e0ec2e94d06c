"""device.idle_pct: the share of the traced window in which a device ran
nothing (wall minus the union of its activities), mean over the cell's
devices."""


def read(ctx):
    w = ctx.trace.window_s
    busy = [ctx.trace.busy_s(d) for d in ctx.devices]
    if w <= 0 or not any(busy):
        return None
    return 100.0 * sum(1.0 - b / w for b in busy) / len(busy)
