"""sim.edge_idle_ms_per_run: the ms a device ran nothing outside every
minimd.interval span (each run()'s start and end: its state's copy, the
host copy of its rows, the harness between calls), mean over the cell's
devices, per minimd.run span. device.idle_pct less sim.loop_idle_pct, so
sim.loop_idle_pct + this x calls / window = device.idle_pct."""

from mdbench import spec


def read(ctx):
    runs = ctx.trace.calls("minimd.run")
    total = spec.reader("device.idle_pct")(ctx)
    loop = spec.reader("sim.loop_idle_pct")(ctx)
    if not runs or total is None or loop is None:
        return None
    return (total - loop) / 100.0 * ctx.trace.window_s * 1e3 / runs
