"""sim.loop_idle_pct: the share of the traced window in which a device ran
nothing while the host was inside one of the program's minimd.interval
spans (a reneighbor interval of run(): the host issuing steps), mean over
the cell's devices: each idle stretch of device.idle_pct cut to the
union of those spans."""

from mdbench.trace import _union


def read(ctx):
    tr = ctx.trace
    loops = _union([s[:2] for s in tr.spans if s[2] == "minimd.interval"])
    if not loops or tr.window_s <= 0:
        return None
    idle = 0.0
    for d in ctx.devices:
        for g0, g1 in tr.gaps(d):
            for s, e in loops:
                idle += max(0.0, min(g1, e) - max(g0, s))
    return 100.0 * idle * 1e-6 / len(ctx.devices) / tr.window_s
