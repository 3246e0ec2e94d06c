"""sim.kick_us_per_step: device microseconds per step of the activities
whose innermost span is one of the program's minimd.interval spans (the
kicks and drift, which open no span of their own; the harness's spans
take the force and the rebin, minimd.rebin and minimd.thermo the rest)
or minimd.kick (a fused interval's seed), mean over the cell's
devices."""


def read(ctx):
    tr = ctx.trace
    dev = tr.device_s(["minimd.interval", "minimd.kick"])
    if not tr.calls("minimd.interval") or dev <= 0 or not ctx.steps:
        return None
    return dev * 1e6 / len(ctx.devices) / ctx.steps
