"""lj_force_roofline: the LJ force's least time on the H100 (roofline.py:
unordered in-cut pairs and atoms at the traced state) over the device time
per call of the sim.force_fn and sim.force_fn_noev spans."""

from mdbench import roofline

SPANS = ("sim.force_fn", "sim.force_fn_noev")


def read(ctx):
    calls = sum(ctx.trace.calls(s) for s in SPANS)
    dev = ctx.trace.device_s(SPANS)
    if ctx.style != "lj" or not calls or dev <= 0:
        return None
    return 100.0 * roofline.lj_force(ctx.natoms, ctx.pairs)[0] / (dev / calls)
