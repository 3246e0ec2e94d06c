"""eam_force_roofline: the EAM force's least time on the H100 (roofline.py:
density pass, embedding and force pass on the unordered in-cut pairs and
atoms at the traced state) over the device time per call of the
sim.force_fn and sim.force_fn_noev spans (every kernel they launch)."""

from mdbench import roofline

SPANS = ("sim.force_fn", "sim.force_fn_noev")


def read(ctx):
    calls = sum(ctx.trace.calls(s) for s in SPANS)
    dev = ctx.trace.device_s(SPANS)
    if ctx.style != "eam" or not calls or dev <= 0:
        return None
    return 100.0 * roofline.eam_force(ctx.natoms, ctx.pairs)[0] / (dev / calls)
