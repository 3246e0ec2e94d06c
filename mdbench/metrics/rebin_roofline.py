"""rebin_roofline: the rebin's least time on the H100 (each atom's x, v and
type read and written once, roofline.py) over the device time per call of
the sim.rebin_fn span."""

from mdbench import roofline


def read(ctx):
    calls = ctx.trace.calls("sim.rebin_fn")
    dev = ctx.trace.device_s(["sim.rebin_fn"])
    if not calls or dev <= 0:
        return None
    return 100.0 * roofline.rebin(ctx.natoms)[0] / (dev / calls)
