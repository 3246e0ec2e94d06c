"""setup.eam_tables_s: host-clock seconds of the program's
minimd.setup.tables part for EAM (the funcfl read, its splines and the
pair polynomials' fit), from the set-up record the program keeps of its
latest construction in this process (minimd_torch.timer.last_setup);
None where it keeps none."""

import sys


def read(ctx):
    timer = sys.modules.get("minimd_torch.timer")
    rec = getattr(timer, "last_setup", None) or {}
    return rec.get("tables") if ctx.style == "eam" else None
