"""setup.geometry_s: host-clock seconds of the program's
minimd.setup.geometry part (cells.build_geometry with its grid autotune),
from the set-up record the program keeps of its latest construction in
this process (minimd_torch.timer.last_setup); None where it keeps none."""

import sys


def read(ctx):
    timer = sys.modules.get("minimd_torch.timer")
    return (getattr(timer, "last_setup", None) or {}).get("geometry")
