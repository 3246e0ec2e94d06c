"""Phase timers (the reference's Timer, ref/timer.h:35-64), a copy of
minimd_tpu.timer. TOTAL is wall-clock around the run; Simulation.run_timed
fills FORCE (the plain steps and each force-and-kick) and NEIGH (the
rebins), synchronizing the card at every stamp. COMM stays 0 on one
device.
"""

from __future__ import annotations

import time

TIME_TOTAL = 0
TIME_COMM = 1
TIME_FORCE = 2
TIME_NEIGH = 3
TIME_TEST = 4


class Timer:
    def __init__(self):
        self.array = [0.0] * 5
        self._mark = None

    def stamp(self, which: int | None = None):
        now = time.time()
        if which is not None and self._mark is not None:
            self.array[which] += now - self._mark
        self._mark = now

    def barrier_start(self, which: int):
        self._start = time.time()

    def barrier_stop(self, which: int):
        self.array[which] += time.time() - self._start
