"""Phase timers (the reference's Timer, ref/timer.h:35-64), a copy of
minimd_tpu.timer. TOTAL is wall-clock around the run; Simulation.run_timed
fills FORCE (the plain steps and each force-and-kick) and NEIGH (the
rebins), synchronizing the card at every stamp. COMM stays 0 on one
device.

The program's spans: `spans()` picks, once per run() or construction, the
helper that opens them. While a torch profiler records, that is `span`, a
range named minimd.<layer> on the profiler's clock (the clock of the
device's activities in the same trace); else `no_span`, whose range is
one shared null context: no range is entered, no clock read, nothing
synchronized. `SetupClock` times set-up's parts on the host clock whether
or not a profiler records; `keep_setup` leaves each construction's record
as `last_setup` too, for a caller that holds no reference to the
simulation (a benchmark's reader of the record).
"""

from __future__ import annotations

import contextlib
import time

import torch

TIME_TOTAL = 0
TIME_COMM = 1
TIME_FORCE = 2
TIME_NEIGH = 3
TIME_TEST = 4

_NULL = contextlib.nullcontext()

# the set-up record of the latest construction in this process
last_setup: dict = {}


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


def recording() -> bool:
    """Whether a torch profiler is recording (torch.profiler.profile or
    torch.autograd.profiler.profile, between its start and its stop)."""
    return torch.autograd._profiler_enabled()


class _Range:
    """The user-scope record function that torch.profiler.record_function
    opens (a user_annotation in the profiler's trace), entered through its
    C binding: a third of record_function's host time a range, which goes
    through the operator dispatcher on entry and exit."""

    __slots__ = ("name", "_handle")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._handle = torch._C._autograd._record_function_with_args_enter(
            self.name)

    def __exit__(self, *exc):
        torch._C._autograd._record_function_with_args_exit(self._handle)


def span(name: str):
    """A profiler range named `name`."""
    return _Range(name)


def no_span(name: str):
    """The shared null context, for a span while no profiler records."""
    return _NULL


def spans():
    """The span helper for one run() or construction: `span` while a
    profiler records, else `no_span`."""
    return span if recording() else no_span


class SetupClock:
    """Host-clock seconds of set-up's parts, by name, in `record` (a part
    entered twice adds up); each part is also the range
    minimd.setup.<name> while a profiler records."""

    def __init__(self):
        self.record = {}
        self._span = spans()

    @contextlib.contextmanager
    def part(self, name: str):
        t0 = time.perf_counter()
        with self._span(f"minimd.setup.{name}"):
            yield
        self.record[name] = (self.record.get(name, 0.0)
                             + time.perf_counter() - t0)


def keep_setup(record: dict) -> dict:
    """Make `record` (a construction's set-up record) the process's
    `last_setup`, and return it."""
    global last_setup
    last_setup = record
    return record
