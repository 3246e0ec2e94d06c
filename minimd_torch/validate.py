"""Golden-trace statistical comparator.

Python port of the reference's acceptance test (ref/run_one_test:98-138):
chaotic MD trajectories can't be compared bitwise, so per-step |Δ| of T/U/P
is tested against sigma/sqrt(N) envelopes that widen over time with an
arctan ramp; the run passes if <=38% of samples exceed the envelope.
A copy of minimd_tpu.validate.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib
import re


@dataclasses.dataclass
class GoldenLog:
    natoms: int
    nbins: tuple[int, int, int]
    size: tuple[int, int, int]
    rows: list[tuple[int, float, float, float]]  # (step, T, U, P)


def parse_golden(path: str | pathlib.Path) -> GoldenLog:
    text = pathlib.Path(path).read_text().splitlines()
    natoms = 0
    nbins = (0, 0, 0)
    size = (0, 0, 0)
    rows = []
    in_thermo = False
    for ln in text:
        if ln.startswith("\t# Atoms:"):
            natoms = int(ln.split()[-1])
        elif ln.startswith("\t# Neighbor bins:"):
            nbins = tuple(int(t) for t in ln.split()[-3:])
        elif "System size" in ln:
            m = re.search(r"unit cells: (\d+) (\d+) (\d+)", ln)
            if m:
                size = tuple(int(g) for g in m.groups())
        elif ln.startswith("# Timestep T"):
            in_thermo = True
        elif in_thermo:
            parts = ln.split()
            if len(parts) >= 4 and not ln.startswith("#"):
                rows.append((int(parts[0]), float(parts[1]),
                             float(parts[2]), float(parts[3])))
            else:
                in_thermo = False
    return GoldenLog(natoms=natoms, nbins=nbins, size=size, rows=rows)


@dataclasses.dataclass
class TraceComparison:
    frac_t: float
    frac_e: float
    frac_p: float
    nsteps: int
    passed: bool

    def __str__(self):
        verdict = "PASSED" if self.passed else "FAILED"
        return (f"{verdict} (T: {self.frac_t:.3f}; E: {self.frac_e:.3f}; "
                f"P: {self.frac_p:.3f}; expected each ~<=0.38 of {self.nsteps})")


def compare_traces(
    test_rows,
    ref_rows,
    natoms: int,
    system: str = "lj",
    precision: int = 8,
) -> TraceComparison:
    """Apply the run_one_test acceptance criterion (ref/run_one_test:121-138).

    test_rows/ref_rows: sequences of (step, T, U, P) at matching steps.
    system: 'lj' (prefactors 0.4/0.575/3, ramp d=175) or 'eam'
    (13/1300/300, d=1000) — run_one_test:111-128.
    precision: sizeof(float) of the *test* run (widens the ramp for f32).
    """
    if system == "lj":
        pref = (0.4, 0.575, 3.0)
        d = 175.0
        add = (1e-5, 1e-5, 1e-5)
    else:
        pref = (13.0, 1300.0, 300.0)
        d = 1000.0
        add = (2e-3, 1.0, 0.3)

    sd = [p / math.sqrt(natoms) for p in pref]
    fails = [0, 0, 0]
    total = 0
    by_step = {r[0]: r for r in ref_rows}
    for row in test_rows:
        step = row[0]
        if step not in by_step:
            continue
        ref = by_step[step]
        x = math.sqrt(2.0) * (0.5 + math.atan2(step - d * precision, 50.0) / math.pi)
        for q in range(3):
            dv = abs(row[q + 1] - ref[q + 1])
            if dv > sd[q] * x + add[q]:
                fails[q] += 1
        total += 1

    passed = sum(fails) <= 3 * 0.38 * total
    return TraceComparison(
        frac_t=fails[0] / total, frac_e=fails[1] / total,
        frac_p=fails[2] / total, nsteps=total, passed=passed,
    )
