"""The comparison that decides `correct`: what the program produced in the
window, against the plain reference (reference.py) computed afresh from
the run's inputs and from the program's final state.

The numbers compared, each against its limit in the cell's workload file:

- lost, misplaced, regrown (exact, limit 0): the layout the window ends
  with holds every atom once, by type, each in the cell its position maps
  to, and the grid and capacity are those of the set-up (no overflow
  regrew them).
- force_gap: the widest gap of an atom's force from the reference's at the
  final positions, over the root mean square of the reference's forces. A
  pair whose r^2 lies within reference.BORDER of the cutoff may count on
  either side.
- T_gap, U_gap, P_gap: the last thermo row of the window (the final state)
  against the reference's row at the same state; T and U relative, P over
  the ideal-gas pressure at the reference's T.
- U0_gap, P0_gap: the same for the step-0 row against the reference's
  row of the run's inputs: the start, which the final state cannot show.
  (Its T is the inputs' own, rescaled to the configuration's temperature
  before either side sees them, so it is not compared: the control
  reads 0 there on some seeds.)
- x_gap, v_gap: two more steps of the program's own run() from the final
  state against the reference's two velocity-Verlet steps from it: the
  widest gap of a position over 2 dt rms|v|, of a velocity over
  2 dtf rms|F| (each pair at the cutoff of the three forces on either
  side). MD is chaotic, so the reference cannot follow the window itself;
  it follows the program one step at a time from its own state.

The control is the reference computed in bfloat16 (the step below the
configuration's float32), judged by the same numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import reference
from .reference import F64

MEASURED = ("force_gap", "T_gap", "U_gap", "P_gap", "U0_gap", "P0_gap",
            "x_gap", "v_gap")


def _atoms(a, valid, device):
    """(N, 3) float64 rows of a (3, M) slot array's valid slots."""
    return torch.as_tensor(np.ascontiguousarray(a[:, valid].T),
                           dtype=F64, device=device)


def widest(res: torch.Tensor, atoms, dfs) -> float:
    """max over atoms of |res| (N, 3), where an atom listed in `atoms` may
    first take away any subset of its `dfs` (a pair at a cutoff on the
    other side; at most the first 12 of an atom's)."""
    gap = res.norm(dim=1)
    if atoms is not None and atoms.numel():
        order = torch.argsort(atoms, stable=True)
        atoms, dfs = atoms[order], dfs[order]
        uniq, counts = torch.unique_consecutive(atoms, return_counts=True)
        first = torch.cumsum(counts, 0) - counts
        grp = torch.repeat_interleave(
            torch.arange(len(uniq), device=atoms.device), counts)
        rank = torch.arange(len(atoms), device=atoms.device) - first[grp]
        k = min(int(counts.max()), 12)
        keep = rank < k
        C = torch.zeros((len(uniq), k, 3), dtype=F64, device=atoms.device)
        C[grp[keep], rank[keep]] = dfs[keep]
        bits = torch.arange(1 << k, device=atoms.device)
        subsets = ((bits[:, None] >> torch.arange(k, device=atoms.device))
                   & 1).to(F64)                                  # (S, k)
        alt = res[uniq][:, None, :] - torch.einsum("sk,akd->asd", subsets, C)
        gap[uniq] = alt.norm(dim=-1).min(dim=1).values
    return float(gap.max())


def force_gap(f: torch.Tensor, ref: reference.Forces) -> float:
    """max over atoms |f - f_ref| (each pair at the cutoff on either
    side) over rms |f_ref|."""
    fr = ref.f.to(F64)
    rms = math.sqrt(float((fr * fr).sum(dim=1).mean()))
    return widest(f.to(F64) - fr, ref.border_atom, ref.border_df) / rms


def _row_gaps(row, ref_row, model, prefix=""):
    t, u, p = (float(r) for r in row)
    tr, ur, pr = ref_row
    got = {f"U{prefix}_gap": abs(u - ur) / abs(ur),
           f"P{prefix}_gap": abs(p - pr) / model.ideal_pressure(tr)}
    if not prefix:
        got["T_gap"] = abs(t - tr) / tr
    return got


class Truth:
    """The reference's side, worked out once from the run's inputs and
    the program's final state (x0, v0: (N, 3) float64 on `device`)."""

    def __init__(self, model: reference.Model, inputs, x0, v0):
        dev = x0.device
        self.model = model
        xi = torch.as_tensor(inputs.x, dtype=F64, device=dev)
        vi = torch.as_tensor(inputs.v, dtype=F64, device=dev)
        self.xi, self.vi, self.x0, self.v0 = xi, vi, x0, v0
        self.row0 = model.row(vi, model.forces(xi))
        self.forces = model.forces(x0)
        self.row = model.row(v0, self.forces)
        self.x2, self.v2, self.vcorr = model.two_steps(x0, v0,
                                                       f0=self.forces)
        self.vrms = math.sqrt(float((v0 * v0).sum(dim=1).mean()))
        self.frms = math.sqrt(float((self.forces.f * self.forces.f)
                                    .sum(dim=1).mean()))

    def judge(self, out: dict) -> dict:
        """The measured numbers of outputs `out`: row0, row (T, U, P), f,
        x2, v2 ((N, 3) tensors in the truth's atom order)."""
        m = self.model
        got = {"force_gap": force_gap(out["f"], self.forces)}
        got.update(_row_gaps(out["row"], self.row, m))
        got.update(_row_gaps(out["row0"], self.row0, m, "0"))
        dx = (out["x2"].to(F64) - self.x2).norm(dim=1).max()
        dv = widest(out["v2"].to(F64) - self.v2, *self.vcorr)
        got["x_gap"] = float(dx) / (2 * m.dt * self.vrms)
        got["v_gap"] = dv / (2 * m.dtf * self.frms)
        return {k: got[k] for k in MEASURED}

    def control(self, dtype=torch.bfloat16) -> dict:
        """The control's outputs: the reference itself in `dtype`."""
        m = self.model
        f0 = m.forces(self.x0, dtype)
        x2, v2, _ = m.two_steps(self.x0, self.v0, dtype, f0=f0)
        return {"row0": m.row(self.vi, m.forces(self.xi, dtype), dtype),
                "row": m.row(self.v0, f0, dtype), "f": f0.f,
                "x2": x2, "v2": v2}


def evaluate(model, inputs, ntypes, run, device, control=False):
    """(numbers, control numbers or None, unordered in-cut pairs at the
    final state) of a run. `run` holds the program's outputs: row0, row,
    final (x, v, f, typ (3, M) / (M,) numpy, nb, capacity, prd, offset),
    after2 (x, v), layout0 and layout (grid, capacity) and overflow."""
    fin, aft = run["final"], run["after2"]
    lost, misplaced = reference.audit_layout(
        fin["x"], fin["typ"], fin["nb"], fin["capacity"], fin["prd"],
        fin["offset"], inputs.natoms, inputs.type_counts(ntypes))
    numbers = {"lost": lost + int(run["overflow"]), "misplaced": misplaced,
               "regrown": int(run["layout"] != run["layout0"])}
    valid = fin["x"][0] < reference.VALID_BELOW
    finite = all(np.isfinite(a[:, valid]).all() for a in
                 (fin["x"], fin["v"], fin["f"], aft["x"], aft["v"]))
    if not finite or misplaced or lost:
        # no state the reference can follow: every gap fails
        numbers.update({k: math.nan for k in MEASURED})
        return numbers, None, 0
    x0, v0 = _atoms(fin["x"], valid, device), _atoms(fin["v"], valid, device)
    truth = Truth(model, inputs, x0, v0)
    out = {"row0": run["row0"], "row": run["row"],
           "f": _atoms(fin["f"], valid, device),
           "x2": _atoms(aft["x"], valid, device),
           "v2": _atoms(aft["v"], valid, device)}
    numbers.update(truth.judge(out))
    ctrl = truth.judge(truth.control()) if control else None
    return numbers, ctrl, truth.forces.pairs


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (NaN fails)."""
    return all(numbers[k] <= limits[k] for k in numbers)
