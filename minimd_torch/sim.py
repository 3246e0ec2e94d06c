"""Simulation orchestrator: setup, cells, forces and thermo wired into the
velocity-Verlet loop (the reference's Integrate::run + main setup
sequence, ref/integrate.cpp:70-207 / ref/ljs.cpp:385-468), LJ and EAM.

`run()` is a Python loop over steps that launches work on the device and
never waits for it: the thermo trace and the rebin overflow counts stay
in a device tensor until the one host sync at the end of the run.

The device decides the path. On CUDA: the LJ kernel (ops/lj_cuda.py) or
the two EAM kernels (ops/eam_cuda.py) and, when every axis has at least 3
cells, the pull rebin kernel (ops/rebin_cuda.py); smaller grids use the
sort-based rebin_lean, the JAX package's own geometry rule. On the CPU:
the plain LJ version (ops/lj_grid.py), the exact-spline EAM force
(ops/eam.py, what the JAX package runs on its CPU) and cells.rebin_local /
rebin_lean, in any dtype.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import cells, create, thermo
from .config import FORCE_EAM, FORCE_LJ, UNITS_METAL, In
from .ops.eam import EAMTables
from .ops.lj import LJParams
from .ops.pairgrid import halo_extent
from .state import MDState, init_state
from .units import ThermoScales, thermo_scales


def _not_yet(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to minimd_torch yet (ROADMAP {item})")


@dataclasses.dataclass
class Simulation:
    inp: In
    geom: cells.CellGeometry
    state: MDState
    scales: ThermoScales
    natoms: int
    mass: float
    dtforce: float            # 0.5*dt / mvv2e / mass (integrate.cpp:43,81)
    dtype: torch.dtype
    device: torch.device
    params: LJParams | None        # LJ decks
    tables: EAMTables | None       # EAM decks
    force_fn: object = None        # (x, typ) -> (f, eng, virial), evflag on
    force_fn_noev: object = None   # same with eng = virial = 0
    rebin_fn: object = None        # (x, v, typ) -> (x, v, typ, overflow)
    eng_vdwl: torch.Tensor | None = None
    virial: torch.Tensor | None = None
    # user-pinned geometry (None = autotuned; overflow recovery may then
    # re-grid from live occupancy, see _regrow) + regrow counter
    _user_nbins: object = None
    _user_capacity: object = None
    _regrows: int = 0
    _row0: tuple | None = None

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @staticmethod
    def from_input(inp: In, *, ntypes: int = 4, dtype=torch.float32,
                   device="cuda", nbins=None, capacity: int | None = None,
                   potential_path: str | None = None,
                   half_neigh: bool = False,
                   fused_step: bool = False) -> "Simulation":
        _refuse_unported(half_neigh, fused_step)
        prd, x_np, v_np, typ_np, mass = create.setup_system(
            inp, ntypes, potential_path)
        return Simulation.from_arrays(
            inp, prd, x_np, v_np, typ_np, mass, ntypes=ntypes, dtype=dtype,
            device=device, nbins=nbins, capacity=capacity,
            potential_path=potential_path)

    @staticmethod
    def from_arrays(inp: In, prd, x_np, v_np, typ_np, mass: float, *,
                    ntypes: int | None = None, dtype=torch.float32,
                    device="cuda", nbins=None, capacity: int | None = None,
                    potential_path: str | None = None,
                    half_neigh: bool = False,
                    fused_step: bool = False) -> "Simulation":
        """Build a Simulation from explicit, final state arrays (from_input
        reduces to this after setup). Velocities are taken as they are."""
        _refuse_unported(half_neigh, fused_step)
        # The shipped EAM decks are solid Cu (600 K start, cooling): vouch
        # crystallinity so commensurate grids get lattice-tight capacity
        # (cells.pick_capacity), as the JAX package does. Wrong vouches
        # fail loudly via the rebin overflow counter.
        solid = inp.forcetype == FORCE_EAM and inp.datafile is None
        geom = cells.build_geometry(prd, inp.neigh_cut, x_np, nbins=nbins,
                                    capacity=capacity, solid=solid)
        state = init_state(x_np, v_np, typ_np, geom, dtype=dtype,
                           device=device)
        sim = Simulation.from_state(
            inp, geom, state, mass, ntypes=ntypes, dtype=dtype, device=device,
            potential_path=potential_path)
        sim._user_nbins, sim._user_capacity = nbins, capacity
        return sim

    @staticmethod
    def from_state(inp: In, geom: cells.CellGeometry, state: MDState,
                   mass: float, *, ntypes: int | None = None,
                   dtype=torch.float32, device="cuda",
                   potential_path: str | None = None) -> "Simulation":
        """Build a Simulation on a state already laid out in `geom`, e.g. one
        carried across from the JAX package (state.state_from_reference,
        state.geometry_from_reference). Forces are recomputed; the EAM
        mass is the potential file's."""
        device = torch.device(device)
        valid = state.valid.cpu().numpy()
        # atoms a capacity overflow dropped still count (grow-and-replay
        # restores them)
        natoms = int(valid.sum()) + state.overflow
        if ntypes is None:
            typ = state.typ.cpu().numpy()[valid]
            ntypes = int(typ.max()) + 1 if natoms else 1
        params = tables = None
        if inp.forcetype == FORCE_LJ:
            params = LJParams.from_deck(ntypes, inp.epsilon, inp.sigma,
                                        inp.force_cut)
        elif inp.forcetype == FORCE_EAM:
            tables = EAMTables.from_funcfl(potential_path)
            mass = tables.mass
        else:
            raise ValueError(f"unknown forcetype {inp.forcetype}")
        scales = thermo_scales(inp.units, natoms,
                               float(np.prod(np.asarray(geom.prd))))
        dtforce = 0.5 * inp.dt
        if inp.units == UNITS_METAL:
            dtforce /= scales.mvv2e
        dtforce /= mass

        sim = Simulation(
            inp=inp, geom=geom, state=state, scales=scales, natoms=natoms,
            mass=mass, dtforce=dtforce, dtype=dtype, device=device,
            params=params, tables=tables)
        sim._set_geometry(geom)
        sim._compute_initial_force()
        return sim

    def _set_geometry(self, geom: cells.CellGeometry):
        """Build the force and rebin closures for a geometry."""
        self.geom = geom
        cuda = self.device.type == "cuda"
        if cuda:
            item = "queue 2 items 1, 3-4" if self.tables else "queue 2 item 1"
            if self.dtype != torch.float32:
                raise _not_yet("a float64 CUDA run", item)
            if halo_extent(geom) != 1:
                raise _not_yet("a CUDA run with binsize < cutneigh (h > 1)",
                               item)
        if self.tables is not None:
            if cuda:
                from .ops.eam_cuda import make_eam_force_cuda
                self.force_fn, self.force_fn_noev = make_eam_force_cuda(
                    geom, self.tables, self.dtype, self.device)
            else:
                from .ops.eam import make_eam_force
                self.force_fn = self.force_fn_noev = make_eam_force(
                    geom, self.tables, self.dtype, self.device)
        else:
            if cuda and not self.params.uniform:
                raise _not_yet("per-type LJ tables on CUDA", "queue 2 item 1")
            if cuda:
                from .ops.lj_cuda import make_lj_force_cuda as make_force
            else:
                from .ops.lj_grid import make_lj_force_grid as make_force
            self.force_fn, self.force_fn_noev = make_force(
                geom, self.params, self.dtype, self.device)
        if min(geom.nb) < 3:
            # the +-1 pull would alias cells: sort-based placement
            self.rebin_fn = functools.partial(cells.rebin_lean, geom=geom)
        elif cuda:
            from .ops.rebin_cuda import make_rebin_cuda
            self.rebin_fn = make_rebin_cuda(geom, self.device)
        else:
            self.rebin_fn = functools.partial(cells.rebin_local, geom=geom)

    def _compute_initial_force(self):
        f, eng, vir = self.force_fn(self.state.x, self.state.typ)
        self.state.f = f
        self.eng_vdwl, self.virial = eng, vir
        self._row0 = self.thermo_row(0)

    def thermo_row(self, step: int) -> tuple[int, float, float, float]:
        t = float(thermo.temperature(self.state.v, self.mass, self.scales))
        u = float(thermo.energy(self.eng_vdwl, self.natoms, self.scales))
        p = float(thermo.pressure(t, self.virial, self.scales))
        return (step, t, u, p)

    # ------------------------------------------------------------------
    def run(self, ntimes: int | None = None) -> np.ndarray:
        """Run ntimes velocity-Verlet steps; returns the (ntimes, 3)
        [T, U, P] trace, rows filled on thermo steps (and the last step)
        and zero elsewhere (thermo_trace subsamples it)."""
        ntimes = self.inp.ntimes if ntimes is None else ntimes
        every, nstat = self.inp.neigh_every, self.inp.thermo_nstat
        dt, dtf = self.inp.dt, self.dtforce
        mass, scales, natoms = self.mass, self.scales, self.natoms

        # The kicks and drifts below update x and v in place (one pass
        # each instead of two). That would destroy the state a replay
        # after an overflow restarts from, so keep an untouched copy.
        before = self.state.clone()
        x, v, f, typ = (self.state.x, self.state.v, self.state.f,
                        self.state.typ)
        # columns T, U, P, rebin overflow; stays on the device
        trace = torch.zeros((ntimes, 4), dtype=self.dtype, device=self.device)
        eng = vir = None
        for n in range(ntimes):
            v.add_(f, alpha=dtf)
            x.add_(v, alpha=dt)
            if (n + 1) % every == 0:
                x, v, typ, ovf = self.rebin_fn(x, v, typ)
                trace[n, 3] = ovf
            # energy/virial on thermo steps and on the final step, so the
            # trace always ends with a thermo row (sim.py:400 of the JAX
            # package; the reference's final compute, ljs.cpp:477-483)
            evflag = nstat > 0 and ((n + 1) % nstat == 0 or n == ntimes - 1)
            f, eng, vir = (self.force_fn if evflag else self.force_fn_noev)(
                x, typ)
            v.add_(f, alpha=dtf)
            if evflag or nstat == 0:
                t = thermo.temperature(v, mass, scales)
                trace[n, :3] = torch.stack([
                    t, thermo.energy(eng, natoms, scales),
                    thermo.pressure(t, vir, scales)])

        host = trace.cpu().numpy()          # the run's one host sync
        overflow = before.overflow + int(host[:, 3].sum())
        if overflow > 0:
            # grow-and-replay, the reference's neighbor-bin resize
            # semantics (neighbor.cpp:186-208): the overflowed trajectory
            # dropped atoms, so restart from the pre-run state
            if self.geom.capacity >= cells.MAX_CAPACITY:
                raise RuntimeError(
                    f"cell capacity overflow: {overflow} atom(s) did not "
                    f"fit (capacity {self.geom.capacity}); rebuild with a "
                    "larger --capacity")
            old_nb, old_cap = self.geom.nb, self.geom.capacity
            grown = min(cells.next_capacity(old_cap), cells.MAX_CAPACITY)
            self._regrow(before, grown, retune=True)
            print(f"# resize: grid {old_nb} C={old_cap} -> {self.geom.nb} "
                  f"C={self.geom.capacity} (rebin overflow), replaying")
            return self.run(ntimes)

        self.state = MDState(x=x, v=v, f=f, typ=typ, valid=cells.is_valid(x),
                             overflow=overflow)
        # thermo state after a run comes from an evflag force on the final
        # positions (ljs.cpp:477-483): the last step computed exactly that
        # unless nstat == 0 (or the run was empty)
        if not (nstat > 0 and ntimes > 0):
            _, eng, vir = self.force_fn(x, typ)
        self.eng_vdwl, self.virial = eng, vir
        return host[:, :3]

    def _regrow(self, s: MDState, capacity: int, retune: bool = False):
        """Re-lay the state out in a geometry with larger cell capacity;
        forces are recomputed from positions. retune=True re-runs the grid
        autotuner on the live positions when the user pinned neither the
        grid nor the capacity (at most 3 times)."""
        valid = s.valid.cpu().numpy()
        prd = np.asarray(self.geom.prd)
        xs = np.mod(s.x.cpu().numpy().T[valid], prd)  # fold unfolded coords
        vs = s.v.cpu().numpy().T[valid]
        ts = s.typ.cpu().numpy()[valid]
        solid = (self.inp.forcetype == FORCE_EAM
                 and self.inp.datafile is None)
        geom = None
        if (retune and self._user_nbins is None
                and self._user_capacity is None and self._regrows < 3):
            geom = cells.build_geometry(prd, self.inp.neigh_cut, xs,
                                        solid=solid)
            if (geom.nb == self.geom.nb
                    and geom.capacity <= self.geom.capacity):
                geom = None   # autotune reproduced the overflowing layout
        if geom is None:
            geom = cells.build_geometry(prd, self.inp.neigh_cut, xs,
                                        nbins=self.geom.nb, capacity=capacity,
                                        solid=solid)
        self._regrows += 1
        self._set_geometry(geom)
        self.state = init_state(xs, vs, ts, geom, dtype=self.dtype,
                                device=self.device)
        row0 = self._row0
        self._compute_initial_force()
        self._row0 = row0   # step-0 thermo belongs to the original run

    def thermo_trace(self, trace: np.ndarray) -> list[tuple[int, float, float, float]]:
        """Subsample the per-step trace at thermo_nstat cadence, including
        step 0. A trailing partial interval (or the nstat == 0 end row) is
        recomputed from the post-run evflag force (ljs.cpp:477-483)."""
        nstat = self.inp.thermo_nstat
        rows = [self._row0]
        for n in range(len(trace)):
            if nstat and (n + 1) % nstat == 0:
                rows.append((n + 1, *map(float, trace[n])))
        if len(trace) and (nstat == 0 or len(trace) % nstat != 0):
            rows.append(self.thermo_row(len(trace)))
        return rows


def _refuse_unported(half_neigh: bool, fused_step: bool):
    if half_neigh:
        raise _not_yet("half_neigh", "queue 1 item 8")
    if fused_step:
        raise _not_yet("fused_step", "queue 2 item 6")
