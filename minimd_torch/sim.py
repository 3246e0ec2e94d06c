"""Simulation orchestrator: setup, cells, forces and thermo wired into the
velocity-Verlet loop (the reference's Integrate::run + main setup
sequence, ref/integrate.cpp:70-207 / ref/ljs.cpp:385-468), LJ and EAM.

`run()` is a Python loop over steps that launches work on the device and
never waits for it: the thermo trace and the rebin overflow counts stay
in a device tensor until the one host sync at the end of the run.

The device and the shapes decide the path (force_path, rebin_path: the
JAX package's own choice with the card in the place of the TPU). On
CUDA, in float32 with stencil reach 1, at any cell capacity: the LJ
kernel (ops/lj_cuda.py, type-uniform parameters) or the two EAM kernels
(ops/eam_cuda.py) and, when every axis has at least 3 cells, the rebin
kernels (ops/rebin_cuda.py); smaller grids use the sort-based
rebin_lean, the JAX package's own geometry rule. Outside that envelope
the card runs what the JAX package runs on its accelerator: the plain LJ
grid (ops/lj_grid.py) for float64, reach > 1 or per-type tables; the
plain EAM grid (ops/eam_grid.py) for float32 with reach > 1; the
exact-spline EAM force (ops/eam.py) for float64; the plain rebin
(cells.rebin_local) for float64. A capacity overflow grows the cells to
next_capacity, as the JAX package grows them, past cells.MAX_CAPACITY
once. On the CPU: the plain LJ grid, the exact-spline EAM force (what
the JAX package runs on its CPU) and cells.rebin_local / rebin_lean, in
any dtype, on constants built once per geometry on the device.

fused_step=True (LJ, f32, thermo_nstat > 0, as in the JAX package) runs
each interval's plain steps through the fused step (ops/lj_step_cuda.py on
CUDA, ops/lj_step.py on the CPU): one launch per step for the force, both
kicks and the drift.

half_neigh=True is the Newton half-neighbor parity option on every device
(ops/lj_half.py with both ghost_newton variants, ops/eam_half.py): plain
torch, as the JAX package's half path is XLA, in any dtype; on CUDA the
rebin kernels still run it when the state is float32.

run_timed() runs the same steps as run() with phase timers (FORCE, NEIGH)
and a card sync at every stamp.

While a torch profiler records, run() opens the spans minimd.run (the
call), minimd.run.begin, minimd.interval (each reneighbor interval),
minimd.kick (a fused interval's seed), minimd.rebin, minimd.thermo,
minimd.run.end and minimd.regrow (timer.py), none of them once a step
outside the fused path's seed; construction times its parts
(minimd.setup.geometry, .upload, .tables, .kernels, .first_force) into
setup_record, seconds by name and `built` (this process ran nvcc).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import _build, cells, create, thermo
from .config import FORCE_EAM, FORCE_LJ, UNITS_METAL, In
from .timer import TIME_FORCE, TIME_NEIGH, SetupClock, keep_setup, spans
from .ops.eam import EAMTables
from .ops.lj import LJParams
from .ops.pairgrid import halo_extent
from .state import MDState, init_state
from .units import ThermoScales, thermo_scales


def force_path(forcetype: int, *, cuda: bool, dtype, reach: int,
               uniform: bool = True, half_neigh: bool = False) -> str:
    """The force path a Simulation takes, picked as minimd_tpu/sim.py
    picks it (`make_force` in from_arrays, `_use_pallas`), with the card
    in the place of the TPU:

    - "lj_half" / "eam_half": half_neigh, plain torch on every device;
    - "lj_cuda": the LJ kernel, for float32, type-uniform parameters and
      stencil reach 1 on the card; else "lj_grid", the plain grid;
    - "eam_cuda": the EAM kernels, for float32 and reach 1 on the card;
      "eam_grid" (the kernels' plain versions) for float32 with reach > 1
      on the card; else "eam", the exact-spline force (float64, or the
      CPU)."""
    if forcetype == FORCE_LJ:
        if half_neigh:
            return "lj_half"
        if cuda and dtype == torch.float32 and uniform and reach == 1:
            return "lj_cuda"
        return "lj_grid"
    if forcetype == FORCE_EAM:
        if half_neigh:
            return "eam_half"
        if cuda and dtype == torch.float32:
            return "eam_cuda" if reach == 1 else "eam_grid"
        return "eam"
    raise ValueError(f"unknown forcetype {forcetype}")


def rebin_path(geom: cells.CellGeometry, *, cuda: bool, dtype) -> str:
    """The rebin a Simulation takes: "rebin_cuda", the rebin kernels, for
    float32 on the card with at least 3 cells on every axis (any capacity);
    else "rebin_local", the plain pull (a float64 state on the card takes
    it, as the JAX package's Pallas pull is f32 only), or "rebin_lean", the
    sort-based placement, under 3 cells on an axis, where the +-1 pull would
    alias cells (the JAX package's own geometry rule)."""
    if min(geom.nb) < 3:
        return "rebin_lean"
    if cuda and dtype == torch.float32:
        return "rebin_cuda"
    return "rebin_local"


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
    # fused_step: plain steps through step_fn(x, w, evflag, out) ->
    # (x, w, eng, virial, vsq); seed_fn(x, v, f) -> (x, w) starts an interval
    fused_step: bool = False
    # the Newton half-neighbor force (ghost_newton: the reference's -gn)
    half_neigh: bool = False
    ghost_newton: bool = True
    step_fn: object = None
    seed_fn: object = None
    eng_vdwl: torch.Tensor | None = None
    virial: torch.Tensor | None = None
    # user-pinned geometry (None = autotuned; overflow recovery may then
    # re-grid from live occupancy, see _regrow) + regrow counter
    _user_nbins: object = None
    _user_capacity: object = None
    _regrows: int = 0
    _row0: tuple | None = None
    # the name of the cell layout, for force closures that keep a Verlet
    # list over it (ops/lj_cuda.py, the "lj_cuda" path of the plain step):
    # passed to them as `layout`, renewed at every change of layout; None
    # on other paths and with fused_step (whose force calls follow a
    # rebin, so the cell walk serves them)
    _layout: int | None = None
    # set-up's parts: host-clock seconds by name, and `built`
    setup_record: dict = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @staticmethod
    def from_input(inp: In, *, ntypes: int = 4, dtype=torch.float32,
                   device="cuda", nbins=None, capacity: int | None = None,
                   potential_path: str | None = None,
                   half_neigh: bool = False,
                   ghost_newton: bool = True,
                   fused_step: bool = False) -> "Simulation":
        _check_options(inp, dtype, half_neigh, fused_step)
        prd, x_np, v_np, typ_np, mass = create.setup_system(
            inp, ntypes, potential_path)
        return Simulation.from_arrays(
            inp, prd, x_np, v_np, typ_np, mass, ntypes=ntypes, dtype=dtype,
            device=device, nbins=nbins, capacity=capacity,
            potential_path=potential_path, half_neigh=half_neigh,
            ghost_newton=ghost_newton, fused_step=fused_step)

    @staticmethod
    def from_arrays(inp: In, prd, x_np, v_np, typ_np, mass: float, *,
                    ntypes: int | None = None, dtype=torch.float32,
                    device="cuda", nbins=None, capacity: int | None = None,
                    potential_path: str | None = None,
                    half_neigh: bool = False,
                    ghost_newton: bool = True,
                    fused_step: bool = False) -> "Simulation":
        """Build a Simulation from explicit, final state arrays (from_input
        and checkpoint.resume reduce to this). Velocities are taken as they
        are."""
        _check_options(inp, dtype, half_neigh, fused_step)
        # The shipped EAM decks are solid Cu (600 K start, cooling): vouch
        # crystallinity so commensurate grids get lattice-tight capacity
        # (cells.pick_capacity), as the JAX package does. Wrong vouches
        # fail loudly via the rebin overflow counter.
        solid = inp.forcetype == FORCE_EAM and inp.datafile is None
        clock = SetupClock()
        with clock.part("geometry"):
            geom = cells.build_geometry(prd, inp.neigh_cut, x_np, nbins=nbins,
                                        capacity=capacity, solid=solid)
        with clock.part("upload"):
            state = init_state(x_np, v_np, typ_np, geom, dtype=dtype,
                               device=device)
        sim = Simulation.from_state(
            inp, geom, state, mass, ntypes=ntypes, dtype=dtype, device=device,
            potential_path=potential_path, half_neigh=half_neigh,
            ghost_newton=ghost_newton, fused_step=fused_step)
        sim._user_nbins, sim._user_capacity = nbins, capacity
        sim.setup_record = keep_setup({**clock.record,
                                       **sim.setup_record})
        return sim

    @staticmethod
    def from_state(inp: In, geom: cells.CellGeometry, state: MDState,
                   mass: float, *, ntypes: int | None = None,
                   dtype=torch.float32, device="cuda",
                   potential_path: str | None = None,
                   half_neigh: bool = False,
                   ghost_newton: bool = True,
                   fused_step: bool = False) -> "Simulation":
        """Build a Simulation on a state already laid out in `geom`, e.g. one
        carried across from the JAX package (state.state_from_reference,
        state.geometry_from_reference). Forces are recomputed; the EAM
        mass is the potential file's."""
        _check_options(inp, dtype, half_neigh, fused_step)
        device = torch.device(device)
        clock = SetupClock()
        valid = state.valid.cpu().numpy()
        # atoms a capacity overflow dropped still count (grow-and-replay
        # restores them)
        natoms = int(valid.sum()) + state.overflow
        if ntypes is None:
            typ = state.typ.cpu().numpy()[valid]
            ntypes = int(typ.max()) + 1 if natoms else 1
        cuda = device.type == "cuda"
        kernels = cuda and dtype == torch.float32
        params = tables = None
        with clock.part("tables"):
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
            params=params, tables=tables, fused_step=fused_step,
            half_neigh=half_neigh, ghost_newton=ghost_newton)
        with clock.part("tables"):
            if sim._force_path(geom, cuda) in ("eam_cuda", "eam_grid"):
                tables.polys    # the pair polynomials' fit, which they read
        with clock.part("kernels"):
            if kernels:   # float32 on the card: a force or rebin kernel
                _build.lib()
        sim._set_geometry(geom)
        with clock.part("first_force"):
            sim._compute_initial_force()
        sim.setup_record = keep_setup({**clock.record,
                                       "built": _build.built})
        return sim

    def _set_geometry(self, geom: cells.CellGeometry):
        """Build the force and rebin closures for a geometry."""
        self.geom = geom
        cuda = self.device.type == "cuda"
        self.force_fn, self.force_fn_noev = self._make_force(geom, cuda)
        self._layout = 0 if (self._force_path(geom, cuda) == "lj_cuda"
                             and not self.fused_step) else None
        if self.fused_step:
            self.step_fn, self.seed_fn = self._make_step(geom, cuda)
        self.rebin_fn = self._make_rebin(geom, cuda)

    def _make_step(self, geom: cells.CellGeometry, cuda: bool):
        """(step, seed) of the fused step: its kernel on the card."""
        if cuda:
            from .ops.lj_step_cuda import make_lj_step_cuda as make_step
        else:
            from .ops.lj_step import make_lj_step_plain as make_step
        return make_step(geom, self.params, self.inp.dt, self.dtforce,
                         self.dtype, self.device)

    def _make_rebin(self, geom: cells.CellGeometry, cuda: bool):
        """The rebin closure on the path rebin_path picks; the plain
        rebins' constants are built once per geometry."""
        path = rebin_path(geom, cuda=cuda, dtype=self.dtype)
        if path == "rebin_cuda":
            from .ops.rebin_cuda import make_rebin_cuda
            return make_rebin_cuda(geom, self.device)
        rebin = cells.rebin_lean if path == "rebin_lean" else \
            cells.rebin_local
        return functools.partial(
            rebin, geom=geom, consts=cells.RebinConstants.build(
                geom, self.dtype, self.device))

    def _force_path(self, geom: cells.CellGeometry, cuda: bool) -> str:
        """force_path for a geometry."""
        return force_path(
            self.inp.forcetype, cuda=cuda, dtype=self.dtype,
            reach=halo_extent(geom), half_neigh=self.half_neigh,
            uniform=self.params is None or self.params.uniform)

    def _make_force(self, geom: cells.CellGeometry, cuda: bool):
        """(force_ev, force_noev) for a geometry on this device, on the
        path that force_path picks."""
        path = self._force_path(geom, cuda)
        args = (geom, self.params if self.tables is None else self.tables,
                self.dtype, self.device)
        if path == "lj_half":
            from .ops.lj_half import make_lj_force_half
            return make_lj_force_half(*args, ghost_newton=self.ghost_newton)
        if path == "eam_half":
            from .ops.eam_half import make_eam_force_half as make
        elif path == "lj_cuda":
            from .ops.lj_cuda import make_lj_force_cuda
            return make_lj_force_cuda(*args, cutneigh=self.inp.neigh_cut)
        elif path == "lj_grid":
            from .ops.lj_grid import make_lj_force_grid as make
        elif path == "eam_cuda":
            from .ops.eam_cuda import make_eam_force_cuda as make
        elif path == "eam_grid":
            from .ops.eam_grid import make_eam_force_grid as make
        else:
            from .ops.eam import make_eam_force
            force = make_eam_force(*args)
            return force, force
        return make(*args)

    def _force(self, evflag: bool, x, typ):
        """The force closure's (f, eng, virial) on x, naming the layout to
        a closure that keeps a Verlet list."""
        fn = self.force_fn if evflag else self.force_fn_noev
        if self._layout is None:
            return fn(x, typ)
        return fn(x, typ, layout=self._layout)

    def _compute_initial_force(self):
        f, eng, vir = self._force(True, self.state.x, self.state.typ)
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
        return self._run(ntimes)

    def run_timed(self, timer, ntimes: int | None = None,
                  check_exchange: bool = False) -> np.ndarray:
        """run() with the reference's phase timers (integrate.cpp:101-192;
        minimd_tpu/sim.py:783-921): the same steps in the same order, with
        the card synchronized at every stamp. FORCE takes the plain steps
        and each reneighbor step's kicks, drift, force and kick; NEIGH the
        rebin. The fused step is not used, as in the JAX package. A rebin
        overflow grows the capacity at once and the run goes on from the
        regrown state, where run() replays from the start: the rows equal
        run()'s bit for bit only when no rebin overflows (after one, the
        regrown grid sums the forces in another order).

        check_exchange: audit each interval's largest displacement against
        skin/2, the bound that keeps the frozen cell assignment as good as
        a cached Verlet list (the reference's --check_exchange,
        integrate.cpp:112-151, as minimd_tpu adapts it)."""
        return self._run(ntimes, timer=timer, check_exchange=check_exchange)

    def _run(self, ntimes, timer=None, check_exchange=False) -> np.ndarray:
        span = spans()
        with span("minimd.run"):
            return self._steps(ntimes, timer, check_exchange, span)

    def _steps(self, ntimes, timer, check_exchange, span) -> np.ndarray:
        ntimes = self.inp.ntimes if ntimes is None else ntimes
        every, nstat = self.inp.neigh_every, self.inp.thermo_nstat
        dt, dtf = self.inp.dt, self.dtforce
        mass, scales, natoms = self.mass, self.scales, self.natoms
        timed = timer is not None

        with span("minimd.run.begin"):
            # The kicks and drifts below update x and v (and the fused
            # step w) in place (one pass each instead of two). That would
            # destroy the state a replay after an overflow restarts from,
            # so keep an untouched copy (a timed run regrows in place and
            # never replays).
            before = self.state if timed else self.state.clone()
            x, v, f, typ = (self.state.x, self.state.v, self.state.f,
                            self.state.typ)
            # columns T, U, P, rebin overflow; stays on the device
            trace = torch.zeros((ntimes, 4), dtype=self.dtype,
                                device=self.device)
            eng = vir = None
            xold = x.clone() if check_exchange else None

        def stamp(which):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            timer.stamp(which)

        def row(n, t, eng, vir):
            trace[n, :3] = torch.stack([
                t, thermo.energy(eng, natoms, scales),
                thermo.pressure(t, vir, scales)])

        def rebin(n, x, v, typ):
            nonlocal xold
            if not timed:
                x, v, typ, ovf = self.rebin_fn(x, v, typ)
                trace[n, 3] = ovf
                return x, v, typ
            stamp(TIME_FORCE)
            if check_exchange:
                self._audit_displacement(x, xold)
            xn, vn, tn, ovf = self.rebin_fn(x, v, typ)
            if int(ovf) > 0:
                # the re-layout on the host is the rebin: go on from it
                with span("minimd.regrow"):
                    xn, vn, tn = self._regrow_mid_run(x, v, typ)
            if check_exchange:
                xold = xn.clone()
            stamp(TIME_NEIGH)
            return xn, vn, tn

        def finish(n, x, v, typ):
            """The step's rebin (on reneighbor steps), force and second
            kick, and its thermo row."""
            if (n + 1) % every == 0:
                with span("minimd.rebin"):
                    x, v, typ = rebin(n, x, v, typ)
                if self._layout is not None:
                    self._layout += 1    # the Verlet list is built anew
            # energy/virial on thermo steps and on the final step, so the
            # trace always ends with a thermo row (sim.py:400 of the JAX
            # package; the reference's final compute, ljs.cpp:477-483)
            evflag = nstat > 0 and ((n + 1) % nstat == 0 or n == ntimes - 1)
            f, eng, vir = self._force(evflag, x, typ)
            v.add_(f, alpha=dtf)
            if evflag or nstat == 0:
                with span("minimd.thermo"):
                    row(n, thermo.temperature(v, mass, scales), eng, vir)
            return x, v, f, typ, eng, vir

        if timed:
            timer.stamp()
        start = 0
        if self.fused_step and not timed:
            # every complete interval: seed (step n0's first kick and
            # drift), every-1 fused steps, then the reneighbor step on
            # (x, w), which the last fused step already kicked and drifted
            # (sim.py:518-567 of the JAX package)
            tsc = mass * scales.t_scale
            start = ntimes - ntimes % every
            for n0 in range(0, start, every):
                with span("minimd.interval"):
                    with span("minimd.kick"):
                        x, w = self.seed_fn(x, v, f)
                    spare = torch.empty_like(x)    # positions ping-pong
                    for n in range(n0, n0 + every - 1):
                        evflag = (n + 1) % nstat == 0
                        xn, w, e, vr, vsq = self.step_fn(x, w, evflag,
                                                         out=spare)
                        x, spare = xn, x
                        if evflag:
                            with span("minimd.thermo"):
                                row(n, vsq * tsc, e, vr)
                    x, v, f, typ, eng, vir = finish(n0 + every - 1, x, w,
                                                    typ)
        # one interval a reneighbor (the last may be partial)
        for n0 in range(start, ntimes, every):
            with span("minimd.interval"):
                for n in range(n0, min(n0 + every, ntimes)):
                    v.add_(f, alpha=dtf)
                    x.add_(v, alpha=dt)
                    x, v, f, typ, eng, vir = finish(n, x, v, typ)
        if timed:
            stamp(TIME_FORCE)

        with span("minimd.run.end"):
            host = trace.cpu().numpy()   # an untimed run's one host sync
            overflow = before.overflow + int(host[:, 3].sum())
            if overflow == 0:
                self.state = MDState(x=x, v=v, f=f, typ=typ,
                                     valid=cells.is_valid(x),
                                     overflow=overflow)
                # thermo state after a run comes from an evflag force on
                # the final positions (ljs.cpp:477-483): the last step
                # computed exactly that unless nstat == 0 (or the run was
                # empty)
                if not (nstat > 0 and ntimes > 0):
                    _, eng, vir = self._force(True, x, typ)
                self.eng_vdwl, self.virial = eng, vir
                return host[:, :3]
        if timed or self.geom.capacity >= cells.MAX_CAPACITY:
            raise RuntimeError(
                f"cell capacity overflow: {overflow} atom(s) did not "
                f"fit (capacity {self.geom.capacity}); rebuild with a "
                "larger --capacity")
        # grow-and-replay, the reference's neighbor-bin resize semantics
        # (neighbor.cpp:186-208): the overflowed trajectory dropped atoms,
        # so restart from the pre-run state
        old_nb, old_cap = self.geom.nb, self.geom.capacity
        with span("minimd.regrow"):
            self._regrow(before, cells.next_capacity(old_cap), retune=True)
        print(f"# resize: grid {old_nb} C={old_cap} -> {self.geom.nb} "
              f"C={self.geom.capacity} (rebin overflow), replaying")
        return self._steps(ntimes, None, False, span)

    def _regrow_mid_run(self, x, v, typ):
        """A timed run's rebin overflowed: lay the pre-rebin state out in a
        grown geometry (the host re-layout is the rebin) and return its
        (x, v, typ) (minimd_tpu/sim.py:883-901)."""
        if self.geom.capacity >= cells.MAX_CAPACITY:
            raise RuntimeError(
                f"cell capacity overflow during a timed run (capacity "
                f"{self.geom.capacity}); rebuild with a larger --capacity")
        old_nb, old_cap = self.geom.nb, self.geom.capacity
        pre = MDState(x=x, v=v, f=torch.zeros_like(x), typ=typ,
                      valid=cells.is_valid(x), overflow=0)
        self._regrow(pre, cells.next_capacity(old_cap), retune=True)
        print(f"# resize: grid {old_nb} C={old_cap} -> {self.geom.nb} "
              f"C={self.geom.capacity} (rebin overflow), re-laying out")
        if self.state.overflow:
            raise RuntimeError(
                f"cell capacity overflow during a timed run: "
                f"{self.state.overflow} atom(s) did not fit the grown "
                f"capacity {self.geom.capacity}")
        return self.state.x, self.state.v, self.state.typ

    def _audit_displacement(self, x, xold):
        """Warn when an atom moved more than skin/2 since the last rebin:
        pairs may then be missed."""
        skin_half = 0.5 * (self.inp.neigh_cut - self.inp.force_cut)
        both = cells.is_valid(x) & cells.is_valid(xold)
        d = float(torch.where(both, (x - xold).abs(), 0.0).max())
        if d > skin_half:
            print(f"Warning: max per-interval displacement {d:.4f} exceeds "
                  f"skin/2 = {skin_half:.4f}; pairs may be missed - increase "
                  "the reneighboring frequency or the skin "
                  "(integrate.cpp:112-151 analog)")
        return d

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


def _check_options(inp: In, dtype, half_neigh: bool, fused_step: bool):
    """Refuse fused_step outside LJ, full neighbors, float32 and
    thermo_nstat > 0 (ValueError, where the JAX package's from_arrays
    raises it)."""
    if fused_step and (inp.forcetype != FORCE_LJ or half_neigh
                       or dtype != torch.float32 or inp.thermo_nstat == 0):
        raise ValueError(
            "fused_step requires the LJ full-neighbor float32 path with "
            "thermo_nstat > 0")
