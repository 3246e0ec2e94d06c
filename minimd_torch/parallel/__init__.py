"""The spatially decomposed run: the counterpart of minimd_tpu/parallel.

    from minimd_torch.parallel import ShardedSimulation
    ssim = ShardedSimulation.from_input(builtin_deck("lj"),
                                        devices=["cuda:0"] * 8)
    trace = ssim.run(100)
    rows = ssim.thermo_trace(trace)

The mesh is a list of domains in one process, each a block of cells on a
torch.device; devices may repeat (["cuda:0"] * 8 is a 2x2x2 mesh on one
card, ["cpu"] * 8 the tests' mesh), and every exchange between domains is
a tensor copy (a peer copy between cards) of what the receiving device's
domains read: the boundary slabs of the halo, the Newton shells of the
folds, the leaver packs of ring neighbors. This is the JAX package's own
model: one program over the mesh's devices.

mesh.py   - min-surface processor grid, the domains and their copies
step.py   - halo exchange and its fold, the forces on the domains, the
            run loop
comm.py   - atom migration (leaver buffers along the rings, local rebin)
dryrun.py - a two-step run with migration on a small mesh (dryrun_multichip)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mesh import (Mesh, Router, make_mesh, mesh_devices,  # noqa: F401
                   min_surface_grid)


@dataclasses.dataclass
class ShardedSimulation:
    """Multi-domain counterpart of Simulation: the same deck inputs, the
    state split over a mesh chosen by min-surface factorization. The
    physics is the single-device path's, with the forces of each domain
    atom for atom those of the same path on one device."""

    inp: object
    geom: object
    mesh: Mesh
    router: Router
    run_fn: object
    natoms: int
    scales: object
    mass: float
    state_: object            # state.ShardedState
    dtype: torch.dtype = torch.float32
    dtforce: float = 0.0
    row0: tuple = (0, 0.0, 0.0, 0.0)   # step-0 thermo (T, U, P)
    # (geom, buf_cap) -> (run_fn, force0), for the grow-and-replay paths
    _rebuild: object = None
    # the migration buffers' capacity (None: one boundary cell layer)
    _buf_cap: object = None
    # the Newton half-neighbor force (ghost_newton: the reference's -gn)
    half_neigh: bool = False
    ghost_newton: bool = True
    # per reneighbor interval of run_timed, the (force, comm, neigh)
    # seconds it stamped (output.per_device_statistics reads them)
    interval_stamps: list = dataclasses.field(default_factory=list)
    # run_timed(check_exchange=True): the positions after the last
    # migration, per group
    _xold: object = None
    # set-up's parts: host-clock seconds by name, and `built`
    # (Simulation.setup_record's names)
    setup_record: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_input(inp, devices=None, *, dtype=torch.float32, nbins=None,
                   safe_exchange=False, ntypes: int = 4,
                   capacity: int | None = None, half_neigh: bool = False,
                   ghost_newton: bool = True,
                   potential_path: str | None = None,
                   cell_chunk: int | None = None,
                   exchange_buf_cap: int | None = None):
        from .. import create

        prd, x_np, v_np, typ_np, mass = create.setup_system(
            inp, ntypes, potential_path)
        return ShardedSimulation.from_arrays(
            inp, prd, x_np, v_np, typ_np, mass, devices=devices,
            dtype=dtype, nbins=nbins, safe_exchange=safe_exchange,
            capacity=capacity, half_neigh=half_neigh,
            ghost_newton=ghost_newton, potential_path=potential_path,
            cell_chunk=cell_chunk, exchange_buf_cap=exchange_buf_cap)

    @staticmethod
    def from_arrays(inp, prd, x_np, v_np, typ_np, mass, *, devices=None,
                    dtype=torch.float32, nbins=None, safe_exchange=False,
                    capacity: int | None = None, row0=None,
                    half_neigh: bool = False, ghost_newton: bool = True,
                    potential_path: str | None = None,
                    cell_chunk: int | None = None,
                    exchange_buf_cap: int | None = None):
        """A decomposed simulation from explicit state arrays. devices:
        one entry per domain (default: every visible CUDA card, one domain
        each; there is no CPU default, pass ["cpu"] * k for the CPU).
        half_neigh: the Newton half-neighbor force on the domains, plain
        torch on every device (ghost_newton=False is the reference's
        -gn 0, LJ only; EAM always folds); the step-0 forces and row come
        from the full-stencil force, as in the JAX package. cell_chunk
        belongs to the single-device exact-spline EAM force and is
        refused here. exchange_buf_cap pins the migration buffers (grown
        and replayed on overflow, comm.cpp:887-909)."""
        if cell_chunk is not None:
            raise ValueError(
                "cell_chunk applies to the single-device exact-spline EAM "
                "force only; the decomposed forces have no chunk dimension")
        from .. import _build, cells, thermo
        from ..config import FORCE_EAM, FORCE_LJ, UNITS_METAL
        from ..ops.eam import EAMTables
        from ..ops.lj import LJParams
        from ..ops.pairgrid import halo_extent
        from ..state import init_state, sharded_from_grid
        from ..timer import SetupClock, keep_setup
        from ..units import thermo_scales
        from .comm import make_exchange_rebin
        from .step import (local_grid_shape, make_domain_force,
                           make_sharded_run, sharded_force_path)

        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("ShardedSimulation: no CUDA card is "
                                   "visible; pass devices=['cpu'] * k for "
                                   "the CPU")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devices = list(devices)
        clock = SetupClock()
        natoms = len(x_np)
        ntypes = int(np.max(typ_np)) + 1 if natoms else 1
        prd = tuple(float(p) for p in prd)
        with clock.part("tables"):
            if inp.forcetype == FORCE_EAM:
                model = EAMTables.from_funcfl(potential_path)
                mass = model.mass
                model.polys   # the fit every decomposed EAM force0 reads
            elif inp.forcetype == FORCE_LJ:
                model = LJParams.from_deck(ntypes, inp.epsilon, inp.sigma,
                                           inp.force_cut)
            else:
                raise ValueError(f"unknown forcetype {inp.forcetype}")
        scales = thermo_scales(inp.units, natoms,
                               prd[0] * prd[1] * prd[2])

        grid = min_surface_grid(len(devices), prd)
        solid = inp.forcetype == FORCE_EAM and inp.datafile is None
        with clock.part("geometry"):
            if nbins is None:
                nb = cells.autotune_grid(prd, inp.neigh_cut, x_np,
                                         solid=solid, multiple_of=grid)
            else:
                # a pinned grid snaps down to the mesh, never up
                nb = cells.snap_to_mesh(
                    cells.choose_grid(prd, inp.neigh_cut, nbins), grid)
                if nb is None:
                    raise ValueError(f"the grid {tuple(nbins)} has fewer "
                                     f"cells than the mesh {grid} on an "
                                     "axis")
            geom = cells.build_geometry(prd, inp.neigh_cut, x_np, nbins=nb,
                                        capacity=capacity, solid=solid)
        mesh = make_mesh(devices, prd, grid)
        router = Router(mesh)
        dev0 = router.groups[0][0]

        dtforce = 0.5 * inp.dt
        if inp.units == UNITS_METAL:
            dtforce /= scales.mvv2e
        dtforce /= mass
        # --safe_exchange: leavers go up to half a ring per axis, enough
        # to place an atom from any domain (comm.cpp:599-689)
        hops = max(max(mesh.shape.values()) // 2, 1) if safe_exchange else 1

        def rebuild(geom, buf_cap=exchange_buf_cap):
            """(run_fn, force0) for a geometry and buffer capacity: the
            grow-and-replay paths' rebuild (neighbor.cpp:241-261,
            comm.cpp:887-909). force0 is the single-device force of the
            path the domains take, for the step-0 forces and row."""
            nb_local = local_grid_shape(geom, mesh)
            h = halo_extent(geom)
            force = make_domain_force(inp.forcetype, geom, model, mesh,
                                      router, nb_local, dtype,
                                      half_neigh=half_neigh,
                                      ghost_newton=ghost_newton)
            kernel = (all(dev.type == "cuda" for dev, _ in router.groups)
                      and dtype == torch.float32 and hops == 1
                      and all(mesh.shape[a] > 1 or n >= 3 for a, n in
                              zip(("x", "y", "z"), nb_local)))
            ex = make_exchange_rebin(geom, mesh, router, nb_local, dtype,
                                     buf_cap=buf_cap, hops=hops,
                                     kernel=kernel,
                                     graph=kernel and len(router.groups) == 1)
            run_fn = make_sharded_run(
                force, ex, router, mass=mass, dt=inp.dt, dtforce=dtforce,
                scales=scales, natoms=natoms, neigh_every=inp.neigh_every,
                nstat=inp.thermo_nstat, dtype=dtype)
            # the half paths start from the plain full-stencil force, as
            # the JAX package's force0 takes its XLA grid with half_neigh
            path = sharded_force_path(
                inp.forcetype, cuda=dev0.type == "cuda" and not half_neigh,
                dtype=dtype,
                reach=h, uniform=inp.forcetype != FORCE_LJ or model.uniform)
            if path == "lj_cuda":
                from ..ops.lj_cuda import make_lj_force_cuda as make
            elif path == "lj_grid":
                from ..ops.lj_grid import make_lj_force_grid as make
            elif path == "eam_cuda":
                from ..ops.eam_cuda import make_eam_force_cuda as make
            else:
                from ..ops.eam_grid import make_eam_force_grid as make
            return run_fn, make(geom, model, dtype, dev0)[0]

        with clock.part("kernels"):
            if dtype == torch.float32 and any(
                    dev.type == "cuda" for dev, _ in router.groups):
                _build.lib()
        run_fn, force0 = rebuild(geom)
        with clock.part("upload"):
            st = init_state(x_np, v_np, typ_np, geom, dtype=dtype,
                            device=dev0)
        with clock.part("first_force"):
            f0, eng0, vir0 = force0(st.x, st.typ)
            if row0 is None:
                t0 = float(thermo.temperature(st.v, mass, scales))
                row0 = (0, t0, float(thermo.energy(eng0, natoms, scales)),
                        float(thermo.pressure(t0, vir0, scales)))
        with clock.part("upload"):   # the domains' shares of it
            state = sharded_from_grid(*_grid_view(st.x, st.v, f0, st.typ,
                                                  st.valid, geom),
                                      mesh, geom, dtype)
        return ShardedSimulation(
            inp=inp, geom=geom, mesh=mesh, router=router, run_fn=run_fn,
            natoms=natoms, scales=scales, mass=mass, state_=state,
            dtype=dtype, dtforce=dtforce, row0=row0, _rebuild=rebuild,
            _buf_cap=exchange_buf_cap, half_neigh=half_neigh,
            ghost_newton=ghost_newton,
            setup_record=keep_setup({**clock.record,
                                     "built": _build.built}))

    def run(self, ntimes: int, n0: int = 0) -> np.ndarray:
        """Run ntimes steps; returns the (ntimes, 3) T/U/P trace, rows on
        thermo steps and the last step, zero elsewhere. n0: the global
        step number of the first step (the cadences key on it). One host
        sync for the trace and the overflow counts together."""
        return self._run(ntimes, n0)

    def run_timed(self, timer, ntimes: int | None = None,
                  check_exchange: bool = False) -> np.ndarray:
        """run() with the reference's phase timers (integrate.cpp:101-192
        on its MPI path), one reneighbor interval at a time: the same
        steps in the same order, the thermo cadences on global step
        numbers, so the rows equal run()'s bit for bit while nothing
        overflows. The loop issues the halo, the forces and the migration
        as separate calls, so it stamps them as they run, the mesh's
        cards synchronized at each stamp: COMM the halo (with the fp halo
        and the half paths' Newton folds), NEIGH the migration, FORCE the
        rest. (The JAX package fuses them in one scan and replays the
        halo and the migration to estimate the split.) Each interval's
        (force, comm, neigh) seconds are appended to interval_stamps. An
        overflow grows and replays that interval (run()'s rebuilds).

        check_exchange: audit each interval's largest displacement against
        skin/2, the bound that keeps the frozen cell assignment as good as
        a cached Verlet list (the reference's --check_exchange,
        integrate.cpp:112-151, as minimd_tpu adapts it); skipped for an
        interval whose capacity regrow re-laid the slots."""
        from ..timer import TIME_COMM, TIME_FORCE, TIME_NEIGH

        ntimes = self.inp.ntimes if ntimes is None else ntimes
        every = self.inp.neigh_every
        keys = (TIME_FORCE, TIME_COMM, TIME_NEIGH)
        audit = None
        if check_exchange:
            self._xold = [t.clone() for t in self.state_.x]
            audit = self._audit_displacement
        parts, n = [], 0
        while n < ntimes:
            chunk = min(every, ntimes - n)
            was = [timer.array[k] for k in keys]
            parts.append(self._run(chunk, n, end=ntimes - 1, timer=timer,
                                   audit=audit))
            self.interval_stamps.append(tuple(
                timer.array[k] - w for k, w in zip(keys, was)))
            if check_exchange:
                self._xold = [t.clone() for t in self.state_.x]
            n += chunk
        return np.concatenate(parts) if parts else np.zeros((0, 3))

    def _audit_displacement(self, x):
        """Warn when an atom moved more than skin/2 since the last
        migration (x: per group, the positions just before this one)."""
        from ..cells import is_valid

        if self._xold is None:
            return None
        skin_half = 0.5 * (self.inp.neigh_cut - self.inp.force_cut)
        d = max(float(torch.where(
            (is_valid(a.transpose(0, 1)) & is_valid(b.transpose(0, 1)))
            [:, None], (a - b).abs(), 0.0).max()) for a, b in
                zip(x, self._xold))
        if d > skin_half:
            print(f"Warning: max per-interval displacement {d:.4f} exceeds "
                  f"skin/2 = {skin_half:.4f}; pairs may be missed - increase "
                  "the reneighboring frequency or the skin "
                  "(integrate.cpp:112-151 analog)")
        return d

    def _run(self, ntimes, n0=0, end=None, timer=None, audit=None):
        from ..cells import MAX_CAPACITY, next_capacity

        before = self.state_
        state, ovf, trace = self.run_fn(before.clone(), ntimes, n0, end=end,
                                        timer=timer, audit=audit)
        host = torch.cat([trace.double().reshape(-1),
                          ovf.to(device=trace.device,
                                 dtype=torch.float64)]).cpu().numpy()
        trace_np = host[:-3].reshape(ntimes, 3)
        ovf_move, ovf_cap, ovf_buf = (int(c) for c in host[-3:])
        if ovf_cap > 0 and self.geom.capacity < MAX_CAPACITY:
            # grow-and-replay (neighbor.cpp:241-261), checked before the
            # movement error: a capacity overflow early in the run can
            # show as spurious movement later; the replay decides
            newcap = next_capacity(self.geom.capacity)
            print(f"# resize: cell capacity {self.geom.capacity} -> "
                  f"{newcap} (migration overflow), replaying interval")
            self._regrow(before, newcap)
            self._xold = None        # the slots were laid out anew
            return self._run(ntimes, n0, end, timer, audit)
        if ovf_buf > 0:
            lx, ly, lz = self.nb_local
            C = self.geom.capacity
            Ml = lx * ly * lz * C
            base = (min(int(self._buf_cap), Ml) if self._buf_cap
                    else max(ly * lz, lx * lz, lx * ly) * C)
            newbuf = min(max(2 * base, base + ovf_buf), Ml)
            if newbuf > base:
                print(f"# resize: migration buffer {base} -> {newbuf} "
                      "slots (buffer overflow), replaying interval")
                self._buf_cap = newbuf
                self.run_fn, _ = self._rebuild(self.geom, newbuf)
                return self._run(ntimes, n0, end, timer, audit)
            raise RuntimeError(
                f"migration buffer overflow: {ovf_buf} leaver(s) did not "
                f"fit the exchange buffer ({base} slots); the system is "
                "displacing faster than the exchange can ship")
        if ovf_move > 0:
            raise RuntimeError(
                f"migration overflow: {ovf_move} atom(s) moved beyond the "
                "exchange reach in one reneighbor interval; rerun with "
                "safe_exchange=True (multi-hop migration) or reneighbor "
                "more often")
        if ovf_cap > 0:
            raise RuntimeError(
                f"cell capacity overflow: {ovf_cap} atom(s) did not fit "
                f"(cell capacity {self.geom.capacity}); rebuild with a "
                "larger capacity")
        self.state_ = state
        return trace_np

    @property
    def devices(self) -> list[str]:
        """Each domain's device, in domain order."""
        return [str(d) for d in self.mesh.devices.flat]

    @property
    def nb_local(self):
        from .step import local_grid_shape
        return local_grid_shape(self.geom, self.mesh)

    def _regrow(self, state, capacity: int):
        """Lay the state out again with a larger cell capacity (the same
        grid, so the mesh still divides it); the forces are recomputed
        from the positions."""
        from .. import cells
        from ..state import init_state, sharded_from_grid, sharded_to_grid

        x, v, _, typ, valid = sharded_to_grid(state, self.mesh, self.geom)
        ok = valid.reshape(-1)
        prd = np.asarray(self.geom.prd)
        xs = np.mod(x.reshape(3, -1).T[ok], prd)  # fold unfolded coords
        vs = v.reshape(3, -1).T[ok]
        ts = typ.reshape(-1)[ok]
        self.geom = cells.build_geometry(prd, self.inp.neigh_cut, xs,
                                         nbins=self.geom.nb,
                                         capacity=capacity)
        self.run_fn, force0 = self._rebuild(self.geom, self._buf_cap)
        dev0 = self.router.groups[0][0]
        st = init_state(xs, vs, ts, self.geom, dtype=self.dtype,
                        device=dev0)
        f0, _, _ = force0(st.x, st.typ)
        self.state_ = sharded_from_grid(
            *_grid_view(st.x, st.v, f0, st.typ, st.valid, self.geom),
            self.mesh, self.geom, self.dtype)

    @property
    def state(self):
        """The gathered state on the host: an MDState of CPU tensors,
        x, v, f (3, M) and typ, valid (M,) in the global cell layout (the
        JAX ShardedSimulation's `state` slots)."""
        from ..state import MDState, sharded_to_grid

        x, v, f, typ, valid = (torch.from_numpy(np.ascontiguousarray(a))
                               for a in sharded_to_grid(
                                   self.state_, self.mesh, self.geom))
        return MDState(x=x.reshape(3, -1), v=v.reshape(3, -1),
                       f=f.reshape(3, -1), typ=typ.reshape(-1),
                       valid=valid.reshape(-1), overflow=0)

    def thermo_trace(self, trace):
        """Thermo rows at thermo_nstat cadence with step 0, as
        Simulation.thermo_trace; the last step always runs with energy,
        so a trailing row is the trace's last (thermo.cpp:49-50,95-99 for
        nstat == 0)."""
        nstat = self.inp.thermo_nstat
        rows = [self.row0]
        for n in range(len(trace)):
            if nstat and (n + 1) % nstat == 0:
                rows.append((n + 1, *map(float, trace[n])))
        if len(trace) and (nstat == 0 or len(trace) % nstat != 0):
            rows.append((len(trace), *map(float, trace[-1])))
        return rows


def _grid_view(x, v, f, typ, valid, geom):
    """Flat (3, M) / (M,) single-device tensors as grid-shaped ones."""
    nbx, nby, nbz = geom.nb
    C = geom.capacity
    return (x.reshape(3, nbz, nby, nbx, C), v.reshape(3, nbz, nby, nbx, C),
            f.reshape(3, nbz, nby, nbx, C), typ.reshape(nbz, nby, nbx, C),
            valid.reshape(nbz, nby, nbx, C))
