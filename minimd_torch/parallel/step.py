"""The decomposed MD step: halo exchange, forces on each domain, and the
LJ and EAM run loops (the counterpart of minimd_tpu/parallel/step.py).

The reference's MPI machinery maps onto the domains of one process:

  proc grid (min-surface factorization)  -> Mesh of domains [mesh.py]
  borders/communicate (halo exchange)    -> copies of boundary cell
                                            slabs, axis by axis (Halo)
  MPI_Allreduce (thermo)                 -> a sum over the domains in
                                            domain order (Router)
  exchange (atom migration)              -> leaver buffers shipped
                                            along the mesh rings, then a
                                            local rebin [comm.py]

make_exchanges gives the slab exchange as hooks of ops/pairgrid.py's
to_padded_soa / pad_grid_int (the JAX package's _make_exchanges). A run
does not call them every step: Halo applies them once per geometry to
the slots' indices and to zeros, and each step's halo is then, per
device group, one copy from each other group of the boundary slots its
domains read (the per-hop ppermute's slabs), one gather and one add of
the image shifts (the exchange's own -prd / +prd, added as the hooks
subtract them, so the bits agree).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..cells import CellGeometry
from ..ops.pairgrid import _pad_halo
from ..thermo import ordered_sum
from ..timer import TIME_COMM, TIME_FORCE, TIME_NEIGH, no_span, spans
from .mesh import AXES, Mesh, Router

_AXIS_OF_GRID = {0: "z", 1: "y", 2: "x"}   # grid axis -> mesh axis name


def local_grid_shape(geom: CellGeometry, mesh: Mesh) -> tuple[int, int, int]:
    """Each domain's cells (lx, ly, lz); the grid must divide the mesh."""
    nbx, nby, nbz = geom.nb
    px, py, pz = mesh.shape["x"], mesh.shape["y"], mesh.shape["z"]
    if nbx % px or nby % py or nbz % pz:
        raise ValueError(f"cell grid {geom.nb} not divisible by mesh "
                         f"{(px, py, pz)}")
    return (nbx // px, nby // py, nbz // pz)


def make_exchanges(mesh: Mesh, prd, h: int, nb_local):
    """Per grid axis of a decomposed mesh axis, the halo exchange hook of
    pairgrid._pad_halo: hook(grids, coord_dim) -> [(lo, hi), ...], grids
    every domain's (partially padded) grid in domain order.

    The h-cell halo of an axis of L cells per domain is stitched from
    k = ceil(h/L) ring neighbors, one hop each (the reference's need[] > 1
    swap plan, comm.cpp:150-180): hop j gives the lo halo the top s cells
    of the domain j below and the hi halo the bottom s cells of the one j
    above, s = min(L, h - (j-1)*L). Positions of the coordinate along the
    axis are shifted by -prd (+prd) on the domains within j of the low
    (high) end of the box; coord_dim None ships a scalar unshifted."""
    lspan = {0: nb_local[2], 1: nb_local[1], 2: nb_local[0]}
    exchanges = {}
    for grid_axis, name in _AXIS_OF_GRID.items():
        n = mesh.shape[name]
        if n == 1:
            continue   # the periodic self-wrap handles it
        L = lspan[grid_axis]
        k = -(-h // L)
        if k > n:
            raise ValueError(
                f"a halo of {h} cells spans more than one full ring on mesh "
                f"axis {name!r} (L={L}, n={n})")

        def exchange(gs, coord_dim, *, name=name, n=n, k=k, L=L,
                     grid_axis=grid_axis):
            shift = coord_dim is not None and coord_dim == 2 - grid_axis
            p = float(prd[coord_dim]) if shift else 0.0
            out = []
            for dom, g in enumerate(gs):
                idx = mesh.coord(dom)[name]
                lo_parts, hi_parts = [], []
                for j in range(k, 0, -1):
                    s = min(L, h - (j - 1) * L)
                    part = gs[mesh.ring(dom, name, -j)].narrow(
                        grid_axis, L - s, s).to(g.device)
                    if shift and idx < j:
                        part = part - p
                    lo_parts.append(part)
                    part = gs[mesh.ring(dom, name, j)].narrow(
                        grid_axis, 0, s).to(g.device)
                    if shift and idx >= n - j:
                        part = part + p
                    hi_parts.append(part)
                out.append((torch.cat(lo_parts, dim=grid_axis),
                            torch.cat(hi_parts[::-1], dim=grid_axis)))
            return out

        exchanges[grid_axis] = exchange
    return exchanges


def _comm(name):
    """A Halo method that a timed run stamps as COMM (the reference's
    communicate and reverse_communicate): with `stamp` set, the time up to
    the call is closed as FORCE and the call's own as COMM, each stamp
    after a sync of the mesh's cards. The call is the span `name` of the
    run's span helper (`span`, set by make_sharded_run's run)."""
    def wrap(method):
        @functools.wraps(method)
        def timed(self, *args):
            if self.stamp is not None:
                self.stamp(TIME_FORCE)
            with self.span(name):
                out = method(self, *args)
            if self.stamp is not None:
                self.stamp(TIME_COMM)
            return out
        return timed
    return wrap


class Halo:
    """The halo of every domain, as one gather and one add per group.

    wrap=True: every axis padded by h (exchanged where decomposed, the
    periodic self-wrap elsewhere), the plain pair loops' padded grid.
    wrap=False: only the decomposed axes padded, by h, the input of the
    sharded CUDA pair kernels (which wrap the other axes themselves).
    `shape` is the padded (Z, Y, X, C) and `nslots` its slot count; fold
    is the adjoint of the fill, for the half-neighbor paths' Newton folds.
    `stamp` is set by a timed run and `span` by every run
    (make_sharded_run).

    A group reads its own domains' slots in place and receives from each
    other group only the slots its padded fields read (`sends`: per
    group, (source group, slots on the source's device) pairs, the sorted
    distinct slots of the source's domains), as the JAX package's per-hop
    ppermute ships the boundary slabs only; the fold ships each image's
    value back to the group that owns its slot. One group builds no route
    and copies nothing."""

    stamp = None
    span = staticmethod(no_span)

    def __init__(self, geom: CellGeometry, mesh: Mesh, router: Router,
                 h: int, nb_local, dtype, wrap: bool = True):
        self.router = router
        self.groups = router.groups
        self._tables = {}
        self.decomposed = mesh.decomposed
        lx, ly, lz = nb_local
        C = geom.capacity
        Ml = lx * ly * lz * C
        self.nlocal = Ml
        ex = make_exchanges(mesh, geom.prd, h, nb_local)
        # every padded slot's source as a global id, domain * Ml + slot
        ids = [(k * Ml + torch.arange(Ml, dtype=torch.int64)
                ).reshape(lz, ly, lx, C) for k in range(mesh.size)]
        idx = [g.reshape(-1) for g in _pad_halo(ids, h, 0.0, None, ex, wrap)]
        zeros = [torch.zeros((lz, ly, lx, C), dtype=dtype)] * mesh.size
        shift = [torch.stack([g.reshape(-1) for g in gs]) for gs in zip(
            *(_pad_halo(zeros, h, float(geom.prd[d]), d, ex, wrap)
              for d in range(3)))]
        self.nslots = idx[0].numel()
        # nothing to pad (one domain, or no decomposed axis, for the
        # kernels): the positions are the domains' own
        self.identity = not wrap and not ex
        where = router.where
        grp = torch.tensor([where[k][0] for k in range(mesh.size)])
        inner = torch.tensor([where[k][1] for k in range(mesh.size)])
        self._ids = [torch.stack([idx[k] for k in ks])
                     for _, ks in router.groups]            # (Dg, Mp)
        self.idx, self.idx3, self.shift = [], [], []
        self.sends, self.sends3 = [], []
        for g, (dev, ks) in enumerate(router.groups):
            ids_g = self._ids[g]
            dom, slot = ids_g // Ml, ids_g % Ml
            src, at = grp[dom], inner[dom]
            i1 = at * Ml + slot            # into the group's own (Dg, Ml)
            i3 = (at[:, None] * 3 + torch.arange(3)[None, :, None]) * Ml \
                + slot[:, None]                                   # (Dg,3,Mp)
            base1, base3 = len(ks) * Ml, len(ks) * 3 * Ml
            send, send3 = [], []
            for s in range(len(router.groups)):
                mine = src == s
                if s == g or not mine.any():
                    continue
                u, rank = torch.unique(at[mine] * Ml + slot[mine],
                                       return_inverse=True)
                n = u.numel()
                sdev = router.groups[s][0]
                send.append((s, u.to(sdev)))
                # the 3 coordinates of each slot, coordinate-major
                u3 = ((u // Ml * 3)[None] + torch.arange(3)[:, None]) * Ml \
                    + u % Ml
                send3.append((s, u3.reshape(-1).to(sdev)))
                i1[mine] = base1 + rank
                i3.permute(0, 2, 1)[mine] = (base3 + rank[:, None]
                                             + n * torch.arange(3)[None])
                base1, base3 = base1 + n, base3 + 3 * n
            self.sends.append(send)
            self.sends3.append(send3)
            self.idx.append(i1.reshape(-1).to(dev))
            self.idx3.append(i3.reshape(-1).to(dev))
            self.shift.append(torch.stack([shift[k] for k in ks]).to(dev))
        dims = [(n + 2 * h) if (wrap or dec) else n for n, dec in
                zip(nb_local, mesh.decomposed)]
        self.shape = (dims[2], dims[1], dims[0], C)

    def received(self, g: int) -> int:
        """The slots group g receives from the other groups per field and
        fill (positions: 3 values each), read from its routes."""
        return sum(int(i.numel()) for _, i in self.sends[g])

    def returned(self, g: int) -> int:
        """The values per component that group g ships back to the other
        groups per fold (each image of their slots in its padded fields),
        read from the fold's routes."""
        if not self._tables:
            self._build_fold()
        return sum(int(i.numel()) for ship in self._ship for s, i in ship
                   if s == g)

    @_comm("minimd.halo")
    def positions(self, xs):
        """Per group (Dg, 3, nslots): the padded positions of its domains
        from every domain's (D, 3, M_local) positions."""
        if self.identity:
            return list(xs)
        flat = self.router.pull([x.reshape(-1) for x in xs], self.sends3)
        return [f.take(i3).reshape(s.shape) + s
                for f, i3, s in zip(flat, self.idx3, self.shift)]

    @_comm("minimd.halo")
    def scalars(self, ts):
        """Per group (Dg, nslots): a padded per-slot field (types, fp),
        unshifted."""
        if self.identity:
            return list(ts)
        flat = self.router.pull([t.reshape(-1) for t in ts], self.sends)
        return [f.take(i).reshape(len(ks), self.nslots)
                for f, i, (_, ks) in zip(flat, self.idx, self.groups)]

    @_comm("minimd.fold")
    def fold(self, parts):
        """The adjoint of positions and scalars: per group (Dg, [3,]
        M_local), every padded slot's value of parts (per group (Dg, [3,]
        nslots)) added onto the slot it is an image of, in the domain that
        owns it (an interior slot onto itself). This is the reference's
        reverse communication (comm.cpp:320-361): the JAX package's fold
        hooks on decomposed axes and its periodic self-fold elsewhere, in
        one gather per group. Each group ships the values of its images of
        another group's slots to that group, one value per image, and the
        owner sums each slot's images on its own device in a fixed order,
        by the image's domain, then by its padded position (fold_table):
        the rows do not depend on how the domains lie on devices, and a
        run repeats bit for bit on the card (where index_add_ would add
        with atomics). The JAX folds add slab by slab, so the results
        agree with them to summation order."""
        vec = parts[0].dim() == 3
        Ml = self.nlocal
        if not self._tables:
            self._build_fold()
        flat = [p.transpose(0, 1).reshape(3, -1) if vec else p.reshape(1, -1)
                for p in parts]
        out = []
        for g, (buf, (_, ks)) in enumerate(zip(
                self.router.pull(flat, self._ship, dim=1), self.groups)):
            buf = torch.cat([buf, buf.new_zeros((len(buf), 1))], dim=1)
            acc = buf[:, self._tables[g]].sum(dim=1)    # (c, Dg * Ml)
            acc = acc.reshape(-1, len(ks), Ml).transpose(0, 1)
            out.append(acc if vec else acc[:, 0])
        return out

    def fold_table(self, g: int) -> torch.Tensor:
        """(K, Dg * M_local) on group g's device, built once with every
        group's: for each slot of the group's domains, the positions of
        its images in the group's fold input (its own flattened padded
        field, Dg * nslots, then what each other group ships it, in group
        order), by the image's domain and then its padded position, and
        after them the position one past the end (a zero). K is the most
        images of any slot of the mesh, the same for every group."""
        if not self._tables:
            self._build_fold()
        return self._tables[g]

    def _build_fold(self):
        """The fold tables, and `_ship`: per owner group, the (holder
        group, sorted positions in the holder's flattened padded field)
        of the images of the owner's slots that another group holds."""
        where, Ml, Mp = self.router.where, self.nlocal, self.nslots
        D = self.router.mesh.size
        grp = torch.tensor([where[k][0] for k in range(D)])
        inner = torch.tensor([where[k][1] for k in range(D)])
        own, key, hold, fpos = [], [], [], []
        for g, (_, ks) in enumerate(self.groups):
            n = len(ks) * Mp
            own.append(self._ids[g].reshape(-1))
            pos = torch.arange(n)
            key.append(torch.tensor(ks).repeat_interleave(Mp) * Mp
                       + pos % Mp)
            hold.append(torch.full((n,), g))
            fpos.append(pos)
        own, key, hold, fpos = (torch.cat(t) for t in (own, key, hold, fpos))
        ogrp = grp[own // Ml]
        at = fpos.clone()      # each image's position in its owner's input
        self._ship, nbuf = [], []
        for o, (_, ks) in enumerate(self.groups):
            base, ship = len(ks) * Mp, []
            for s in range(len(self.groups)):
                mine = (ogrp == o) & (hold == s)
                if s == o or not mine.any():
                    continue
                sel, rank = torch.unique(fpos[mine], return_inverse=True)
                ship.append((s, sel.to(self.groups[s][0])))
                at[mine] = base + rank
                base += sel.numel()
            self._ship.append(ship)
            nbuf.append(base)
        order = torch.argsort(key, stable=True)
        order = order[torch.argsort(own[order], stable=True)]
        so = own[order]
        rank = torch.arange(len(so)) - torch.searchsorted(so, so)
        K = int(rank.max()) + 1
        local = inner[so // Ml] * Ml + so % Ml
        for o, (dev, ks) in enumerate(self.groups):
            mine = grp[so // Ml] == o
            table = torch.full((K, len(ks) * Ml), nbuf[o], dtype=torch.int64)
            table[rank[mine], local[mine]] = at[order][mine]
            self._tables[o] = table.to(dev)


def sharded_force_path(forcetype: int, *, cuda: bool, dtype, reach: int,
                       uniform: bool = True) -> str:
    """The force a decomposed run takes on a device: sim.force_path's
    choice (the sharded forms of the LJ and EAM kernels for float32 and
    stencil reach 1 on the card, LJ with type-uniform parameters; else
    the plain grids), but the plain EAM
    grid where one device would take the exact splines: the JAX package's
    sharded EAM has no exact-spline form."""
    from ..sim import force_path

    path = force_path(forcetype, cuda=cuda, dtype=dtype, reach=reach,
                      uniform=uniform)
    return "eam_grid" if path == "eam" else path


def make_domain_force(forcetype: int, geom: CellGeometry, model, mesh: Mesh,
                      router: Router, nb_local, dtype,
                      half_neigh: bool = False, ghost_newton: bool = True):
    """force(x, typ, evflag) -> (f, eng, vir), each a list per device
    group: f (Dg, 3, M_local) the forces on the group's domains, eng and
    vir (Dg,) their energy and virial partials (None or zeros without
    evflag). model: LJParams or EAMTables. Each group takes
    sharded_force_path's path for its device; a domain's forces equal,
    atom for atom, those of the single-device force of the same path on
    the same cells. `force.halos` lists the Halo objects it reads.

    half_neigh: the Newton half-neighbor paths (ops/lj_half.py with both
    ghost_newton variants, ops/eam_half.py, which keeps the fold whatever
    ghost_newton says) on the mesh's halo and its fold, each group's
    domains in one batch. Plain torch on every device: the JAX package's
    sharded half paths are XLA only (minimd_tpu/parallel/step.py:265,438),
    so no sharded kernel runs there."""
    from ..config import FORCE_LJ
    from ..ops.pairgrid import halo_extent

    h = halo_extent(geom)
    lx, ly, lz = nb_local
    Ml = lx * ly * lz * geom.capacity
    lj = forcetype == FORCE_LJ
    if half_neigh:
        halo = Halo(geom, mesh, router, h, nb_local, dtype, wrap=True)
        if ghost_newton or not lj:       # the fold's tables, at set-up
            for g in range(len(router.groups)):
                halo.fold_table(g)
        if lj:
            from ..ops.lj_half import make_lj_force_half
            ev, noev = make_lj_force_half(geom, model, dtype,
                                          ghost_newton=ghost_newton,
                                          nb_local=nb_local, halo=halo)
        else:
            from ..ops.eam_half import make_eam_force_half
            ev, noev = make_eam_force_half(geom, model, dtype,
                                           nb_local=nb_local, halo=halo)

        def half_force(x, typ, evflag):
            return (ev if evflag else noev)(x, typ)

        half_force.halos = [halo]
        return half_force
    uniform = not lj or model.uniform
    paths = [sharded_force_path(forcetype, cuda=dev.type == "cuda",
                                dtype=dtype, reach=h, uniform=uniform)
             for dev, _ in router.groups]
    # the plain loops' halo (h cells on every axis), the kernels' (one
    # cell on the decomposed axes), each built only where a path reads it
    halo = (Halo(geom, mesh, router, h, nb_local, dtype, wrap=True)
            if not all(p.endswith("_cuda") for p in paths) else None)
    kernel_halo = (Halo(geom, mesh, router, 1, nb_local, dtype, wrap=False)
                   if any(p.endswith("_cuda") for p in paths) else None)
    dec = mesh.decomposed

    closures = []
    for (dev, _), path in zip(router.groups, paths):
        if path == "lj_cuda":
            from ..ops.lj_cuda import make_lj_force_cuda
            closures.append(make_lj_force_cuda(
                geom, model, dtype, dev, nb_local=nb_local, decomposed=dec))
        elif path == "eam_cuda":
            from ..ops.eam_cuda import make_eam_pair_cuda, make_eam_rho_cuda
            closures.append((
                make_eam_rho_cuda(geom, model, dtype, dev, nb_local=nb_local,
                                  decomposed=dec),
                make_eam_pair_cuda(geom, model, dtype, dev,
                                   nb_local=nb_local, decomposed=dec)))
        elif path == "eam_grid":
            from ..ops.eam_grid import make_eam_pair_grid, make_eam_rho_grid
            closures.append((
                make_eam_rho_grid(geom, model, dtype, dev, nb_local=nb_local,
                                  padded=True),
                make_eam_pair_grid(geom, model, dtype, dev,
                                   nb_local=nb_local, padded=True)))
        else:
            closures.append(None)

    def halo_of(path):
        return kernel_halo if path.endswith("_cuda") else halo

    def padded(x, cache):
        """Per group, the padded positions of its path's halo."""
        out = []
        for g, path in enumerate(paths):
            hl = halo_of(path)
            if hl not in cache:
                cache[hl] = hl.positions(x)
            out.append(cache[hl][g])
        return out

    def grids(flat, hl):
        """3 padded grids (or one, for a scalar field) of a flat row."""
        if flat.dim() == 1:
            return flat.reshape(hl.shape)
        return [flat[d].reshape(hl.shape) for d in range(3)]

    def lj_force(x, typ, evflag):
        from ..ops.lj_grid import lj_pair_loop

        X = padded(x, {})
        Tp = halo.scalars(typ) if not uniform else None
        fs, es, ws = [], [], []
        for g, ((dev, ks), path) in enumerate(zip(router.groups, paths)):
            f = torch.empty((len(ks), 3, Ml), dtype=dtype, device=dev)
            e, w = [], []
            if path == "lj_cuda":   # every domain of the device at once
                _, ei, wi = closures[g][0 if evflag else 1](X[g], None,
                                                           out=f)
                fs.append(f)
                es.append(ei if evflag else None)
                ws.append(wi if evflag else None)
                continue
            for i in range(len(ks)):
                fg, ei, wi = lj_pair_loop(
                    grids(X[g][i], halo), None if uniform
                    else grids(Tp[g][i], halo), geom, model, dtype, evflag,
                    nb_local=nb_local)
                f[i] = torch.stack([t.reshape(Ml) for t in fg])
                e.append(ei)
                w.append(wi)
            fs.append(f)
            es.append(torch.stack(e) if evflag else None)
            ws.append(torch.stack(w) if evflag else None)
        return fs, es, ws

    def eam_force(x, typ, evflag):
        del typ  # single-funcfl: every type pair shares the tables
        from ..cells import is_valid

        X = padded(x, {})
        fps, emb = [], []
        for g, ((dev, ks), path) in enumerate(zip(router.groups, paths)):
            rho_pass = closures[g][0]
            fp = torch.empty((len(ks), Ml), dtype=dtype, device=dev)
            if path == "eam_cuda":   # every domain of the device at once
                _, _, e = rho_pass(X[g], evflag, out=fp)
            else:
                e = []
                for i in range(len(ks)):
                    _, fp[i], ei = rho_pass(grids(X[g][i], halo),
                                            is_valid(x[g][i]), evflag)
                    e.append(ei)
                e = torch.stack(e) if evflag else None
            fps.append(fp)
            emb.append(e)
        # the fp halo between the passes (force_eam.cpp:851-887)
        fpp = {hl: hl.scalars(fps) for hl in {halo_of(p) for p in paths}}
        fs, es, ws = [], [], []
        for g, ((dev, ks), path) in enumerate(zip(router.groups, paths)):
            hl = halo_of(path)
            pair_pass = closures[g][1]
            f = torch.empty((len(ks), 3, Ml), dtype=dtype, device=dev)
            if path == "eam_cuda":   # every domain of the device at once
                _, p, w = pair_pass(X[g], fpp[hl][g], evflag, out=f)
            else:
                p, w = [], []
                for i in range(len(ks)):
                    f[i], pi, wi = pair_pass(grids(X[g][i], hl),
                                             grids(fpp[hl][g][i], hl), evflag)
                    p.append(pi)
                    w.append(wi)
                p, w = ((torch.stack(p), torch.stack(w)) if evflag
                        else (None, None))
            fs.append(f)
            if evflag:
                # eng_vdwl = 2*(sum F + 1/2 sum P) (force_eam.cpp:446)
                es.append(2.0 * (emb[g] + 0.5 * p))
                ws.append(w)
        return fs, es, ws

    force = lj_force if lj else eam_force
    force.halos = [hl for hl in (halo, kernel_halo) if hl is not None]
    return force


def make_sharded_run(force, exchange_rebin, router: Router, *, mass: float,
                     dt: float, dtforce: float, scales, natoms: int,
                     neigh_every: int, nstat: int, dtype):
    """run(state, ntimes, n0=0, end=None, timer=None, audit=None) ->
    (state, overflow, trace): the decomposed run loop, the counterpart of
    make_sharded_lj_run / make_sharded_eam_run, shaped as the port's
    Simulation._run: per step, over the device groups, the first kick and
    the drift; on reneighbor steps the migration; the halo and the force;
    the second kick. The cadences key on global step numbers n0 + n
    (reneighbor every neigh_every; energy and a thermo row on thermo
    steps and on step `end`, by default the last of this call). The rows
    come from the domains' energy, virial and sum v^2, reduced in domain
    order. trace (ntimes, 3) and overflow (3,) [movement, capacity,
    buffer] stay on the first group's device: the caller syncs once. The
    state's x and v are updated in place, so a caller that may replay
    passes a clone.

    timer: the phase timers of a timed run (the reference's
    integrate.cpp:101-192 stamps): the mesh's cards synchronized at every
    stamp, COMM the halo (and the half paths' folds), NEIGH the
    migration, FORCE the rest; the steps are run()'s, so are the bits.
    audit(x): called with the positions just before each migration.

    While a torch profiler records, each step opens the spans minimd.kick
    (the first kick and drift, then the second kick), minimd.migrate (the
    migration), minimd.force (with minimd.halo and minimd.fold, the Halo
    calls, inside it) and minimd.thermo (timer.py)."""
    tsc = mass * scales.t_scale
    dev0 = router.groups[0][0]
    cards = [d for d, _ in router.groups if d.type == "cuda"]

    def run(state, ntimes: int, n0: int = 0, end: int | None = None,
            timer=None, audit=None):
        end = n0 + ntimes - 1 if end is None else end
        span = spans()
        stamp = None
        if timer is not None:
            def stamp(which=None):
                for d in cards:
                    torch.cuda.synchronize(d)
                timer.stamp(which)
            stamp()
        for hl in force.halos:
            hl.stamp, hl.span = stamp, span
        try:
            out = loop(state, ntimes, n0, end, stamp, audit, span)
        finally:
            for hl in force.halos:
                hl.stamp, hl.span = None, no_span
        if stamp is not None:
            stamp(TIME_FORCE)
        return out

    def loop(state, ntimes, n0, end, stamp, audit, span):
        x, v, f, typ, valid = (list(getattr(state, k)) for k in
                               ("x", "v", "f", "typ", "valid"))
        G = len(x)
        trace = torch.zeros((ntimes, 3), dtype=dtype, device=dev0)
        ovf = [torch.zeros((len(ks), 3), dtype=torch.int32, device=d)
               for d, ks in router.groups]
        for n in range(ntimes):
            gstep = n0 + n
            with span("minimd.kick"):
                for g in range(G):
                    v[g].add_(f[g], alpha=dtforce)
                    x[g].add_(v[g], alpha=dt)
            if (gstep + 1) % neigh_every == 0:
                if audit is not None:
                    audit(x)
                if stamp is not None:
                    stamp(TIME_FORCE)
                with span("minimd.migrate"):
                    x, v, typ, valid, o = exchange_rebin(x, v, typ, valid)
                    ovf = [a + b for a, b in zip(ovf, o)]
                if stamp is not None:
                    stamp(TIME_NEIGH)
            if nstat > 0:
                ev = (gstep + 1) % nstat == 0 or gstep == end
            else:
                ev = gstep == end
            with span("minimd.force"):
                f, eng, vir = force(x, typ, ev)
            with span("minimd.kick"):
                for g in range(G):
                    v[g].add_(f[g], alpha=dtforce)
            if ev:
                with span("minimd.thermo"):
                    vsq = router.domain_sum([ordered_sum(
                        vg * vg, lead=1, dtype=torch.float64) for vg in v])
                    t = vsq * tsc
                    e = router.domain_sum(eng)
                    w = router.domain_sum(vir)
                    trace[n] = torch.stack([
                        t, e * scales.e_scale / natoms,
                        (t * scales.dof_boltz + w) * scales.p_scale]
                    ).to(dtype)
        from ..state import ShardedState
        return (ShardedState(x=x, v=v, f=f, typ=typ, valid=valid),
                router.domain_sum(ovf), trace)

    return run
