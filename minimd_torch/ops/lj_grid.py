"""Lennard-Jones force on the halo-padded cell grid: the plain version of
the LJ kernel (ops/lj_cuda.py) and the CPU path, in any dtype.

Per stencil offset, the candidate block of every interior cell is one
static slice of the padded grid; the pair interaction is a dense
(cells, C_i, C_j) computation in SoA layout. Kernel math is
ref/force_lj.cpp:420-430 (see ops/lj.py). Energy/virial follow the
reference's full-neighbor convention: raw ordered-pair sums, eng*4,
virial*0.5 (force_lj.cpp:441-442).
"""

from __future__ import annotations

import torch

from ..cells import VALID_BELOW, CellGeometry
from ..thermo import ordered_sum
from .lj import LJParams
from .pairgrid import (drift_limit, drifted, halo_extent, listed_pairs,
                       pad_grid_int, stencil_slice, to_padded_soa,
                       verlet_lists)


def lj_pair_loop(Xp, Tp, geom: CellGeometry, params: LJParams, dtype,
                 evflag: bool, nb_local=None, listed=None):
    """Dense stencil pair loop over padded coordinate grids.

    Xp: list of 3 padded (Z+2h, Y+2h, X+2h, C) coordinate grids.
    Tp: padded type grid (or None when parameters are type-uniform).
    nb_local: the interior's (X, Y, Z), a domain's local grid in a
    decomposed run (default geom.nb).
    listed: None, or (Z, Y, X, C, S*C) bool, the pairs a Verlet list holds
    (pairgrid.listed_pairs; stencil offset b at [..., b*C:(b+1)*C]): only
    those count.
    Returns ([f0, f1, f2] interior force grids, eng, virial) with the raw
    full-neighbor sums already scaled (eng*4, virial*0.5).
    """
    nb = tuple(nb_local) if nb_local is not None else geom.nb
    nbx, nby, nbz = nb
    C = geom.capacity
    h = halo_extent(geom)
    dev = Xp[0].device
    offsets = [tuple(int(v) for v in o) for o in geom.stencil]

    uniform = params.uniform
    nt = params.ntypes

    def table(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    eps_t, sig6_t, cutsq_t = (table(params.epsilon), table(params.sigma6),
                              table(params.cutforcesq))
    diag = torch.eye(C, dtype=torch.bool, device=dev)

    Xi = [stencil_slice(g, (0, 0, 0), h, nb)[..., :, None] for g in Xp]
    if not uniform:
        Ti = stencil_slice(Tp, (0, 0, 0), h, nb).long()

    f = [torch.zeros((nbz, nby, nbx, C), dtype=dtype, device=dev)
         for _ in range(3)]
    eng = torch.zeros((), dtype=dtype, device=dev)
    vir = torch.zeros((), dtype=dtype, device=dev)

    # in-place updates below reuse each (cells, C, C) temporary once more
    # instead of allocating the next one
    for b, off in enumerate(offsets):
        d = [Xi[k] - stencil_slice(Xp[k], off, h, nb)[..., None, :]
             for k in range(3)]
        rsq = d[0] * d[0]
        rsq.addcmul_(d[1], d[1]).addcmul_(d[2], d[2])

        if uniform:
            cutsq, eps, sig6 = cutsq_t[0], eps_t[0], sig6_t[0]
        else:
            Tj = stencil_slice(Tp, off, h, nb).long()
            pair = Ti[..., :, None] * nt + Tj[..., None, :]
            cutsq, eps, sig6 = cutsq_t[pair], eps_t[pair], sig6_t[pair]

        mask = rsq < cutsq
        if off == (0, 0, 0):
            mask &= ~diag
        if listed is not None:
            mask &= listed[..., b * C:(b + 1) * C]
        # sr2 == 0 for masked pairs, so every downstream term vanishes
        sr2 = torch.where(mask, rsq.reciprocal(), 0.0)
        sr6 = sr2 * sr2
        sr6.mul_(sr2).mul_(sig6)
        fc = sr6 * 48.0                    # 48*sr6*(sr6-0.5)*sr2*eps
        fc.mul_(sr6 - 0.5).mul_(sr2).mul_(eps)
        for k in range(3):
            f[k] += (fc * d[k]).sum(dim=-1)
        if evflag:
            eng = eng + ordered_sum(sr6 * (sr6 - 1.0) * eps)
            vir = vir + ordered_sum(rsq * fc)

    return f, eng * 4.0, vir * 0.5


def make_lj_force_grid(geom: CellGeometry, params: LJParams,
                       dtype=torch.float32, device="cpu"):
    """Closures (force_ev, force_noev): (x, typ) -> (f (3, M), eng, virial),
    periodic halo self-fill. force_noev returns eng = virial = 0."""
    M = geom.nslots
    h = halo_extent(geom)
    zero = torch.zeros((), dtype=dtype, device=device)

    def _force(x, typ, evflag: bool):
        Xp = to_padded_soa(x, geom, h)
        Tp = pad_grid_int(typ, geom, h) if not params.uniform else None
        f, eng, vir = lj_pair_loop(Xp, Tp, geom, params, dtype, evflag)
        fout = torch.stack([fd.reshape(M) for fd in f], dim=0)
        return (fout, eng, vir) if evflag else (fout, zero, zero)

    def force_ev(x, typ):
        return _force(x, typ, True)

    def force_noev(x, typ):
        return _force(x, typ, False)

    return force_ev, force_noev


def lj_list_force(geom: CellGeometry, params: LJParams, x, entries, count,
                  evflag: bool = True):
    """(f (3, M), eng, virial): the plain force over a Verlet list
    (pairgrid.verlet_lists' entries and count, in walk order), the mirror
    of the LJ kernel's force over its list (csrc/lj_list.cu): lj_pair_loop
    with only the listed pairs counted. While the list holds every pair
    inside the cutoff, it is make_lj_force_grid's force bit for bit.
    Type-uniform parameters, stencil reach 1."""
    Xp = to_padded_soa(x, geom, 1)
    f, eng, vir = lj_pair_loop(Xp, None, geom, params, x.dtype, evflag,
                               listed=listed_pairs(geom, entries, count))
    return torch.stack([fd.reshape(geom.nslots) for fd in f]), eng, vir


class KeptList:
    """The plain mirror of the Verlet list that the LJ kernel keeps over an
    interval (csrc/lj_list.cu): built at construction on x, and
    force(x, evflag) is lj_list_force over it, after a rebuild on x where
    an atom has moved past drift_limit since the last build (the card's
    check and repair; `repairs` counts them). So every call gives
    make_lj_force_grid's answer bit for bit. Type-uniform parameters,
    stencil reach 1, one layout."""

    def __init__(self, geom: CellGeometry, params: LJParams,
                 cutneigh: float, x: torch.Tensor):
        self.geom, self.params = geom, params
        self.cutneighsq = float(cutneigh) ** 2
        self.limit = drift_limit(cutneigh,
                                 float(params.cutforcesq[0]) ** 0.5)
        self.repairs = 0
        self._build(x)

    def _build(self, x):
        self.entries, self.count = verlet_lists(self.geom, x,
                                                self.cutneighsq, VALID_BELOW)
        self.xref = x.clone()

    def force(self, x: torch.Tensor, evflag: bool = True):
        if drifted(x, self.xref, self.limit, VALID_BELOW):
            self._build(x)
            self.repairs += 1
        return lj_list_force(self.geom, self.params, x, self.entries,
                             self.count, evflag)
