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

from ..cells import CellGeometry
from .lj import LJParams
from .pairgrid import halo_extent, pad_grid_int, stencil_slice, to_padded_soa


def lj_pair_loop(Xp, Tp, geom: CellGeometry, params: LJParams, dtype,
                 evflag: bool):
    """Dense stencil pair loop over padded coordinate grids.

    Xp: list of 3 padded (Z+2h, Y+2h, X+2h, C) coordinate grids.
    Tp: padded type grid (or None when parameters are type-uniform).
    Returns ([f0, f1, f2] interior force grids, eng, virial) with the raw
    full-neighbor sums already scaled (eng*4, virial*0.5).
    """
    nb = geom.nb
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
    for off in offsets:
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
        # sr2 == 0 for masked pairs, so every downstream term vanishes
        sr2 = torch.where(mask, rsq.reciprocal(), 0.0)
        sr6 = sr2 * sr2
        sr6.mul_(sr2).mul_(sig6)
        fc = sr6 * 48.0                    # 48*sr6*(sr6-0.5)*sr2*eps
        fc.mul_(sr6 - 0.5).mul_(sr2).mul_(eps)
        for k in range(3):
            f[k] += (fc * d[k]).sum(dim=-1)
        if evflag:
            eng = eng + torch.sum(sr6 * (sr6 - 1.0) * eps)
            vir = vir + torch.sum(rsq * fc)

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
