"""EAM (embedded-atom) tables and the exact-spline two-pass force: the
port's CPU path in any dtype, which the f64 goldens are held against.

A torch port of minimd_tpu/ops/eam.py (ref/force_eam.cpp:274-449,
compute_fullneigh) on the halo-padded cell grid of ops/pairgrid.py:

  pass 1: rho_i = sum_j rhor(r_ij); fp_i = F'(rho_i), embed energy F(rho_i)
  pass 2: psip = fp_i*rho' + fp_j*rho' + phi', phi = z2/r;
          fpair = -psip/r, f_i += fpair*d

Spline evaluation is the reference's exact idiom (force_eam.cpp:152-158):
p = r*rdr + 1; m = int(p) (clamped); cubic Horner on row m.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..cells import CellGeometry, is_valid
from ..eam_file import (PairPolys, PairRows, array2spline, build_pair_polys,
                        build_pair_rows, default_potential_path, file2array,
                        read_funcfl)
from ..thermo import ordered_sum
from .pairgrid import halo_extent, pad_grid_int, stencil_slice, to_padded_soa


@dataclasses.dataclass(frozen=True)
class EAMTables:
    mass: float
    cut: float
    nrho: int
    drho: float
    nr: int
    dr: float
    frho_spline: np.ndarray   # (nrho+1, 7)
    rhor_spline: np.ndarray   # (nr+1, 7)
    z2r_spline: np.ndarray    # (nr+1, 7)

    @staticmethod
    def from_funcfl(path=None) -> "EAMTables":
        f = read_funcfl(path or default_potential_path())
        nrho, drho, nr, dr, frho, rhor, z2r = file2array(f)
        return EAMTables(
            mass=f.mass, cut=f.cut, nrho=nrho, drho=drho, nr=nr, dr=dr,
            frho_spline=array2spline(nrho, drho, frho),
            rhor_spline=array2spline(nr, dr, rhor),
            z2r_spline=array2spline(nr, dr, z2r),
        )

    @functools.cached_property
    def polys(self) -> PairPolys:
        """The adaptive polynomial pair tables, fitted once per tables
        object (the fit runs Chebyshev fits over 200,001 points)."""
        return build_pair_polys(self)

    @functools.cached_property
    def rows(self) -> PairRows:
        """The gather tables (one cubic per piece), fitted once per tables
        object."""
        return build_pair_rows(self)


def spline_columns(sp: np.ndarray, dtype, device) -> list[torch.Tensor]:
    """The 7 coefficient columns of a (n+1, 7) spline as contiguous
    tensors (column k of row m is cols[k][m])."""
    return [torch.as_tensor(np.ascontiguousarray(sp[:, k]), dtype=dtype,
                            device=device) for k in range(7)]


def eval_deriv(cols, m, p):
    """(sp[m,0]*p + sp[m,1])*p + sp[m,2]: derivative part of a spline row."""
    return (cols[0][m] * p + cols[1][m]) * p + cols[2][m]


def eval_value(cols, m, p):
    """((sp[m,3]*p + sp[m,4])*p + sp[m,5])*p + sp[m,6]: value part."""
    return ((cols[3][m] * p + cols[4][m]) * p + cols[5][m]) * p + cols[6][m]


def make_eam_force(geom: CellGeometry, tables: EAMTables,
                   dtype=torch.float64, device="cpu"):
    """(x, typ) -> (f (3, M), eng_vdwl, virial), energy and virial always
    computed. Types are accepted for API parity: all pairs share one
    funcfl table, like the reference (force_eam.cpp:753-760)."""
    nbx, nby, nbz = nb = geom.nb
    C, M = geom.capacity, geom.nslots
    h = halo_extent(geom)
    offsets = [tuple(int(v) for v in o) for o in geom.stencil]
    diag = torch.eye(C, dtype=torch.bool, device=device)

    rhor = spline_columns(tables.rhor_spline, dtype, device)
    frho = spline_columns(tables.frho_spline, dtype, device)
    z2r = spline_columns(tables.z2r_spline, dtype, device)
    rdr, rdrho = 1.0 / tables.dr, 1.0 / tables.drho
    cutsq = tables.cut * tables.cut
    nr, nrho = tables.nr, tables.nrho

    def pairs(Xi, Xp, off):
        d = [Xi[k] - stencil_slice(Xp[k], off, h, nb)[..., None, :]
             for k in range(3)]
        rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        mask = rsq < cutsq
        if off == (0, 0, 0):
            mask &= ~diag
        r = torch.sqrt(torch.where(mask, rsq, 1.0))
        p = r * rdr + 1.0
        m = p.to(torch.int64).clamp_(max=nr - 1)
        p = torch.clamp(p - m.to(dtype), max=1.0)
        return d, rsq, mask, r, m, p

    def force(x, typ):
        del typ
        Xp = to_padded_soa(x, geom, h)
        Xi = [stencil_slice(g, (0, 0, 0), h, nb)[..., :, None] for g in Xp]

        rho = torch.zeros((nbz, nby, nbx, C), dtype=dtype, device=device)
        for off in offsets:
            _, _, mask, _, m, p = pairs(Xi, Xp, off)
            rho += torch.where(mask, eval_value(rhor, m, p), 0.0).sum(dim=-1)

        # fp = F'(rho), embed energy F(rho) (force_eam.cpp:337-347)
        p = rho.reshape(M) * rdrho + 1.0
        m = p.to(torch.int64).clamp_(1, nrho - 1)
        p = torch.clamp(p - m.to(dtype), max=1.0)
        fp = eval_deriv(frho, m, p)
        embed = ordered_sum(torch.where(is_valid(x), eval_value(frho, m, p),
                                        0.0))

        fp_pad = pad_grid_int(fp, geom, h)
        fp_i = stencil_slice(fp_pad, (0, 0, 0), h, nb)[..., :, None]
        f = [torch.zeros((nbz, nby, nbx, C), dtype=dtype, device=device)
             for _ in range(3)]
        eng = torch.zeros((), dtype=dtype, device=device)
        vir = torch.zeros((), dtype=dtype, device=device)
        for off in offsets:
            d, rsq, mask, r, m, p = pairs(Xi, Xp, off)
            rhoip = eval_deriv(rhor, m, p)
            z2p = eval_deriv(z2r, m, p)
            z2 = eval_value(z2r, m, p)
            recip = 1.0 / r
            phi = z2 * recip
            phip = z2p * recip - phi * recip
            fp_j = stencil_slice(fp_pad, off, h, nb)[..., None, :]
            psip = fp_i * rhoip + fp_j * rhoip + phip
            fpair = torch.where(mask, -psip * recip, 0.0)
            for k in range(3):
                f[k] += (fpair * d[k]).sum(dim=-1)
            vir = vir + 0.5 * ordered_sum(rsq * fpair)
            eng = eng + 0.5 * ordered_sum(torch.where(mask, phi, 0.0))

        fout = torch.stack([fd.reshape(M) for fd in f], dim=0)
        return fout, 2.0 * (embed + eng), vir    # force_eam.cpp:446

    return force
