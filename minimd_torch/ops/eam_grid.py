"""EAM force on the halo-padded cell grid with the polynomial pair tables:
the plain versions of the EAM kernels (ops/eam_cuda.py), in any dtype.

A torch port of minimd_tpu/ops/eam_grid.py with the arithmetic of the JAX
fused Pallas kernel (ops/eam_pallas.py), which tests/test_eam.py holds
against the same math:

  pass 1 (`make_eam_rho_grid`): rho_i = sum_j R(r_ij); fp_i = F'(rho_i)
          and, with evflag, the embed energy sum F(rho_i) (`embedding`)
  pass 2 (`make_eam_pair_grid`): fpair = -((fp_i + fp_j)*G1(r) + G2(r)),
          G1 = rhor'/r, G2 = z2r'/r^2 - z2r/r^3 (the 1/r factors absorbed,
          so no reciprocal), f_i += fpair*d; with evflag sum P(r) = z2r/r
          and the virial

The pair functions are eam_file.PairPolys: a polynomial body plus the
spline's own last rows as an exact tail, at f32 rounding scale against
the reference spline lookup (force_eam.cpp:152-158). The per-atom F(rho)
is the reference's spline-row gather. Every candidate lane is evaluated
(no branch), so the clamps of eval_pair_fns keep masked lanes finite.
"""

from __future__ import annotations

import torch

from ..cells import CellGeometry, is_valid
from ..eam_file import PairPolys
from .eam import EAMTables, eval_deriv, eval_value, spline_columns
from .pairgrid import halo_extent, pad_grid_int, stencil_slice, to_padded_soa


def horner(x, coeffs):
    """Descending-power polynomial evaluation; coeffs are python floats."""
    acc = torch.zeros_like(x) + coeffs[0]
    for c in coeffs[1:]:
        acc = acc * x + c
    return acc


def eval_pair_fns(r, polys: PairPolys, names):
    """Evaluate pair functions at r (any shape; out-of-range lanes, masked
    sentinels and r < lo, are clamped to the nearest valid value, never
    NaN/Inf). Returns {name: values}."""
    u = torch.clamp(r * polys.u_a + polys.u_b, -1.0, 1.0)
    # tail local coordinate: t in [0, nrows); row k covers t in [k, k+1).
    # Only the upper clamp is load-bearing (sentinel r would overflow the
    # row polynomials); r < split gives finite t values that the in_tail
    # select discards.
    t = torch.clamp(r, max=polys.cut) * polys.rdr + (1.0 - polys.m0)
    in_tail = r >= polys.split
    sels = None
    out = {}
    for name in names:
        val = horner(u, polys.body[name])
        merged = polys.tail_merged.get(name)
        if merged is not None:
            tv = horner(t, merged)
        else:
            if sels is None:  # row selects, shared by the unmerged names
                sels = [t < float(k + 1) for k in range(polys.nrows - 1)]
            tv = horner(t - float(polys.nrows - 1), polys.tail[name][-1])
            for k in range(polys.nrows - 2, -1, -1):
                tv = torch.where(sels[k],
                                 horner(t - float(k), polys.tail[name][k]), tv)
        out[name] = torch.where(in_tail, tv, val)
    return out


def embedding(rho, frho, rdrho: float, valid=None):
    """fp = F'(rho) per slot and, when `valid` is given, the embed energy
    sum of F(rho) over valid slots (else None): the reference's spline-row
    gather (force_eam.cpp:337-347). frho: spline_columns of the frho
    spline. One torch op per arithmetic step, so on the card every step
    rounds once, as the density kernel's epilogue does."""
    nrho = frho[0].shape[0] - 1
    p = rho * rdrho + 1.0
    m = torch.clamp(p.to(torch.int32), 1, nrho - 1).long()
    p = torch.clamp(p - m.to(rho.dtype), max=1.0)
    fp = eval_deriv(frho, m, p)
    if valid is None:
        return fp, None
    return fp, torch.where(valid, eval_value(frho, m, p), 0.0).sum()


def _pair_r(Xi, Xp, off, h, nb, cutsq, diag):
    d = [Xi[k] - stencil_slice(Xp[k], off, h, nb)[..., None, :]
         for k in range(3)]
    rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    mask = rsq < cutsq
    if off == (0, 0, 0):
        mask &= ~diag
    return d, rsq, torch.sqrt(rsq), mask


def _grid_setup(geom: CellGeometry, device):
    h = halo_extent(geom)
    offsets = [tuple(int(v) for v in o) for o in geom.stencil]
    diag = torch.eye(geom.capacity, dtype=torch.bool, device=device)
    return h, offsets, diag


def make_eam_rho_grid(geom: CellGeometry, tables: EAMTables,
                      dtype=torch.float32, device="cpu"):
    """The density pass: rho_pass(x, evflag) -> (rho (M,), fp (M,),
    embed energy sum, zero without evflag)."""
    nbx, nby, nbz = nb = geom.nb
    C, M = geom.capacity, geom.nslots
    h, offsets, diag = _grid_setup(geom, device)
    polys = tables.polys
    cutsq = tables.cut * tables.cut
    frho = spline_columns(tables.frho_spline, dtype, device)
    rdrho = 1.0 / tables.drho
    zero = torch.zeros((), dtype=dtype, device=device)

    def rho_pass(x, evflag: bool):
        Xp = to_padded_soa(x, geom, h)
        Xi = [stencil_slice(g, (0, 0, 0), h, nb)[..., :, None] for g in Xp]
        rho = torch.zeros((nbz, nby, nbx, C), dtype=dtype, device=device)
        for off in offsets:
            _, _, r, mask = _pair_r(Xi, Xp, off, h, nb, cutsq, diag)
            val = eval_pair_fns(r, polys, ("R",))["R"]
            rho = rho + torch.where(mask, val, 0.0).sum(dim=-1)
        rho = rho.reshape(M)
        fp, embed = embedding(rho, frho, rdrho,
                              is_valid(x) if evflag else None)
        return rho, fp, embed if evflag else zero

    return rho_pass


def make_eam_pair_grid(geom: CellGeometry, tables: EAMTables,
                       dtype=torch.float32, device="cpu"):
    """The force pass: pair_pass(x, fp, evflag) -> (f (3, M), sum P,
    virial), the last two zero without evflag."""
    nbx, nby, nbz = nb = geom.nb
    C, M = geom.capacity, geom.nslots
    h, offsets, diag = _grid_setup(geom, device)
    polys = tables.polys
    cutsq = tables.cut * tables.cut

    def pair_pass(x, fp, evflag: bool):
        Xp = to_padded_soa(x, geom, h)
        Xi = [stencil_slice(g, (0, 0, 0), h, nb)[..., :, None] for g in Xp]
        # fp halo (no coordinate shift): the reference's mid-force
        # communicate (force_eam.cpp:851-887)
        fp_pad = pad_grid_int(fp, geom, h)
        fp_i = stencil_slice(fp_pad, (0, 0, 0), h, nb)[..., :, None]
        f = [torch.zeros((nbz, nby, nbx, C), dtype=dtype, device=device)
             for _ in range(3)]
        eng = torch.zeros((), dtype=dtype, device=device)
        vir = torch.zeros((), dtype=dtype, device=device)
        names = ("G1", "G2", "P") if evflag else ("G1", "G2")
        for off in offsets:
            d, rsq, r, mask = _pair_r(Xi, Xp, off, h, nb, cutsq, diag)
            g = eval_pair_fns(r, polys, names)
            fp_j = stencil_slice(fp_pad, off, h, nb)[..., None, :]
            psip = (fp_i + fp_j) * g["G1"] + g["G2"]
            fpair = torch.where(mask, -psip, 0.0)
            for k in range(3):
                f[k] = f[k] + (fpair * d[k]).sum(dim=-1)
            if evflag:
                eng = eng + torch.where(mask, g["P"], 0.0).sum()
                vir = vir + 0.5 * torch.sum(rsq * fpair)
        fout = torch.stack([fd.reshape(M) for fd in f], dim=0)
        return fout, eng, vir

    return pair_pass


def two_pass_force(rho_pass, pair_pass):
    """(force_ev, force_noev): (x, typ) -> (f, eng_vdwl, virial) from the
    two passes; eng_vdwl = 2*(sum F + 1/2 sum P) (force_eam.cpp:446).
    force_noev returns eng = virial = 0."""
    def force(x, evflag: bool):
        _, fp, embed = rho_pass(x, evflag)
        f, eng, vir = pair_pass(x, fp, evflag)
        return f, 2.0 * (embed + 0.5 * eng), vir

    def force_ev(x, typ):
        del typ  # single-funcfl: all type pairs share the table
        return force(x, True)

    def force_noev(x, typ):
        del typ
        return force(x, False)

    return force_ev, force_noev


def make_eam_force_grid(geom: CellGeometry, tables: EAMTables,
                        dtype=torch.float32, device="cpu"):
    """(force_ev, force_noev) closures: (x, typ) -> (f, eng_vdwl, virial),
    the contract of minimd_tpu.ops.eam_grid.make_eam_force_grid."""
    return two_pass_force(make_eam_rho_grid(geom, tables, dtype, device),
                          make_eam_pair_grid(geom, tables, dtype, device))
