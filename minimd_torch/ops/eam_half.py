"""Half-neighbor EAM force: the parity option for the reference's
half-list EAM path (ref/force_eam.cpp:126-267, compute_halfneigh), a torch
port of minimd_tpu/ops/eam_half.py.

Each unordered pair is evaluated once, on the positive half of the
stencil plus an i < j mask in the own cell. Newton's third law is the
scatter-free rendering of ops/lj_half.py: the j side accumulates into
halo-padded grids whose halo shells fold back onto the periodic interior.
EAM folds twice: the pass-1 densities (the reference's reverse
communication of rho, force_eam.cpp:918-942) and the pass-2 forces
(comm.cpp:320-361).

The splines are evaluated with the reference's exact idiom
(force_eam.cpp:152-158) through ops/eam.py's eval_deriv/eval_value, so a
float64 run matches the full-stencil exact path up to summation order.
Energy and virial come out in the full-neighbor convention (eng =
2*(embed + half sum), virial = half sum; force_eam.cpp:446). Like the LJ
half path this is plain torch on the card, the whole port of the JAX
package's XLA half path (no Pallas kernel there).
"""

from __future__ import annotations

import torch

from ..cells import CellGeometry, is_valid
from .eam import EAMTables, eval_deriv, eval_value, spline_columns
from .lj_half import (fold_halo, j_slices, offset_chunks, positive_half,
                      stacked_slices)
from .pairgrid import halo_extent, pad_grid_int, stencil_slice, to_padded_soa


def make_eam_force_half(geom: CellGeometry, tables: EAMTables,
                        dtype=torch.float32, device="cpu"):
    """(force_ev, force_noev) closures: (x, typ) -> (f (3, M), eng_vdwl,
    virial). All type pairs share the one funcfl table, as in the
    reference (force_eam.cpp:753-760). force_noev returns eng = virial =
    0. The positive half of the stencil runs in the stacked batches of
    ops/lj_half.py's offset_chunks, in both passes."""
    nb = geom.nb
    nbx, nby, nbz = nb
    C, M = geom.capacity, geom.nslots
    h = halo_extent(geom)
    tri = torch.triu(torch.ones((C, C), dtype=torch.bool, device=device),
                     diagonal=1)
    chunks = [offs for _, offs in offset_chunks(positive_half(geom), geom)]

    rhor = spline_columns(tables.rhor_spline, dtype, device)
    frho = spline_columns(tables.frho_spline, dtype, device)
    z2r = spline_columns(tables.z2r_spline, dtype, device)
    rdr, rdrho = 1.0 / tables.dr, 1.0 / tables.drho
    cutsq = tables.cut * tables.cut
    nr, nrho = tables.nr, tables.nrho

    def spline_idx(rsq, mask):
        r = torch.sqrt(torch.where(mask, rsq, 1.0))
        p = r * rdr + 1.0
        m = p.to(torch.int64).clamp_(max=nr - 1)
        p = torch.clamp(p - m.to(dtype), max=1.0)
        return r, m, p

    def _force(x, evflag: bool):
        dev = x.device
        Xp = to_padded_soa(x, geom, h)
        Xi = [stencil_slice(g, (0, 0, 0), h, nb) for g in Xp]
        pshape = Xp[0].shape

        def pair(Yd, mask_extra=None):
            d = [Xi[c][..., :, None] - Yd[c][..., None, :] for c in range(3)]
            rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            mask = rsq < cutsq
            if mask_extra is not None:
                mask = mask & mask_extra
            return d, rsq, mask

        def batches():
            """(offsets, j positions, own-cell mask): the positive half in
            stacked batches, then the own cell (i < j; offsets None)."""
            for offs in chunks:
                yield offs, stacked_slices(Xp, offs, h, nb), None
            yield None, Xi, tri

        # pass 1: densities, both directions of each pair
        rho = torch.zeros((nbz, nby, nbx, C), dtype=dtype, device=dev)
        rho_pad = torch.zeros(pshape, dtype=dtype, device=dev)
        for offs, Yd, own in batches():
            _, rsq, mask = pair(Yd, own)
            _, m, p = spline_idx(rsq, mask)
            val = torch.where(mask, eval_value(rhor, m, p), 0.0)
            rj = val.sum(dim=-2)
            if offs is not None:
                rho += val.sum(dim=-1).sum(dim=0)
                for k, off in enumerate(offs):
                    rho_pad[j_slices(off, h, nb)] += rj[k]
            else:
                rho += val.sum(dim=-1)
                rho += rj
        # Newton reverse communication of the halo densities
        rho += fold_halo(rho_pad, h)

        # fp = F'(rho), embed energy F(rho) (force_eam.cpp:337-347)
        p = rho.reshape(M) * rdrho + 1.0
        m = p.to(torch.int64).clamp_(1, nrho - 1)
        p = torch.clamp(p - m.to(dtype), max=1.0)
        fp = eval_deriv(frho, m, p)
        if evflag:
            embed = torch.where(is_valid(x), eval_value(frho, m, p),
                                0.0).sum()
        # the fp halo: the reference's mid-force communicate
        # (force_eam.cpp:851)
        fp_pad = pad_grid_int(fp, geom, h)
        fp_i = stencil_slice(fp_pad, (0, 0, 0), h, nb)

        # pass 2: forces
        f = [torch.zeros((nbz, nby, nbx, C), dtype=dtype, device=dev)
             for _ in range(3)]
        fpad = [torch.zeros(pshape, dtype=dtype, device=dev)
                for _ in range(3)]
        eng = torch.zeros((), dtype=dtype, device=dev)
        vir = torch.zeros((), dtype=dtype, device=dev)
        for offs, Yd, own in batches():
            fp_j = fp_i if offs is None else torch.stack(
                [stencil_slice(fp_pad, off, h, nb) for off in offs])
            d, rsq, mask = pair(Yd, own)
            r, m, p = spline_idx(rsq, mask)
            rhoip = eval_deriv(rhor, m, p)
            z2p = eval_deriv(z2r, m, p)
            z2 = eval_value(z2r, m, p)
            recip = 1.0 / r
            phi = z2 * recip
            phip = z2p * recip - phi * recip
            psip = (fp_i[..., :, None] + fp_j[..., None, :]) * rhoip + phip
            fpair = torch.where(mask, -psip * recip, 0.0)
            for c in range(3):
                fd = fpair * d[c]
                fj = fd.sum(dim=-2)
                if offs is not None:
                    f[c] += fd.sum(dim=-1).sum(dim=0)
                    for k, off in enumerate(offs):
                        fpad[c][j_slices(off, h, nb)] -= fj[k]
                else:
                    f[c] += fd.sum(dim=-1)
                    f[c] -= fj
            if evflag:
                eng = eng + torch.sum(torch.where(mask, phi, 0.0))
                vir = vir + torch.sum(rsq * fpair)

        for c in range(3):
            f[c] += fold_halo(fpad[c], h)
        fout = torch.stack([fc.reshape(M) for fc in f], dim=0)
        if not evflag:
            return fout, eng, vir
        # full-neighbor convention downstream (force_eam.cpp:446): the
        # ordered-pair sum is twice the half sum
        return fout, 2.0 * (embed + eng), vir

    def force_ev(x, typ):
        return _force(x, True)

    def force_noev(x, typ):
        return _force(x, False)

    return force_ev, force_noev
