"""Half-neighbor EAM force: the parity option for the reference's
half-list EAM path (ref/force_eam.cpp:126-267, compute_halfneigh), a torch
port of minimd_tpu/ops/eam_half.py.

Each unordered pair is evaluated once, on the positive half of the
stencil plus an i < j mask in the own cell. Newton's third law is the
scatter-free rendering of ops/lj_half.py: the j side accumulates into
halo-padded grids whose halo shells fold back onto the cells they are
images of. EAM folds twice: the pass-1 densities (the reference's reverse
communication of rho, force_eam.cpp:918-942) and the pass-2 forces
(comm.cpp:320-361). Between the passes the fp halo (force_eam.cpp:851)
fills the padded fp grid. One device pads and folds periodically; a
decomposed run passes its domains' local grid and the mesh's halo, whose
fold is the exact adjoint of its fill (ops/lj_half.py), and the pair
arithmetic runs over a leading axis of a device's domains.

The splines are evaluated with the reference's exact idiom
(force_eam.cpp:152-158) through ops/eam.py's eval_deriv/eval_value, so a
float64 run matches the full-stencil exact path up to summation order.
Energy and virial come out in the full-neighbor convention (eng =
2*(embed + half sum), virial = half sum; force_eam.cpp:446). Like the LJ
half path this is plain torch on the card, the whole port of the JAX
package's XLA half path (no Pallas kernel there, one device or sharded).
"""

from __future__ import annotations

import torch

from ..cells import CellGeometry, is_valid
from .eam import EAMTables, eval_deriv, eval_value, spline_columns
from .lj_half import (PeriodicHalo, cells_at, j_slices, offset_chunks,
                      padded_grids, per_domain_sum, positive_half,
                      sharded_span_check, stacked_slices)
from .pairgrid import halo_extent


def make_eam_force_half(geom: CellGeometry, tables: EAMTables,
                        dtype=torch.float32, device="cpu", nb_local=None,
                        halo=None):
    """(force_ev, force_noev) closures. All type pairs share the one
    funcfl table, as in the reference (force_eam.cpp:753-760). force_noev
    returns eng = virial = 0.

    One device: (x, typ) -> (f (3, M), eng_vdwl, virial). Decomposed
    (nb_local and halo, parallel/step.py): (xs, typ) -> (fs, engs, virs),
    lists per device group, as ops/lj_half.py's. The positive half of the
    stencil runs in the stacked batches of offset_chunks, in both
    passes."""
    h = halo_extent(geom)
    sharded = halo is not None
    nb = tuple(nb_local) if sharded else geom.nb
    if not sharded:
        halo = PeriodicHalo(geom, h, device)
    else:
        sharded_span_check(nb, halo.decomposed, h)
    nbx, nby, nbz = nb
    C = geom.capacity
    Ml = nbx * nby * nbz * C
    half = positive_half(geom)
    rdr, rdrho = 1.0 / tables.dr, 1.0 / tables.drho
    cutsq = tables.cut * tables.cut
    nr, nrho = tables.nr, tables.nrho
    groups = []
    for dev, ks in halo.groups:
        groups.append({
            "tri": torch.triu(torch.ones((C, C), dtype=torch.bool,
                                         device=dev), diagonal=1),
            "chunks": [offs for _, offs in
                       offset_chunks(half, geom, len(ks) * Ml)],
            "rhor": spline_columns(tables.rhor_spline, dtype, dev),
            "frho": spline_columns(tables.frho_spline, dtype, dev),
            "z2r": spline_columns(tables.z2r_spline, dtype, dev)})

    def spline_idx(rsq, mask):
        r = torch.sqrt(torch.where(mask, rsq, 1.0))
        p = r * rdr + 1.0
        m = p.to(torch.int64).clamp_(max=nr - 1)
        p = torch.clamp(p - m.to(dtype), max=1.0)
        return r, m, p

    def pair(Xi, Yd, mask_extra=None):
        d = [Xi[c][..., :, None] - Yd[c][..., None, :] for c in range(3)]
        rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        mask = rsq < cutsq
        if mask_extra is not None:
            mask = mask & mask_extra
        return d, rsq, mask

    def batches(Xp, Xi, k):
        """(offsets, i positions, j positions, own-cell mask): the positive
        half in stacked batches, then the own cell (i < j; offsets
        None)."""
        Xb = [g[:, None] for g in Xi]
        for offs in groups[k]["chunks"]:
            yield offs, Xb, stacked_slices(Xp, offs, h, nb), None
        yield None, Xi, Xi, groups[k]["tri"]

    def density(Xp, k):
        """Pass 1 of one group: the densities of its own slots and the
        padded j-side densities."""
        Xi = [cells_at(g, (0, 0, 0), h, nb) for g in Xp]
        rho = torch.zeros(Xi[0].shape, dtype=dtype, device=Xi[0].device)
        rho_pad = torch.zeros(Xp[0].shape, dtype=dtype, device=rho.device)
        for offs, Xa, Yd, own in batches(Xp, Xi, k):
            _, rsq, mask = pair(Xa, Yd, own)
            _, m, p = spline_idx(rsq, mask)
            val = torch.where(mask, eval_value(groups[k]["rhor"], m, p), 0.0)
            rj = val.sum(dim=-2)
            if offs is not None:
                rho += val.sum(dim=-1).sum(dim=1)
                for i, off in enumerate(offs):
                    rho_pad[j_slices(off, h, nb)] += rj[:, i]
            else:
                rho += val.sum(dim=-1)
                rho += rj
        return rho.reshape(len(rho), Ml), rho_pad.reshape(len(rho), -1)

    def forces(Xp, fp_pad, k, evflag):
        """Pass 2 of one group: the forces on its own slots, the padded
        j-side forces (B, 3, nslots), and the pair energy and virial."""
        c_ = groups[k]
        Xi = [cells_at(g, (0, 0, 0), h, nb) for g in Xp]
        B, dev = Xi[0].shape[0], Xi[0].device
        fp_g = fp_pad.reshape((B,) + tuple(halo.shape))
        fp_i = cells_at(fp_g, (0, 0, 0), h, nb)
        f = [torch.zeros(Xi[0].shape, dtype=dtype, device=dev)
             for _ in range(3)]
        fpad = [torch.zeros(Xp[0].shape, dtype=dtype, device=dev)
                for _ in range(3)]
        eng = torch.zeros((B,), dtype=dtype, device=dev)
        vir = torch.zeros((B,), dtype=dtype, device=dev)
        for offs, Xa, Yd, own in batches(Xp, Xi, k):
            fp_a, fp_j = (fp_i, fp_i) if offs is None else (
                fp_i[:, None], torch.stack(
                    [cells_at(fp_g, off, h, nb) for off in offs], dim=1))
            d, rsq, mask = pair(Xa, Yd, own)
            r, m, p = spline_idx(rsq, mask)
            rhoip = eval_deriv(c_["rhor"], m, p)
            z2p = eval_deriv(c_["z2r"], m, p)
            z2 = eval_value(c_["z2r"], m, p)
            recip = 1.0 / r
            phi = z2 * recip
            phip = z2p * recip - phi * recip
            psip = (fp_a[..., :, None] + fp_j[..., None, :]) * rhoip + phip
            fpair = torch.where(mask, -psip * recip, 0.0)
            for c in range(3):
                fd = fpair * d[c]
                fj = fd.sum(dim=-2)
                if offs is not None:
                    f[c] += fd.sum(dim=-1).sum(dim=1)
                    for i, off in enumerate(offs):
                        fpad[c][j_slices(off, h, nb)] -= fj[:, i]
                else:
                    f[c] += fd.sum(dim=-1)
                    f[c] -= fj
            if evflag:
                eng = eng + per_domain_sum(torch.where(mask, phi, 0.0))
                vir = vir + per_domain_sum(rsq * fpair)
        return (torch.stack(f, dim=1).reshape(B, 3, Ml),
                torch.stack(fpad, dim=1).reshape(B, 3, -1), eng, vir)

    def _force(xs, evflag: bool):
        Xps = [padded_grids(X, halo.shape) for X in halo.positions(xs)]
        # pass 1: densities, both directions of each pair
        dens = [density(Xp, k) for k, Xp in enumerate(Xps)]
        # Newton reverse communication of the halo densities
        folded = halo.fold([rho_pad for _, rho_pad in dens])
        fps, embed = [], []
        for k, ((rho, _), extra) in enumerate(zip(dens, folded)):
            # fp = F'(rho), embed energy F(rho) (force_eam.cpp:337-347)
            frho = groups[k]["frho"]
            p = (rho + extra) * rdrho + 1.0
            m = p.to(torch.int64).clamp_(1, nrho - 1)
            p = torch.clamp(p - m.to(dtype), max=1.0)
            fps.append(eval_deriv(frho, m, p))
            if evflag:
                valid = is_valid(xs[k].transpose(0, 1))
                embed.append(per_domain_sum(torch.where(
                    valid, eval_value(frho, m, p), 0.0)))
        # the fp halo: the reference's mid-force communicate
        # (force_eam.cpp:851)
        out = [forces(Xp, fp_pad, k, evflag) for k, (Xp, fp_pad) in
               enumerate(zip(Xps, halo.scalars(fps)))]
        folded = halo.fold([fpad for _, fpad, _, _ in out])
        fs = [f + extra for (f, _, _, _), extra in zip(out, folded)]
        if not evflag:
            return fs, [e for _, _, e, _ in out], [w for _, _, _, w in out]
        # full-neighbor convention downstream (force_eam.cpp:446): the
        # ordered-pair sum is twice the half sum
        return (fs, [2.0 * (em + e) for (_, _, e, _), em in zip(out, embed)],
                [w for _, _, _, w in out])

    if sharded:
        return (lambda xs, typ: _force(xs, True),
                lambda xs, typ: _force(xs, False))

    def one(x, evflag):
        fs, es, ws = _force([x[None]], evflag)
        return fs[0][0], es[0][0], ws[0][0]

    return lambda x, typ: one(x, True), lambda x, typ: one(x, False)
