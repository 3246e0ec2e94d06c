"""Half-neighbor LJ force: the parity option for the reference's
`--half_neigh 1` Newton path (ref/force_lj.cpp:185-263), a torch port of
minimd_tpu/ops/lj_half.py.

ghost_newton=True (the reference's default `-gn 1`): each unordered pair
is evaluated once. The stencil keeps the lexicographically positive
offsets (and an i < j mask in the own cell); the i side accumulates
normally and the j side into a halo-padded force grid, whose halo shells
are then folded back onto the opposite interior edges (fold_halo, the
reference's reverse_communicate, ref/comm.cpp:320-361).

ghost_newton=False (the reference's `-gn 0`, force_lj.cpp:239-249):
Newton's third law among own atoms only. Pairs whose j is a ghost (a halo
cell) are evaluated from both sides, the force lands on the own atom only
and the energy and virial count half (scale 0.5); no fold runs. Here: the
positive offsets keep their interior j-side accumulation and drop the halo
shells, and the negative offsets are evaluated masked to halo j cells.

The JAX half path is XLA with no Pallas kernel, so these torch operations
on the card's tensors are its whole port (no CUDA kernel is written for
it). Energy and virial come out in the full-neighbor convention downstream
code expects: eng pre-doubled (eng * 8 eps), virial the half sum
(force_lj.cpp:245-253 against :441-442).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cells import CellGeometry
from .lj import LJParams
from .pairgrid import halo_extent, stencil_slice, to_padded_soa


def positive_half(geom: CellGeometry) -> list[tuple[int, int, int]]:
    """The lexicographically positive stencil offsets (z, y, x precedence),
    the dense rendering of the reference's half-list skip rules
    (neighbor.cpp:154-157)."""
    return [tuple(int(v) for v in o) for o in geom.stencil
            if (o[2], o[1], o[0]) > (0, 0, 0)]


def fold_halo(g: torch.Tensor, h: int) -> torch.Tensor:
    """Add the halo shells of a padded (Z+2h, Y+2h, X+2h, C) grid onto the
    interior and return the interior, the reverse of the halo fill.

    The axis order (z, then y, then x) is the exact adjoint of the fill's
    x-then-y-then-z order (pairgrid._pad_halo), so edge and corner
    contributions travel the same hops in reverse, like the reference's
    swaps in reverse order (comm.cpp:324-327). Each axis folds
    periodically: the lo halo onto the top edge, the hi halo onto the
    bottom edge."""
    for axis in (0, 1, 2):
        n = g.shape[axis] - 2 * h
        lo, hi = g.narrow(axis, 0, h), g.narrow(axis, h + n, h)
        g = g.narrow(axis, h, n)
        top = g.narrow(axis, n - h, h) + lo
        bot = g.narrow(axis, 0, h) + hi
        g = torch.cat([bot, g.narrow(axis, h, n - 2 * h), top], dim=axis)
    return g


def ghost_cells(off, nb) -> np.ndarray:
    """(nbz, nby, nbx) bool: interior i cells whose j cell at stencil
    offset `off` lies outside the interior, i.e. the j atoms are ghosts
    (the reference's j >= nlocal test)."""
    ox, oy, oz = off
    nbx, nby, nbz = nb
    gz = (np.arange(nbz) + oz < 0) | (np.arange(nbz) + oz >= nbz)
    gy = (np.arange(nby) + oy < 0) | (np.arange(nby) + oy >= nby)
    gx = (np.arange(nbx) + ox < 0) | (np.arange(nbx) + ox >= nbx)
    return gz[:, None, None] | gy[None, :, None] | gx[None, None, :]


# The most (i, j) pair elements, offsets x cells x C x C, that one stacked
# batch of offsets evaluates. Each pair temporary of a batch is this many
# elements (128 MiB in float32), and a batch holds about ten at once; a
# batch is one offset at the least.
PAIR_BUDGET = 1 << 25


def offset_chunks(offs, geom: CellGeometry):
    """(start, offsets) for consecutive runs of `offs` of at most
    PAIR_BUDGET pair elements each: the small grids take the whole half
    stencil in one batch (few launches per step), the large ones loop over
    batches (bounded memory, as the JAX package's loop over offsets)."""
    k = max(1, PAIR_BUDGET // (geom.nslots * geom.capacity))
    return [(i, offs[i:i + k]) for i in range(0, len(offs), k)]


def stacked_slices(Xp, offs, h: int, nb) -> list[torch.Tensor]:
    """(len(offs), Z, Y, X, C) per padded grid: the interior-aligned
    views at every offset, stacked, so one elementwise launch covers a
    batch of offsets."""
    return [torch.stack([stencil_slice(g, off, h, nb) for off in offs])
            for g in Xp]


def j_slices(off, h: int, nb):
    """Where the j side of offset `off` lands in the padded grid."""
    ox, oy, oz = off
    nbx, nby, nbz = nb
    return (slice(h + oz, h + oz + nbz), slice(h + oy, h + oy + nby),
            slice(h + ox, h + ox + nbx))


def make_lj_force_half(geom: CellGeometry, params: LJParams,
                       dtype=torch.float32, device="cpu",
                       ghost_newton: bool = True):
    """(force_ev, force_noev) closures: (x, typ) -> (f (3, M), eng,
    virial), type-uniform parameters only (like the reference's Newton
    fast path). force_noev returns eng = virial = 0.

    The 13 positive offsets (and gn=0's 13 negative ones) are evaluated in
    stacked batches of offset_chunks: the same pair arithmetic as the JAX
    package's loop over offsets, in up to ~13x fewer launches."""
    if not params.uniform:
        raise ValueError("the half-neighbor path needs type-uniform LJ "
                         "parameters")
    nb = geom.nb
    nbx, nby, nbz = nb
    C, M = geom.capacity, geom.nslots
    h = halo_extent(geom)
    cutsq = float(params.cutforcesq[0])
    eps = float(params.epsilon[0])
    sig6 = float(params.sigma6[0])
    tri = torch.triu(torch.ones((C, C), dtype=torch.bool, device=device),
                     diagonal=1)
    half = positive_half(geom)
    neg = [(-o[0], -o[1], -o[2]) for o in half]
    half_chunks, neg_chunks = (offset_chunks(half, geom),
                               offset_chunks(neg, geom))
    # gn=0: the 0.5 energy/virial weight of ghost pairs at each positive
    # offset, and the ghost-j mask of each negative offset (static)
    scale = torch.as_tensor(
        np.stack([np.where(ghost_cells(o, nb), 0.5, 1.0) for o in half]),
        dtype=dtype, device=device)[..., None, None]
    gmask = torch.as_tensor(np.stack([ghost_cells(o, nb) for o in neg]),
                            device=device)[..., None, None]

    def pair(Xi, Yd, mask_extra=None):
        d = [Xi[c][..., :, None] - Yd[c][..., None, :] for c in range(3)]
        rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        mask = rsq < cutsq
        if mask_extra is not None:
            mask = mask & mask_extra
        m = mask.to(dtype)
        sr2 = m / (rsq + (1.0 - m))
        sr6 = sr2 * sr2 * sr2 * sig6
        fc = 48.0 * sr6 * (sr6 - 0.5) * sr2 * eps
        return d, rsq, sr6, fc, m

    def _force(x, evflag: bool):
        Xp = to_padded_soa(x, geom, h)
        Xi = [stencil_slice(g, (0, 0, 0), h, nb) for g in Xp]
        f = [torch.zeros((nbz, nby, nbx, C), dtype=dtype, device=x.device)
             for _ in range(3)]
        fpad = [torch.zeros(Xp[0].shape, dtype=dtype, device=x.device)
                for _ in range(3)]
        eng = torch.zeros((), dtype=dtype, device=x.device)
        vir = torch.zeros((), dtype=dtype, device=x.device)

        # the positive half: i side here, j side into the padded grid
        for lo, offs in half_chunks:
            d, rsq, sr6, fc, m = pair(Xi, stacked_slices(Xp, offs, h, nb))
            for c in range(3):
                fd = fc * d[c]
                f[c] += fd.sum(dim=-1).sum(dim=0)
                fj = fd.sum(dim=-2)
                for k, off in enumerate(offs):
                    fpad[c][j_slices(off, h, nb)] -= fj[k]
            if evflag:
                e_pair = sr6 * (sr6 - 1.0) * m
                v_pair = rsq * fc
                if not ghost_newton:
                    # gn=0: ghost pairs at 0.5 (force_lj.cpp:246-248); the
                    # other owner adds the other half
                    s = scale[lo:lo + len(offs)]
                    e_pair, v_pair = e_pair * s, v_pair * s
                eng = eng + torch.sum(e_pair)
                vir = vir + torch.sum(v_pair)

        if not ghost_newton:
            # gn=0: the pairs gn=1 receives through the fold are evaluated
            # here from this owner's side: the negative offsets, masked to
            # i cells whose j is a ghost (an interior j at a negative
            # offset is a pair already counted from the other cell). Force
            # on i only; energy and virial at the 0.5 ghost weight.
            for lo, offs in neg_chunks:
                d, rsq, sr6, fc, m = pair(
                    Xi, stacked_slices(Xp, offs, h, nb),
                    mask_extra=gmask[lo:lo + len(offs)])
                for c in range(3):
                    f[c] += (fc * d[c]).sum(dim=-1).sum(dim=0)
                if evflag:
                    eng = eng + 0.5 * torch.sum(sr6 * (sr6 - 1.0) * m)
                    vir = vir + 0.5 * torch.sum(rsq * fc)

        # own cell: i < j, both sides interior
        d, rsq, sr6, fc, m = pair(Xi, Xi, mask_extra=tri)
        for c in range(3):
            fd = fc * d[c]
            f[c] += fd.sum(dim=-1)
            f[c] -= fd.sum(dim=-2)
        if evflag:
            eng = eng + torch.sum(sr6 * (sr6 - 1.0) * m)
            vir = vir + torch.sum(rsq * fc)

        for c in range(3):
            if ghost_newton:
                # Newton's reverse communication: fold the halo back
                f[c] += fold_halo(fpad[c], h)
            else:
                # gn=0: j-side Newton among own atoms only; the halo
                # shells are dropped (integrate.cpp:188-193)
                f[c] += fpad[c][h:h + nbz, h:h + nby, h:h + nbx]

        fout = torch.stack([fc_.reshape(M) for fc_ in f], dim=0)
        # pre-doubled so the full-neighbor accounting downstream holds
        return fout, eng * (8.0 * eps), vir

    def force_ev(x, typ):
        return _force(x, True)

    def force_noev(x, typ):
        return _force(x, False)

    return force_ev, force_noev
