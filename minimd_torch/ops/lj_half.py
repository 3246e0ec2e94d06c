"""Half-neighbor LJ force: the parity option for the reference's
`--half_neigh 1` Newton path (ref/force_lj.cpp:185-263), a torch port of
minimd_tpu/ops/lj_half.py.

ghost_newton=True (the reference's default `-gn 1`): each unordered pair
is evaluated once. The stencil keeps the lexicographically positive
offsets (and an i < j mask in the own cell); the i side accumulates
normally and the j side into a halo-padded force grid, whose halo shells
are then folded back onto the cells they are images of (the reference's
reverse_communicate, ref/comm.cpp:320-361).

ghost_newton=False (the reference's `-gn 0`, force_lj.cpp:239-249):
Newton's third law among own atoms only. Pairs whose j is a ghost (a halo
cell) are evaluated from both sides, the force lands on the own atom only
and the energy and virial count half (scale 0.5); no fold runs. Here: the
positive offsets keep their interior j-side accumulation and drop the halo
shells, and the negative offsets are evaluated masked to halo j cells.

One device pads and folds periodically (PeriodicHalo: to_padded_soa and
fold_halo). A decomposed run (minimd_torch/parallel) passes its domains'
local grid and the mesh's halo (parallel/step.py Halo): the halo filled
from the neighbor domains on decomposed axes, and the fold its exact
adjoint, every padded slot's accumulation added onto the slot it is an
image of, in whichever domain owns it (the JAX package's `exchanges` and
`folds` hooks). The pair arithmetic runs over a leading axis of domains,
so a device's domains share each launch.

The JAX half path is XLA with no Pallas kernel, one device or sharded, so
these torch operations on the card's tensors are its whole port (no CUDA
kernel is written for it). Energy and virial come out in the
full-neighbor convention downstream code expects: eng pre-doubled (eng *
8 eps), virial the half sum (force_lj.cpp:245-253 against :441-442).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cells import CellGeometry
from ..thermo import ordered_sum
from .lj import LJParams
from .pairgrid import halo_extent, pad_grid_int, to_padded_soa


def positive_half(geom: CellGeometry) -> list[tuple[int, int, int]]:
    """The lexicographically positive stencil offsets (z, y, x precedence),
    the dense rendering of the reference's half-list skip rules
    (neighbor.cpp:154-157)."""
    return [tuple(int(v) for v in o) for o in geom.stencil
            if (o[2], o[1], o[0]) > (0, 0, 0)]


def fold_halo(g: torch.Tensor, h: int) -> torch.Tensor:
    """Add the halo shells of a padded (..., Z+2h, Y+2h, X+2h, C) grid onto
    the interior and return the interior, the reverse of the periodic halo
    fill; leading axes (domains, coordinates) ride along.

    The axis order (z, then y, then x) is the exact adjoint of the fill's
    x-then-y-then-z order (pairgrid._pad_halo), so edge and corner
    contributions travel the same hops in reverse, like the reference's
    swaps in reverse order (comm.cpp:324-327). Each axis folds
    periodically: the lo halo onto the top edge, the hi halo onto the
    bottom edge."""
    for axis in (-4, -3, -2):
        n = g.shape[axis] - 2 * h
        lo, hi = g.narrow(axis, 0, h), g.narrow(axis, h + n, h)
        g = g.narrow(axis, h, n)
        top = g.narrow(axis, n - h, h) + lo
        bot = g.narrow(axis, 0, h) + hi
        g = torch.cat([bot, g.narrow(axis, h, n - 2 * h), top], dim=axis)
    return g


class PeriodicHalo:
    """The halo of a one-device run in the interface of parallel/step.py's
    Halo: one group of one domain, every axis the periodic self-wrap
    (to_padded_soa, pad_grid_int), and fold its adjoint (fold_halo)."""

    def __init__(self, geom: CellGeometry, h: int, device):
        nbx, nby, nbz = geom.nb
        self.geom, self.h = geom, h
        self.shape = (nbz + 2 * h, nby + 2 * h, nbx + 2 * h, geom.capacity)
        self.groups = [(torch.device(device), [0])]

    def positions(self, xs):
        return [torch.stack(to_padded_soa(x[0], self.geom, self.h))
                .reshape(1, 3, -1) for x in xs]

    def scalars(self, ts):
        return [pad_grid_int(t[0], self.geom, self.h).reshape(1, -1)
                for t in ts]

    def fold(self, parts):
        return [fold_halo(p.reshape(p.shape[:-1] + self.shape),
                          self.h).reshape(p.shape[:-1] + (-1,))
                for p in parts]


def ghost_cells(off, nb) -> np.ndarray:
    """(nbz, nby, nbx) bool: interior i cells whose j cell at stencil
    offset `off` lies outside the interior, i.e. the j atoms are ghosts
    (the reference's j >= nlocal test; on a domain, periodic images and
    the neighbor domains' atoms alike). nb: the grid of one device, or of
    one domain."""
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


def offset_chunks(offs, geom: CellGeometry, nslots: int | None = None):
    """(start, offsets) for consecutive runs of `offs` of at most
    PAIR_BUDGET pair elements each over nslots own slots (default: the
    whole grid's; a device's domains: their slots together): the small
    grids take the whole half stencil in one batch (few launches per
    step), the large ones loop over batches (bounded memory, as the JAX
    package's loop over offsets)."""
    slots = geom.nslots if nslots is None else nslots
    k = max(1, PAIR_BUDGET // (slots * geom.capacity))
    return [(i, offs[i:i + k]) for i in range(0, len(offs), k)]


def cells_at(g: torch.Tensor, off, h: int, nb) -> torch.Tensor:
    """stencil_slice of each grid of a (B, Z+2h, Y+2h, X+2h, C) batch: the
    interior-aligned view at stencil offset (ox, oy, oz)."""
    ox, oy, oz = off
    nbx, nby, nbz = nb
    return g[:, h + oz: h + oz + nbz, h + oy: h + oy + nby,
             h + ox: h + ox + nbx]


def stacked_slices(Xp, offs, h: int, nb) -> list[torch.Tensor]:
    """(B, len(offs), Z, Y, X, C) per batch of padded grids: the
    interior-aligned views at every offset, stacked, so one elementwise
    launch covers a batch of offsets."""
    return [torch.stack([cells_at(g, off, h, nb) for off in offs], dim=1)
            for g in Xp]


def j_slices(off, h: int, nb):
    """Where the j side of offset `off` lands in a padded batch."""
    ox, oy, oz = off
    nbx, nby, nbz = nb
    return (slice(None), slice(h + oz, h + oz + nbz),
            slice(h + oy, h + oy + nby), slice(h + ox, h + ox + nbx))


def per_domain_sum(t: torch.Tensor) -> torch.Tensor:
    """(B,) the sum over every axis but the leading one, in an order that
    no CPU thread count changes."""
    return ordered_sum(t, lead=1)


def padded_grids(X: torch.Tensor, shape) -> list[torch.Tensor]:
    """The 3 coordinate grids (B, *shape) of (B, 3, nslots) positions."""
    return [X[:, d].reshape((X.shape[0],) + tuple(shape)) for d in range(3)]


def sharded_span_check(nb_local, decomposed, h: int):
    """The Newton fold of a decomposed run needs the halo within one
    neighbor domain on each decomposed axis (minimd_tpu/parallel/step.py
    _make_folds)."""
    for name, n, dec in zip("xyz", nb_local, decomposed):
        if dec and h > n:
            raise ValueError(
                f"the half-neighbor reverse fold needs a halo no wider than "
                f"a domain on mesh axis {name!r} (h={h}, span={n}); use "
                "full stencils (half_neigh=False) when the cutoff exceeds a "
                "domain")


def make_lj_force_half(geom: CellGeometry, params: LJParams,
                       dtype=torch.float32, device="cpu",
                       ghost_newton: bool = True, nb_local=None, halo=None):
    """(force_ev, force_noev) closures, type-uniform parameters only (like
    the reference's Newton fast path); force_noev returns eng = virial =
    0.

    One device: (x, typ) -> (f (3, M), eng, virial). Decomposed (nb_local
    and halo, parallel/step.py): (xs, typ) -> (fs, engs, virs), lists per
    device group of the mesh, xs and fs (Dg, 3, M_local), engs and virs
    (Dg,) the domains' partials; typ is unused (uniform parameters).

    The 13 positive offsets (and gn=0's 13 negative ones) are evaluated in
    stacked batches of offset_chunks over each group's domains: the same
    pair arithmetic as the JAX package's loop over offsets, in up to ~13x
    fewer launches."""
    if not params.uniform:
        raise ValueError("the half-neighbor path needs type-uniform LJ "
                         "parameters")
    h = halo_extent(geom)
    sharded = halo is not None
    nb = tuple(nb_local) if sharded else geom.nb
    if not sharded:
        halo = PeriodicHalo(geom, h, device)
    elif ghost_newton:
        sharded_span_check(nb, halo.decomposed, h)
    nbx, nby, nbz = nb
    C = geom.capacity
    Ml = nbx * nby * nbz * C
    cutsq = float(params.cutforcesq[0])
    eps = float(params.epsilon[0])
    sig6 = float(params.sigma6[0])
    half = positive_half(geom)
    neg = [(-o[0], -o[1], -o[2]) for o in half]
    # gn=0: the 0.5 energy/virial weight of ghost pairs at each positive
    # offset, and the ghost-j mask of each negative offset (static)
    scale = np.stack([np.where(ghost_cells(o, nb), 0.5, 1.0) for o in half])
    gmask = np.stack([ghost_cells(o, nb) for o in neg])
    groups = []
    for dev, ks in halo.groups:
        groups.append({
            "tri": torch.triu(torch.ones((C, C), dtype=torch.bool,
                                         device=dev), diagonal=1),
            "scale": torch.as_tensor(scale, dtype=dtype,
                                     device=dev)[..., None, None],
            "gmask": torch.as_tensor(gmask, device=dev)[..., None, None],
            "half": offset_chunks(half, geom, len(ks) * Ml),
            "neg": offset_chunks(neg, geom, len(ks) * Ml)})

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

    def group_pairs(X, evflag, k):
        """One group's padded positions (B, 3, nslots) -> f (B, Z, Y, X,
        C) and the padded j-side grids fpad per coordinate, eng, vir
        (B,)."""
        c_ = groups[k]
        B, dev = X.shape[0], X.device
        Xp = padded_grids(X, halo.shape)
        Xi = [cells_at(g, (0, 0, 0), h, nb) for g in Xp]
        Xb = [g[:, None] for g in Xi]        # against a batch of offsets
        f = [torch.zeros((B, nbz, nby, nbx, C), dtype=dtype, device=dev)
             for _ in range(3)]
        fpad = [torch.zeros(Xp[0].shape, dtype=dtype, device=dev)
                for _ in range(3)]
        eng = torch.zeros((B,), dtype=dtype, device=dev)
        vir = torch.zeros((B,), dtype=dtype, device=dev)

        # the positive half: i side here, j side into the padded grid
        for lo, offs in c_["half"]:
            d, rsq, sr6, fc, m = pair(Xb, stacked_slices(Xp, offs, h, nb))
            for c in range(3):
                fd = fc * d[c]
                f[c] += fd.sum(dim=-1).sum(dim=1)
                fj = fd.sum(dim=-2)
                for i, off in enumerate(offs):
                    fpad[c][j_slices(off, h, nb)] -= fj[:, i]
            if evflag:
                e_pair = sr6 * (sr6 - 1.0) * m
                v_pair = rsq * fc
                if not ghost_newton:
                    # gn=0: ghost pairs at 0.5 (force_lj.cpp:246-248); the
                    # other owner adds the other half
                    s = c_["scale"][lo:lo + len(offs)]
                    e_pair, v_pair = e_pair * s, v_pair * s
                eng = eng + per_domain_sum(e_pair)
                vir = vir + per_domain_sum(v_pair)

        if not ghost_newton:
            # gn=0: the pairs gn=1 receives through the fold are evaluated
            # here from this owner's side: the negative offsets, masked to
            # i cells whose j is a ghost (an interior j at a negative
            # offset is a pair already counted from the other cell). Force
            # on i only; energy and virial at the 0.5 ghost weight.
            for lo, offs in c_["neg"]:
                d, rsq, sr6, fc, m = pair(
                    Xb, stacked_slices(Xp, offs, h, nb),
                    mask_extra=c_["gmask"][lo:lo + len(offs)])
                for c in range(3):
                    f[c] += (fc * d[c]).sum(dim=-1).sum(dim=1)
                if evflag:
                    eng = eng + 0.5 * per_domain_sum(sr6 * (sr6 - 1.0) * m)
                    vir = vir + 0.5 * per_domain_sum(rsq * fc)

        # own cell: i < j, both sides interior
        d, rsq, sr6, fc, m = pair(Xi, Xi, mask_extra=c_["tri"])
        for c in range(3):
            fd = fc * d[c]
            f[c] += fd.sum(dim=-1)
            f[c] -= fd.sum(dim=-2)
        if evflag:
            eng = eng + per_domain_sum(sr6 * (sr6 - 1.0) * m)
            vir = vir + per_domain_sum(rsq * fc)
        return f, fpad, eng, vir

    def _force(xs, evflag: bool):
        out = [group_pairs(X, evflag, k)
               for k, X in enumerate(halo.positions(xs))]
        if ghost_newton:
            # Newton's reverse communication: fold the halo back
            folded = halo.fold([torch.stack(fpad, dim=1).reshape(
                len(fpad[0]), 3, -1) for _, fpad, _, _ in out])
        fs = []
        for k, (f, fpad, _, _) in enumerate(out):
            B = f[0].shape[0]
            if ghost_newton:
                fs.append(torch.stack(f, dim=1).reshape(B, 3, Ml)
                          + folded[k])
            else:
                # gn=0: j-side Newton among own atoms only; the halo
                # shells are dropped (integrate.cpp:188-193)
                fs.append(torch.stack([
                    f[c] + cells_at(fpad[c], (0, 0, 0), h, nb)
                    for c in range(3)], dim=1).reshape(B, 3, Ml))
        # pre-doubled so the full-neighbor accounting downstream holds
        return (fs, [eng * (8.0 * eps) for _, _, eng, _ in out],
                [vir for _, _, _, vir in out])

    if sharded:
        return (lambda xs, typ: _force(xs, True),
                lambda xs, typ: _force(xs, False))

    def one(x, evflag):
        fs, es, ws = _force([x[None]], evflag)
        return fs[0][0], es[0][0], ws[0][0]

    return lambda x, typ: one(x, True), lambda x, typ: one(x, False)
