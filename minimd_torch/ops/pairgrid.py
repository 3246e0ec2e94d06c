"""Halo-padded cell-grid machinery of the plain pair-force path.

The plain kernels operate on a (Z+2h, Y+2h, X+2h, C) per-coordinate SoA
grid ("padded grid"): interior cells hold the atoms, halo cells hold
periodic images. Filling the halo is the reference's ghost-atom
`borders`/`communicate` (ref/comm.cpp:700-883) recast as slab copies, done
dim by dim (x, then y, then z) so corner images compose like the
reference's swap ordering (comm.cpp:739-867). With the halo in place,
every stencil lookup is a static slice.

The CUDA kernels read the raw grid with wrapped indices instead; the JAX
package's candidate lane pack (`fused_lane_pack`) is a TPU layout idiom
with no counterpart here. walk_candidates and kept_candidates, at the
end, mirror the order in which the CUDA pair kernels walk that grid and
the candidates they keep (csrc/cell_stage.cuh), for tests and counts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cells import CellGeometry


def halo_extent(geom: CellGeometry) -> int:
    """Stencil reach in cells (1 when binsize >= cutneigh)."""
    return int(np.abs(geom.stencil).max())


def to_padded_soa(x: torch.Tensor, geom: CellGeometry, h: int):
    """(3, M) flat cell-major positions -> 3 padded (Z+2h, Y+2h, X+2h, C)
    coordinate grids with periodic halo images."""
    nbx, nby, nbz = geom.nb
    C = geom.capacity
    return [_pad_halo(x[d].reshape(nbz, nby, nbx, C), h, float(geom.prd[d]), d)
            for d in range(3)]


def _pad_halo(g: torch.Tensor, h: int, prd_d: float, coord_dim: int):
    """Pad a (Z, Y, X, C) grid of coordinate `coord_dim` with a periodic
    halo of width h; images along the coordinate's own spatial axis
    (axis 2 - coord_dim) are shifted by ±prd."""
    own_axis = 2 - coord_dim
    for axis in (2, 1, 0):  # x first, then y, then z (reference swap order)
        n = g.shape[axis]
        lo = g.narrow(axis, n - h, h)
        hi = g.narrow(axis, 0, h)
        if axis == own_axis:
            lo = lo - prd_d
            hi = hi + prd_d
        g = torch.cat([lo, g, hi], dim=axis)
    return g


def pad_grid_int(t: torch.Tensor, geom: CellGeometry, h: int):
    """Pad a (M,) per-slot cell-major array (types, cell ids, channels)
    with a periodic halo; no coordinate shift."""
    nbx, nby, nbz = geom.nb
    g = t.reshape(nbz, nby, nbx, geom.capacity)
    for axis in (2, 1, 0):
        n = g.shape[axis]
        g = torch.cat([g.narrow(axis, n - h, h), g, g.narrow(axis, 0, h)],
                      dim=axis)
    return g


def stencil_slice(Ypad: torch.Tensor, off, h: int, nb):
    """Interior-aligned view of a padded grid at stencil offset
    (ox, oy, oz): result[c] = padded[c + off] for every interior cell c."""
    nbx, nby, nbz = nb
    ox, oy, oz = int(off[0]), int(off[1]), int(off[2])
    return Ypad[h + oz: h + oz + nbz,
                h + oy: h + oy + nby,
                h + ox: h + ox + nbx]


# --------------------------------------------------------------------------
# the CUDA pair kernels' pruned walk (csrc/cell_stage.cuh), plain mirror
# --------------------------------------------------------------------------

# cell_stage.cuh kKeepMargin: a candidate is kept when its squared
# distance to the own-atom box is at most cutsq * KEEP_MARGIN.
KEEP_MARGIN = 1.0 + 2.0 ** -10


def walk_candidates(geom: CellGeometry, x: torch.Tensor):
    """(cand, raw): cand (3, ncells, 27*C) the stencil's positions of every
    cell in the CUDA pair kernels' walk order (neighbor cells dz, dy, dx
    from -1 to 1, then slot), image shift added as the kernels add it; raw
    (ncells, 27*C) the same slots' stored x, which says which hold atoms.
    Needs stencil reach 1."""
    if halo_extent(geom) != 1 or len(geom.stencil) != 27:
        raise ValueError("the pair kernels' walk needs the 27-cell stencil")
    n, C = geom.ncells, geom.capacity
    Xp = to_padded_soa(x, geom, 1)
    Rp = pad_grid_int(x[0], geom, 1)

    def walk(g):
        return torch.stack([stencil_slice(g, off, 1, geom.nb)
                            for off in geom.stencil], dim=3).reshape(n, 27 * C)

    return torch.stack([walk(g) for g in Xp]), walk(Rp)


def kept_candidates(geom: CellGeometry, x: torch.Tensor, cutsq: float,
                    valid_below: float) -> torch.Tensor:
    """(ncells, 27*C) bool in walk order: the candidates that the pair
    kernels stage for each cell (the LJ pair loop at the LJ cutoff, the
    EAM kernels at theirs). A candidate is kept iff its stored x is below
    valid_below and its squared distance to the bounding box of the
    cell's valid own atoms (positions as stored), image shift added, is at
    most cutsq * KEEP_MARGIN, rounded in x's dtype as the kernels round
    in f32 (per axis max(lo - q, q - hi, 0), then (g0^2 + g1^2) + g2^2).
    A cell without atoms keeps none."""
    n, C = geom.ncells, geom.capacity
    cand, raw = walk_candidates(geom, x)
    own = x.reshape(3, n, C)
    valid = (own[0] < valid_below)[None]
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    lo = torch.where(valid, own, inf).amin(dim=2, keepdim=True)
    hi = torch.where(valid, own, -inf).amax(dim=2, keepdim=True)
    gap = torch.clamp_min(torch.maximum(lo - cand, cand - hi), 0.0)
    dsq = gap[0] * gap[0] + gap[1] * gap[1] + gap[2] * gap[2]
    cut = torch.tensor(cutsq, dtype=x.dtype) * KEEP_MARGIN
    return (raw < valid_below) & (dsq <= cut.to(x.device))
