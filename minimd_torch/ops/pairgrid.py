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
with no counterpart here.
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
