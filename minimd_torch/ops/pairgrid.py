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
the candidates they keep (csrc/cell_stage.cuh), for tests and counts;
verlet_lists mirrors the LJ kernel's Verlet list (csrc/lj_list.cu), and
drift_limit and drifted its check of how far atoms have moved since the
list was built.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cells import CellGeometry


def halo_extent(geom: CellGeometry) -> int:
    """Stencil reach in cells (1 when binsize >= cutneigh)."""
    return int(np.abs(geom.stencil).max())


def to_padded_soa(x, geom: CellGeometry, h: int, nb_local=None,
                  exchanges=None):
    """(3, M) flat cell-major positions -> 3 padded (Z+2h, Y+2h, X+2h, C)
    coordinate grids with halo images.

    One device: every axis is a periodic self-wrap. A spatially
    decomposed run (minimd_torch/parallel) passes `nb_local`, the
    domains' local grid shape, the list of every domain's (3, M_local)
    positions as x, and `exchanges[grid_axis](grids, coord_dim) -> [(lo,
    hi), ...]` for each decomposed axis (grid axes 0=z, 1=y, 2=x): the
    hook takes every domain's partially padded grid and returns each
    one's halo slabs, shifted where they cross the box (the reference's
    borders/communicate, comm.cpp:276-317,700-883, as in
    minimd_tpu/ops/pairgrid.py). The result is then one list of 3 grids
    per domain."""
    nbx, nby, nbz = nb_local if nb_local is not None else geom.nb
    C = geom.capacity
    xs = x if isinstance(x, (list, tuple)) else [x]
    grids = [_pad_halo([xd[d].reshape(nbz, nby, nbx, C) for xd in xs], h,
                       float(geom.prd[d]), d, exchanges) for d in range(3)]
    out = [[grids[d][k] for d in range(3)] for k in range(len(xs))]
    return out if isinstance(x, (list, tuple)) else out[0]


def _pad_halo(gs, h: int, prd_d: float, coord_dim, exchanges=None,
              wrap: bool = True):
    """Pad every (Z, Y, X, C) grid of gs (one per domain) with a halo of
    width h, axis by axis, x first, then y, then z (the reference's swap
    order, so corner images compose). An axis with an exchange hook takes
    its slabs from it; else, with `wrap`, a periodic self-wrap whose
    images along the coordinate's own spatial axis (2 - coord_dim) are
    shifted by +-prd (coord_dim None: no shift); without `wrap` the axis
    stays unpadded."""
    own_axis = None if coord_dim is None else 2 - coord_dim
    for axis in (2, 1, 0):
        if exchanges is not None and axis in exchanges:
            halos = exchanges[axis](gs, coord_dim)
        elif wrap:
            halos = []
            for g in gs:
                n = g.shape[axis]
                lo = g.narrow(axis, n - h, h)
                hi = g.narrow(axis, 0, h)
                if axis == own_axis:
                    lo = lo - prd_d
                    hi = hi + prd_d
                halos.append((lo, hi))
        else:
            continue
        gs = [torch.cat([lo, g, hi], dim=axis)
              for g, (lo, hi) in zip(gs, halos)]
    return gs


def pad_grid_int(t, geom: CellGeometry, h: int, nb_local=None,
                 exchanges=None):
    """Pad a (M,) per-slot cell-major array (types, fp, cell ids,
    channels) with a halo: periodic self-copies, or the slabs of the
    `exchanges` hooks on decomposed axes (as to_padded_soa, with t the
    list of every domain's array), never shifted."""
    nbx, nby, nbz = nb_local if nb_local is not None else geom.nb
    ts = t if isinstance(t, (list, tuple)) else [t]
    out = _pad_halo([a.reshape(nbz, nby, nbx, geom.capacity) for a in ts],
                    h, 0.0, None, exchanges)
    return out if isinstance(t, (list, tuple)) else out[0]


def sharded_grid(geom: CellGeometry, nb_local, decomposed):
    """(nb, halo bits, stored slots, interior slots) of the pair kernels:
    one device without nb_local; else a domain of nb_local cells stored
    with one halo cell on each side of the decomposed axes (x, y, z), the
    input that parallel/step.py's Halo(wrap=False) gives."""
    if nb_local is None:
        return geom.nb, 0, geom.nslots, geom.nslots
    dec = tuple(bool(d) for d in (decomposed or (False,) * 3))
    bits = sum(1 << a for a in range(3) if dec[a])
    C = geom.capacity
    stored = C * int(np.prod([n + 2 * d for n, d in zip(nb_local, dec)]))
    return tuple(nb_local), bits, stored, C * int(np.prod(nb_local))


def plain_padded(geom: CellGeometry, nb_local, decomposed, x, coord=True):
    """The kernels' padded input x ((3, stored) positions, or a (stored,)
    field with coord=False) completed to the plain pair loops' 1-cell
    halo on every axis: the undecomposed axes wrapped periodically, as
    the kernels wrap them (a position's own axis shifted by +-prd)."""
    dec = tuple(bool(d) for d in decomposed)
    shape = tuple(n + 2 * d for n, d in zip(nb_local, dec))[::-1] + (
        geom.capacity,)
    rows = [x[d] for d in range(3)] if coord else [x]
    out = []
    for d, row in enumerate(rows):
        g = row.reshape(shape)
        for axis in (2, 1, 0):
            if dec[2 - axis]:
                continue
            n = g.shape[axis]
            lo, hi = g.narrow(axis, n - 1, 1), g.narrow(axis, 0, 1)
            if coord and axis == 2 - d:
                lo = lo - float(geom.prd[d])
                hi = hi + float(geom.prd[d])
            g = torch.cat([lo, g, hi], dim=axis)
        out.append(g)
    return out if coord else out[0]


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


def verlet_lists(geom: CellGeometry, x: torch.Tensor, cutsq: float,
                 valid_below: float, chunk: int = 1024):
    """(entries, count): the Verlet list of each slot in the LJ kernel's
    layout (csrc/lj_list.cu): entries (K, M) int64, entry k of slot s at
    [k, s], the stencil indices nb*C + j (neighbor cell nb of the walk,
    slot j) of the candidates within the cutoff of the slot's atom, in
    walk order, -1 past its end; count (M,) int64 the lengths, 0 for a
    slot without an atom; K the longest (at least 1). A candidate is
    listed iff its stored x and the slot's are below valid_below, its
    rsq < cutsq rounded in x's dtype ((d0^2 + d1^2) + d2^2), and it is not
    the slot itself. Computed `chunk` cells at a time."""
    n, C = geom.ncells, geom.capacity
    W = 27 * C
    cand, raw = walk_candidates(geom, x)
    own = x.reshape(3, n, C)
    slot = torch.arange(C, device=x.device)
    walk = torch.arange(W, device=x.device)
    got = []
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(n, c0 + chunk))
        d = own[:, sl, :, None] - cand[:, sl, None, :]
        rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        near = ((rsq < cutsq) & (own[0, sl] < valid_below)[..., None]
                & (raw[sl] < valid_below)[:, None, :])
        near[:, slot, 13 * C + slot] = False       # the atom itself
        got.append(near.reshape(-1, W))
    near = torch.cat(got)
    count = near.sum(dim=1)
    # listed walk positions first, in walk order; the rest after them
    order = torch.where(near, walk, W + walk).sort(dim=1).values
    K = max(int(count.max()), 1) if len(count) else 1
    entries = torch.where(order[:, :K] < W, order[:, :K], -1)
    return entries.T.contiguous(), count


def listed_pairs(geom: CellGeometry, entries: torch.Tensor,
                 count: torch.Tensor) -> torch.Tensor:
    """(nbz, nby, nbx, C, 27*C) bool: which walk positions each slot's
    Verlet list (verlet_lists' entries and count) holds."""
    K, M = entries.shape
    W = 27 * geom.capacity
    listed = torch.zeros((M, W + 1), dtype=torch.bool, device=entries.device)
    live = torch.arange(K, device=entries.device)[:, None] < count[None, :]
    listed.scatter_(1, torch.where(live, entries, W).T, True)
    nbx, nby, nbz = geom.nb
    return listed[:, :W].reshape(nbz, nby, nbx, geom.capacity, W)


def drift_limit(cutneigh: float, cutforce: float) -> float:
    """How far an atom may move from where a Verlet list over cutneigh was
    built before the list may miss a pair inside cutforce: half the skin,
    less 2^-6 of it for the rounding of float32 positions (boxes up to
    ~10^4 sigma). At most 0: no list helps."""
    return 0.5 * (cutneigh - cutforce) * (1.0 - 2.0 ** -6)


def drifted(x: torch.Tensor, xref: torch.Tensor, limit: float,
            valid_below: float) -> bool:
    """Whether an atom of x (a slot below valid_below) lies farther than
    `limit` from its slot's position in xref, the check that the LJ
    kernel's force makes before it trusts its list."""
    d = x - xref
    dsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    return bool(((x[0] < valid_below) & (dsq > limit * limit)).any())
