"""Cell (bin) geometry and the binning pipeline, in PyTorch.

The host half (`CellGeometry` .. `_coords_to_cell_np`) is a numpy copy of
`minimd_tpu.cells` (which cannot be imported here because that module
imports jax), the same arithmetic without the mesh-only `multiple_of`
option. The layout it defines is the same:

- Atoms live in a fixed-capacity, cell-major padded layout: slot
  `cell*C + r` holds the r-th atom of `cell`; empty slots hold far-away
  sentinel positions so they fall out of every cutoff test naturally.
- The neighbor stencil (ref/neighbor.cpp:405-440 + bindist :456-482) is a
  per-cell candidate table `cand_cell` plus periodic image shifts
  `cand_shift`, computed once on the host.

The tensor half ports the sort-based `rebin` (initial placement),
`rebin_lean` (grids under 3 cells per axis) and the one-hot pull
`rebin_local` / `rebin_pull`, which is the plain version of the rebin
kernel in `ops/rebin_cuda.py`. The cell-id arithmetic follows the JAX
package op for op, so the f32 layout is bit-identical to it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_FACTOR = 0.999  # stencil safety factor (ref/neighbor.cpp:36 FACTOR)

# Sentinel coordinates for empty slots: far from the box and from each other,
# so empty-empty and empty-real pairs always fail the cutoff test.
_SENTINEL_BASE = 1.0e6
_SENTINEL_SPACING = 1.0e3


@dataclasses.dataclass(frozen=True)
class CellGeometry:
    """Static (host-side) cell decomposition of a periodic box."""

    nb: tuple[int, int, int]          # cells per dimension
    binsize: tuple[float, float, float]
    capacity: int                     # C: max atoms per cell (padded)
    stencil: np.ndarray               # (S, 3) int offsets
    cand_cell: np.ndarray             # (ncells, S) int32 candidate cell ids
    cand_shift: np.ndarray            # (ncells, S, 3) int8 periodic wrap counts
    prd: tuple[float, float, float]
    # Grid-origin offset: crystal planes can align exactly with cell
    # boundaries (the default FCC deck does), which doubles the max cell
    # occupancy. The offset de-aligns them; atoms that fall left of the
    # offset are stored "unfolded" at x+prd so each cell's contents stay
    # spatially contiguous and the stencil shifts remain valid.
    offset: tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def ncells(self) -> int:
        return self.nb[0] * self.nb[1] * self.nb[2]

    @property
    def nslots(self) -> int:
        return self.ncells * self.capacity

    @property
    def nstencil(self) -> int:
        return self.stencil.shape[0]


def _bindist_sq(off: np.ndarray, binsize: np.ndarray) -> np.ndarray:
    """Closest distance² between cell (0,0,0) and cell at integer offset.

    (ref/neighbor.cpp:456-482)
    """
    d = (np.abs(off) - 1).clip(min=0) * binsize
    return (d * d).sum(axis=-1)


def build_stencil(binsize: np.ndarray, cutneigh: float) -> np.ndarray:
    """Integer cell offsets whose closest corner is within cutneigh
    (full-list stencil, ref/neighbor.cpp:405-440)."""
    nxt = (cutneigh / binsize).astype(int)
    nxt += (nxt * binsize < _FACTOR * cutneigh).astype(int)
    rng = [np.arange(-n, n + 1) for n in nxt]
    dz, dy, dx = np.meshgrid(rng[2], rng[1], rng[0], indexing="ij")
    off = np.stack([dx.ravel(), dy.ravel(), dz.ravel()], axis=1)
    keep = _bindist_sq(off, binsize) < cutneigh * cutneigh
    return off[keep].astype(np.int32)


def choose_grid(prd, cutneigh: float, nbins=None) -> tuple[int, int, int]:
    """Default: largest grid with binsize >= cutneigh (27-cell stencil)."""
    if nbins is not None:
        return tuple(int(max(1, b)) for b in nbins)
    return tuple(int(max(1, np.floor(p / cutneigh))) for p in prd)


def autotune_grid(prd, cutneigh: float, positions: np.ndarray,
                  solid: bool = False):
    """Pick the cell grid minimizing the dense-kernel cost model
    ncells * nstencil * C * LANE over a few candidate resolutions, with the
    actual initial occupancy (see minimd_tpu.cells.autotune_grid).

    The cost keeps the JAX package's lane term (3C rounded up to 128, a
    TPU layout cost) so that both packages pick the same grid; whether
    the H100 kernels want another cost is an open decision in ROADMAP.
    The JAX version's `multiple_of` (mesh divisibility) waits for the
    multi-device port, which has its only callers."""
    prd = np.asarray(prd, dtype=np.float64)
    base = np.maximum(1, np.floor(prd / cutneigh).astype(int))
    best, best_cost = None, np.inf
    tried = set()
    for frac in (1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7, 0.65, 0.6):
        nb = tuple(int(max(1, np.floor(b * frac))) for b in base)
        if nb in tried:
            continue
        tried.add(nb)
        nbv = np.array(nb)
        binsize = prd / nbv
        stencil = build_stencil(binsize, cutneigh)
        offs = _best_offsets(np.asarray(positions), prd, nbv)
        ids = _coords_to_cell_np(positions, prd, nbv, binsize, offs)
        ncells = int(nbv.prod())
        counts = np.bincount(ids, minlength=ncells)
        cap = pick_capacity(counts, len(positions) / ncells, solid=solid)
        lane = -(-3 * cap // 128) * 128
        cost = ncells * len(stencil) * cap * lane / 3.0
        if cost < best_cost:
            best, best_cost = nb, cost
    return best


def pick_capacity(counts: np.ndarray, mean_density_per_cell: float,
                  nsamples: float = 4e6, solid: bool = False) -> int:
    """Cell capacity with headroom for density fluctuations over the run
    (extreme-value model, see minimd_tpu.cells.pick_capacity)."""
    mean = mean_density_per_cell
    base = int(counts.max())
    if solid and base == int(counts.min()):
        cap = base + max(4, base // 8)
    else:
        sigma = np.sqrt(max(mean, 1.0) * 0.1)
        expected_max = mean + sigma * np.sqrt(2.0 * np.log(nsamples))
        cap = int(np.ceil(max(base + 4, expected_max + 2.0 * sigma)))
    return ((cap + 7) // 8) * 8


# Capacity-growth policy of the overflow recovery (the reference's
# neighbor-bin resize semantics, neighbor.cpp:186-208,241-261).
MAX_CAPACITY = 4 * 128


def next_capacity(capacity: int) -> int:
    """Geometric growth, ~25% per retry."""
    return capacity + max(8, capacity // 4)


def _best_offsets(x: np.ndarray, prd: np.ndarray, nb: np.ndarray) -> np.ndarray:
    """Per-dimension grid offsets maximizing every atom's clearance from the
    nearest cell boundary."""
    offs = np.zeros(3)
    n = len(x)
    sample = x if n <= 65536 else x[:: n // 65536 + 1]
    for d in range(3):
        bs = prd[d] / nb[d]
        best, bestclear = 0.0, -1.0
        for frac in np.arange(16) / 16.0:
            off = frac * bs
            r = np.mod(sample[:, d] - off, bs)
            clear = np.minimum(r, bs - r).min()
            if clear > bestclear:
                best, bestclear = off, clear
        offs[d] = best
    return offs


def build_geometry(
    prd,
    cutneigh: float,
    positions: np.ndarray,
    nbins=None,
    capacity: int | None = None,
    solid: bool = False,
) -> CellGeometry:
    """Construct the static cell geometry for a box and initial positions."""
    prd = np.asarray(prd, dtype=np.float64)
    if nbins is None:
        nb = autotune_grid(prd, cutneigh, positions, solid=solid)
    else:
        nb = choose_grid(prd, cutneigh, nbins)
    nbx, nby, nbz = nb
    binsize = prd / np.array(nb, dtype=np.float64)
    stencil = build_stencil(binsize, cutneigh)
    ncells = nbx * nby * nbz

    cz, cy, cx = np.meshgrid(np.arange(nbz), np.arange(nby), np.arange(nbx),
                             indexing="ij")
    centers = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=1)
    tgt = centers[:, None, :] + stencil[None, :, :]
    nbv = np.array(nb)
    wraps = np.floor_divide(tgt, nbv)
    cell_xyz = tgt - wraps * nbv
    cand_cell = (cell_xyz[..., 2] * nby + cell_xyz[..., 1]) * nbx + cell_xyz[..., 0]
    offset = _best_offsets(np.asarray(positions), prd, nbv)
    if capacity is None:
        ids = _coords_to_cell_np(positions, prd, nbv, binsize, offset)
        counts = np.bincount(ids, minlength=ncells)
        mean_per_cell = len(positions) / ncells
        capacity = pick_capacity(counts, mean_per_cell, solid=solid)

    return CellGeometry(
        nb=(nbx, nby, nbz),
        binsize=tuple(binsize),
        capacity=int(capacity),
        stencil=stencil,
        cand_cell=cand_cell.astype(np.int32),
        cand_shift=wraps.astype(np.int8),
        prd=tuple(prd),
        offset=tuple(offset),
    )


def _coords_to_cell_np(x: np.ndarray, prd, nbv, binsize, offset=(0.0, 0.0, 0.0)) -> np.ndarray:
    xw = x - np.floor(x / prd) * prd
    g = xw - np.asarray(offset)
    g = np.where(g < 0, g + prd, g)
    idx = np.minimum((g / binsize).astype(np.int64), nbv - 1)
    return (idx[:, 2] * nbv[1] + idx[:, 1]) * nbv[0] + idx[:, 0]


# --------------------------------------------------------------------------
# tensor pieces
# --------------------------------------------------------------------------

def sentinel_positions(nslots: int, dtype, device) -> torch.Tensor:
    """(3, nslots) SoA sentinel coordinates for empty slots, computed in
    the working dtype (at 864k atoms the largest is ~1.44e9, where the f32
    ulp is 128: still distinct and far beyond any cutoff)."""
    base = (torch.arange(nslots, dtype=dtype, device=device) * _SENTINEL_SPACING
            + _SENTINEL_BASE)
    zero = torch.zeros_like(base)
    return torch.stack([base, zero, zero], dim=0)


def is_valid(x: torch.Tensor) -> torch.Tensor:
    """Occupancy recovered from the sentinel coordinates."""
    return x[0] < 0.5 * _SENTINEL_BASE


def _per_dim(vals, like: torch.Tensor) -> torch.Tensor:
    """(3, 1) column of per-dimension constants in x's dtype and device."""
    return torch.tensor(np.asarray(vals, dtype=np.float64),
                        dtype=like.dtype, device=like.device)[:, None]


def pbc_wrap(x: torch.Tensor, prd) -> torch.Tensor:
    """Wrap (3, M) coordinates into [0, prd) with the reference's two-test
    ordering guarantee (ref/atom.cpp:102-122)."""
    p = _per_dim(prd, x)
    x = torch.where(x < 0.0, x + p, x)
    return torch.where(x >= p, x - p, x)


def coord_to_cell(xw: torch.Tensor, geom: CellGeometry):
    """Cell id (row-major, x-fastest, int32) + storage ("unfolded")
    coordinates. Same ops, order and dtype as minimd_tpu.cells.coord_to_cell:
    g = xw - off; xs = where(g<0, xw+prd, xw); g = where(g<0, g+prd, g);
    idx = clip(int(g*inv), 0, nb-1) with inv = 1/binsize in the working
    dtype."""
    prd = _per_dim(geom.prd, xw)
    off = _per_dim(geom.offset, xw)
    inv = _per_dim(1.0 / np.asarray(geom.binsize), xw)
    nbm1 = torch.tensor([n - 1 for n in geom.nb], dtype=torch.int32,
                        device=xw.device)[:, None]
    g = xw - off
    neg = g < 0
    xs = torch.where(neg, xw + prd, xw)
    g = torch.where(neg, g + prd, g)
    idx = torch.minimum(torch.clamp((g * inv).to(torch.int32), min=0), nbm1)
    nbx, nby, _ = geom.nb
    return (idx[2] * nby + idx[1]) * nbx + idx[0], xs


def _sort_place(xs, v, typ, cid, geom: CellGeometry, extra=()):
    """Stable sort by cell id + scatter into the padded layout. cid ==
    ncells marks slots that are not placed. Returns the new (x, v, typ,
    *extra) and the number of atoms that did not fit their cell."""
    M, ncells, C = geom.nslots, geom.ncells, geom.capacity
    dev = xs.device
    order = torch.argsort(cid, stable=True)
    sort_cid = cid[order]
    starts = torch.searchsorted(
        sort_cid, torch.arange(ncells + 1, dtype=sort_cid.dtype, device=dev))
    rank = (torch.arange(M, dtype=torch.int64, device=dev)
            - starts[sort_cid.clamp(0, ncells).long()])
    placed = sort_cid < ncells
    ok = placed & (rank < C)
    dest = torch.where(ok, sort_cid.long() * C + rank, M)   # M = dropped

    def scatter(src, fill):
        # one spare column takes every dropped element, then is cut off
        out = torch.cat([fill, fill[..., :1]], dim=-1)
        out[..., dest] = src[..., order]
        return out[..., :M].contiguous()

    new_x = scatter(xs, sentinel_positions(M, xs.dtype, dev))
    new_v = scatter(v, torch.zeros((3, M), dtype=v.dtype, device=dev))
    new_t = scatter(typ, torch.zeros((M,), dtype=torch.int32, device=dev))
    new_extra = tuple(scatter(e, torch.zeros((M,), dtype=e.dtype, device=dev))
                      for e in extra)
    overflow = (placed & (rank >= C)).sum().to(torch.int32)
    return (new_x, new_v, new_t, *new_extra), overflow


def rebin(x, v, typ, valid, geom: CellGeometry):
    """Wrap PBC, stable-sort atoms into the cell-major padded layout
    (initial placement). Returns (x, v, typ, valid, overflow)."""
    xw = pbc_wrap(x, geom.prd)
    cid, xs = coord_to_cell(xw, geom)
    cid = torch.where(valid, cid, geom.ncells)
    (nx, nv, nt, nvalid), overflow = _sort_place(xs, v, typ, cid, geom,
                                                 extra=(valid,))
    return nx, nv, nt, nvalid, overflow


def rebin_lean(x, v, typ, geom: CellGeometry):
    """Sort-based rebin with validity recovered from the sentinels, for
    grids with fewer than 3 cells on an axis (where the ±1 pull would
    alias cells). Returns (x, v, typ, overflow)."""
    valid = is_valid(x)
    xw = pbc_wrap(x, geom.prd)
    cid, xs = coord_to_cell(xw, geom)
    cid = torch.where(valid, cid, geom.ncells)
    (nx, nv, nt), overflow = _sort_place(xs, v, typ, cid, geom)
    return nx, nv, nt, overflow


# (dx, dy, dz) pull offsets in rebin_local's order: dz outer, dy, dx inner
PULL_OFFSETS = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                for dx in (-1, 0, 1)]


def rebin_pull(cid, chans, geom: CellGeometry):
    """One-hot pull placement core, the plain version of the rebin kernel.

    cid: (M,) int32 per-slot cell id (-1 marks empty slots); chans: list of
    (M,) channels of any dtype to relocate. Each destination cell takes,
    over its 27-cell periodic neighborhood in PULL_OFFSETS order and slots
    ascending, the atoms whose new cell id equals it; the running rank
    carries across neighbor cells. Returns (outs, counts, cap_overflow):
    one (ncells, C) tensor per channel (zero on unfilled slots), per-cell
    occupancies, and the number of atoms that did not fit their cell."""
    from .ops.pairgrid import pad_grid_int, stencil_slice

    nb = geom.nb
    C, ncells = geom.capacity, geom.ncells
    dev = cid.device
    cid_pad = pad_grid_int(cid, geom, 1)
    chan_pad = [pad_grid_int(c, geom, 1) for c in chans]
    cell_ids = torch.arange(ncells, dtype=cid.dtype, device=dev)[:, None]
    outs = [torch.zeros(ncells * C, dtype=c.dtype, device=dev) for c in chans]
    base = torch.zeros((ncells, 1), dtype=torch.int64, device=dev)
    for off in PULL_OFFSETS:
        sel = stencil_slice(cid_pad, off, 1, nb).reshape(ncells, C) == cell_ids
        rank = base + torch.cumsum(sel, dim=-1) - 1
        put = sel & (rank < C)
        dest = (cell_ids.long() * C + rank)[put]
        for out, cp in zip(outs, chan_pad):
            out[dest] = stencil_slice(cp, off, 1, nb).reshape(ncells, C)[put]
        base = base + sel.sum(dim=-1, keepdim=True)
    counts = base[:, 0].to(torch.int32)
    cap_ovf = (counts - C).clamp(min=0).sum().to(torch.int32)
    return [o.reshape(ncells, C) for o in outs], counts, cap_ovf


def rebin_local(x, v, typ, geom: CellGeometry, pull=None):
    """Locality-aware rebin: every cell pulls its new occupants from its
    27-cell neighborhood (no global sort). Correctness rests on the skin
    guarantee: an atom moves at most one cell between rebinnings; atoms
    that moved further are counted in `overflow`, as are atoms that did not
    fit their cell. Needs min(nb) >= 3.

    pull(cid, chans) -> (outs, counts, cap_overflow) does the placement:
    the plain `rebin_pull` by default, the kernel wrapper of
    ops/rebin_cuda.py on the card. The elementwise prologue (wrap, cell
    id, movement guard) and epilogue (sentinels on unoccupied slots) are
    shared. Returns (x, v, typ, overflow)."""
    nbx, nby, nbz = geom.nb
    C, M = geom.capacity, geom.nslots
    dev = x.device

    valid = is_valid(x)
    xw = pbc_wrap(x, geom.prd)
    cid, xs = coord_to_cell(xw, geom)
    cid = torch.where(valid, cid, -1)

    # movement guard: new cell within +-1 (with wrap) of the slot's cell
    old = torch.arange(M, dtype=torch.int32, device=dev) // C
    new = cid.clamp(min=0)

    def near(a, b, n):
        d = (a - b).abs()
        return torch.minimum(d, n - d) <= 1

    ok = (near(old % nbx, new % nbx, nbx)
          & near((old // nbx) % nby, (new // nbx) % nby, nby)
          & near(old // (nbx * nby), new // (nbx * nby), nbz))
    overflow = (valid & ~ok).sum().to(torch.int32)

    chans = [xs[0], xs[1], xs[2], v[0], v[1], v[2], typ]
    if pull is None:
        outs, counts, cap_ovf = rebin_pull(cid, chans, geom)
    else:
        outs, counts, cap_ovf = pull(cid, chans)

    occ = (torch.arange(C, dtype=torch.int32, device=dev)[None, :]
           < counts[:, None]).reshape(M)
    sent = sentinel_positions(M, x.dtype, dev)
    new_x = torch.stack([torch.where(occ, outs[d].reshape(M), sent[d])
                         for d in range(3)])
    new_v = torch.stack([torch.where(occ, outs[3 + d].reshape(M), 0.0)
                         for d in range(3)])
    new_t = torch.where(occ, outs[6].reshape(M), 0)
    return new_x, new_v, new_t, overflow + cap_ovf
