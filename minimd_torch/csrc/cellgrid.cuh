// The cell grid shared by the pair kernels: the pruned stage
// (cell_stage.cuh) of the LJ and EAM pair kernels takes a cell's 27
// neighbor cells one by one with neighbor_cell, and they add their
// per-cell partials with warp_sum in a fixed order.
//
// Positions are the raw cell-major (3, M) grid: slot cell*C + r holds the
// r-th atom of `cell`, empty slots hold far-away sentinels. A block owns
// one cell and walks its 27 neighbor cells dz, dy, dx. The neighbor cell
// is (c+off) mod nb and its periodic image shift floor((c+off)/nb)*prd is
// taken from the unwrapped index, so grids with nb < 3 on an axis (where
// offsets -1 and +1 are two images of one cell) stay right. Positions are
// read as stored (unfolded); nothing is wrapped again.
//
// The sharded form (a domain of a decomposed run, minimd_torch/parallel):
// an axis with its bit set in `halo` is stored with one halo cell on each
// side, filled by the halo exchange with its image shift already added,
// so cell c + d of that axis is read at stored index c + d + 1 with no
// shift. The kernels own the nbx*nby*nbz interior cells and write their
// outputs in the unpadded (interior) layout. With halo == 0 (one device)
// the stored grid is the interior and every index is as before.
#pragma once

#include <cuda_runtime.h>

struct CellGrid {
  const float* x;   // (3, M) positions, stored (halo axes padded)
  long long M;      // stored slots: the stored grid's cells * C
  int nbx, nby, nbz, C;   // the interior cells, which a launch owns
  float prdx, prdy, prdz;
  int halo;         // bit 0, 1, 2: axis x, y, z stored with a halo cell
};

// Stored slots of an interior of nb cells with the halo axes padded.
inline long long stored_slots(int nbx, int nby, int nbz, int C, int halo) {
  return (long long)(nbx + 2 * (halo & 1)) * (nby + 2 * ((halo >> 1) & 1)) *
         (nbz + 2 * ((halo >> 2) & 1)) * C;
}

struct NeighborCell {
  long long base;          // first slot of the (wrapped) neighbor cell
  float shx, shy, shz;     // periodic image shift added to its positions
};

// Wrapped cell index of unwrapped index u on an axis of n cells (u in
// [-1, n]), and the image shift that goes with it.
__device__ __forceinline__ int wrap_cell(int u, int n, float prd,
                                         float* shift) {
  *shift = u < 0 ? -prd : (u >= n ? prd : 0.f);
  return u < 0 ? u + n : (u >= n ? u - n : u);
}

// The stored index of unwrapped cell index u on an axis of n interior
// cells and its image shift: past a halo axis's interior the halo cell,
// no shift (the exchange added it); else wrap_cell's.
__device__ __forceinline__ int stored_cell(int u, int n, float prd,
                                          bool halo, float* shift) {
  if (halo) {
    *shift = 0.f;
    return u + 1;
  }
  return wrap_cell(u, n, prd, shift);
}

// The k-th (0..26) neighbor cell of interior `cell` in the walk's order,
// dz, dy, dx from -1 to 1: k = (dz+1)*9 + (dy+1)*3 + (dx+1); k = 13 is
// the own cell. SHARDED reads g.halo (the sharded form); without it the
// grid wraps on every axis and the code is the one-device kernels' as it
// was before the sharded form, so that their launches do not change.
template <bool SHARDED = false>
__device__ __forceinline__ NeighborCell neighbor_cell(const CellGrid& g,
                                                      int cell, int k) {
  const int cx = cell % g.nbx;
  const int cy = (cell / g.nbx) % g.nby;
  const int cz = cell / (g.nbx * g.nby);
  NeighborCell n;
  if constexpr (SHARDED) {
    const int sx = g.nbx + 2 * (g.halo & 1);
    const int sy = g.nby + 2 * ((g.halo >> 1) & 1);
    const int wz =
        stored_cell(cz + k / 9 - 1, g.nbz, g.prdz, g.halo & 4, &n.shz);
    const int wy =
        stored_cell(cy + (k / 3) % 3 - 1, g.nby, g.prdy, g.halo & 2, &n.shy);
    const int wx =
        stored_cell(cx + k % 3 - 1, g.nbx, g.prdx, g.halo & 1, &n.shx);
    n.base = (long long)((wz * sy + wy) * sx + wx) * g.C;
  } else {
    const int wz = wrap_cell(cz + k / 9 - 1, g.nbz, g.prdz, &n.shz);
    const int wy = wrap_cell(cy + (k / 3) % 3 - 1, g.nby, g.prdy, &n.shy);
    const int wx = wrap_cell(cx + k % 3 - 1, g.nbx, g.prdx, &n.shx);
    n.base = (long long)((wz * g.nby + wy) * g.nbx + wx) * g.C;
  }
  return n;
}

// The first stored slot of interior `cell` of a sharded grid (cell * C
// on one device).
__device__ __forceinline__ long long cell_base(const CellGrid& g, int cell) {
  return neighbor_cell<true>(g, cell, 13).base;
}

// Slots of the interior, the outputs' (3, .) row stride.
__device__ __forceinline__ long long interior_slots(const CellGrid& g) {
  return (long long)g.nbx * g.nby * g.nbz * g.C;
}

// The block's cell and domain in a launch over ndom domains of one
// device (blockIdx.x = dom * ncells + cell; dom 0 on one device), and
// the grid with x at that domain's positions, (ndom, 3, M) laid out.
struct DomainCell {
  CellGrid g;
  int cell;
  long long dom;
};

__device__ __forceinline__ DomainCell domain_cell(const CellGrid& g) {
  const int ncells = g.nbx * g.nby * g.nbz;
  DomainCell d{g, (int)(blockIdx.x % ncells), blockIdx.x / ncells};
  d.g.x += d.dom * 3 * g.M;
  return d;
}

// Sum of v over the warp, a shuffle tree in a fixed order; the result is
// valid in lane 0. A kernel whose one warp takes a cell's slots 32 at a
// time adds these group sums to 0 in group order, so a per-cell partial
// repeats run to run (and equals the first designs' block-wide sum over
// the cell's slots rounded up to a warp, which took the same order).
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}
