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

#pragma once

#include <cuda_runtime.h>

struct CellGrid {
  const float* x;   // (3, M) positions
  long long M;      // ncells * C
  int nbx, nby, nbz, C;
  float prdx, prdy, prdz;
};

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

// The k-th (0..26) neighbor cell of `cell` in the walk's order, dz, dy,
// dx from -1 to 1: k = (dz+1)*9 + (dy+1)*3 + (dx+1); k = 13 is the own
// cell.
__device__ __forceinline__ NeighborCell neighbor_cell(const CellGrid& g,
                                                      int cell, int k) {
  const int cx = cell % g.nbx;
  const int cy = (cell / g.nbx) % g.nby;
  const int cz = cell / (g.nbx * g.nby);
  NeighborCell n;
  const int wz = wrap_cell(cz + k / 9 - 1, g.nbz, g.prdz, &n.shz);
  const int wy = wrap_cell(cy + (k / 3) % 3 - 1, g.nby, g.prdy, &n.shy);
  const int wx = wrap_cell(cx + k % 3 - 1, g.nbx, g.prdx, &n.shx);
  n.base = (long long)((wz * g.nby + wy) * g.nbx + wx) * g.C;
  return n;
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
