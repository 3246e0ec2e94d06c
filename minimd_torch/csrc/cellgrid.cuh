// The cell walk shared by the pair kernels: eam_rows.cu walks it with
// for_each_neighbor and stage_positions and reduces per-cell partials
// with block_sum; the pruned stage (cell_stage.cuh) of the LJ and EAM
// pair kernels takes the same cells one by one with neighbor_cell, and
// they add their partials with warp_sum in block_sum's order.
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
  bool center;             // offset (0, 0, 0): the block's own cell
};

// Wrapped cell index of unwrapped index u on an axis of n cells (u in
// [-1, n]), and the image shift that goes with it.
__device__ __forceinline__ int wrap_cell(int u, int n, float prd,
                                         float* shift) {
  *shift = u < 0 ? -prd : (u >= n ? prd : 0.f);
  return u < 0 ? u + n : (u >= n ? u - n : u);
}

// Calls visit(NeighborCell) for the 27 neighbor cells of `cell`, in the
// order dz, dy, dx from -1 to 1.
template <class Visit>
__device__ __forceinline__ void for_each_neighbor(const CellGrid& g, int cell,
                                                  Visit&& visit) {
  const int cx = cell % g.nbx;
  const int cy = (cell / g.nbx) % g.nby;
  const int cz = cell / (g.nbx * g.nby);
  for (int dz = -1; dz <= 1; ++dz) {
    NeighborCell n;
    const int wz = wrap_cell(cz + dz, g.nbz, g.prdz, &n.shz);
    for (int dy = -1; dy <= 1; ++dy) {
      const int wy = wrap_cell(cy + dy, g.nby, g.prdy, &n.shy);
      for (int dx = -1; dx <= 1; ++dx) {
        const int wx = wrap_cell(cx + dx, g.nbx, g.prdx, &n.shx);
        n.base = (long long)((wz * g.nby + wy) * g.nbx + wx) * g.C;
        n.center = dx == 0 && dy == 0 && dz == 0;
        visit(n);
      }
    }
  }
}

// The k-th (0..26) of the cells that for_each_neighbor visits, in its
// order: k = (dz+1)*9 + (dy+1)*3 + (dx+1); k = 13 is the own cell.
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
  n.center = k == 13;
  return n;
}

// Copies the neighbor cell's C positions, image shift added, into shared
// memory (sx, sy, sz of C floats each); the block's threads stride over
// the slots. The caller brackets it with __syncthreads().
__device__ __forceinline__ void stage_positions(const CellGrid& g,
                                                const NeighborCell& n,
                                                float* sx, float* sy,
                                                float* sz) {
  for (int t = threadIdx.x; t < g.C; t += blockDim.x) {
    sx[t] = __ldg(g.x + n.base + t) + n.shx;
    sy[t] = __ldg(g.x + g.M + n.base + t) + n.shy;
    sz[t] = __ldg(g.x + 2 * g.M + n.base + t) + n.shz;
  }
}

// Sum of v over the warp in block_sum's order (its first stage); the
// result is valid in lane 0. A kernel whose one warp takes a cell's slots
// 32 at a time adds these group sums to 0 in group order, which is
// block_sum's order over the cell's slots rounded up to a warp.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block in a fixed order (warp shuffles, then the warp
// sums in warp order), so a partial repeats run to run. The result is
// valid in thread 0. blockDim.x is a multiple of 32, at most 1024.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float red[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) s += red[k];
  }
  __syncthreads();  // red may be written again by the next call
  return s;
}
