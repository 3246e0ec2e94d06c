// LJ full-neighbor cell-grid force for Hopper (sm_90a).
//
// Replaces: minimd_tpu/ops/lj_pallas.py, _make_lj_force_pallas_fused (the
// Pallas kernel body `kernel`, one program per (z, y) cell row over a
// lane-packed [x-1 | x | x+1] candidate block).
//
// What bounds it on the H100: arithmetic, not memory. Each atom meets the
// 27*C candidates of its stencil (C = 40..48 on the shipped decks, ~15% of
// them inside the cutoff), ~10 FP32 operations per candidate plus an IEEE
// divide per pair inside the cutoff, while every coordinate is read from
// device memory once per neighboring cell (27x reuse out of L2). At 864k
// atoms that is ~1.6e9 candidate pairs per call against 1.7 MB of
// positions.
//
// What this simple design does about it: one block per cell, one thread
// per own slot i (blockDim = C rounded up to a warp). The 27 neighbor cells
// are walked dz, dy, dx; each one's C coordinates are staged once in
// shared memory, with the periodic image shift already added, and every
// thread of the block reads them as broadcasts (the walk and the staging
// are cellgrid.cuh's, shared with the EAM kernels). Each thread sums its
// own atom's force (full-neighbor convention): no atomics, deterministic.
// With EV, energy and virial are reduced per block in a fixed order into
// one partial per cell; the wrapper sums the partials with torch.sum.
//
// Not done yet (later work): the approximate reciprocal, several cells
// per block for C well below a multiple of 32, TMA staging, CUDA graphs.

#include <cuda_runtime.h>

#include "cellgrid.cuh"

namespace {

template <bool EV>
__global__ void lj_force_kernel(const __grid_constant__ CellGrid g,
                                float* __restrict__ f,
                                float* __restrict__ eng_part,
                                float* __restrict__ vir_part, float cutsq,
                                float eps48, float eps24, float sig6,
                                float eng_scale) {
  extern __shared__ float stage[];  // 3*C: candidate x | y | z
  const int C = g.C;
  const long long M = g.M;
  float* sx = stage;
  float* sy = stage + C;
  float* sz = stage + 2 * C;

  const int cell = blockIdx.x;
  const int i = threadIdx.x;
  const bool own = i < C;
  const long long si = (long long)cell * C + i;

  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (own) {
    xi = g.x[si];
    yi = g.x[M + si];
    zi = g.x[2 * M + si];
  }
  float fx = 0.f, fy = 0.f, fz = 0.f, e = 0.f, w = 0.f;

  for_each_neighbor(g, cell, [&](const NeighborCell& n) {
    __syncthreads();  // the previous cell's stage has been consumed
    stage_positions(g, n, sx, sy, sz);
    __syncthreads();

    if (own) {
      for (int j = 0; j < C; ++j) {
        const float d0 = xi - sx[j];
        const float d1 = yi - sy[j];
        const float d2 = zi - sz[j];
        const float rsq = d0 * d0 + d1 * d1 + d2 * d2;
        if (rsq < cutsq && !(n.center && j == i)) {
          const float sr2 = __fdiv_rn(1.0f, rsq);
          const float sr6 = sr2 * sr2 * sr2 * sig6;
          const float fc = (sr6 * eps48 - eps24) * sr6 * sr2;
          fx += fc * d0;
          fy += fc * d1;
          fz += fc * d2;
          if (EV) {
            e += sr6 * (sr6 - 1.0f);
            w += rsq * fc;
          }
        }
      }
    }
  });

  if (own) {
    f[si] = fx;
    f[M + si] = fy;
    f[2 * M + si] = fz;
  }

  if (EV) {
    const float es = block_sum(e);
    const float ws = block_sum(w);
    if (threadIdx.x == 0) {
      eng_part[cell] = es * eng_scale;
      vir_part[cell] = ws * 0.5f;
    }
  }
}

}  // namespace

// x: (3, M) float32 positions, f: (3, M) float32 out, eng/vir: (ncells,)
// float32 partials (ignored unless evflag). Returns cudaGetLastError().
extern "C" int lj_force_launch(const void* x, void* f, void* eng, void* vir,
                               int nbx, int nby, int nbz, int C,
                               float prdx, float prdy, float prdz,
                               float cutsq, double eps, float sig6,
                               int evflag, void* stream) {
  const int ncells = nbx * nby * nbz;
  const CellGrid g{(const float*)x, (long long)ncells * C, nbx, nby, nbz, C,
                   prdx, prdy, prdz};
  const int threads = (C + 31) / 32 * 32;
  const size_t smem = 3 * (size_t)C * sizeof(float);
  const float eps48 = (float)(48.0 * eps);
  const float eps24 = (float)(24.0 * eps);
  const float eng_scale = (float)(4.0 * eps);
  cudaStream_t s = (cudaStream_t)stream;
  if (evflag) {
    lj_force_kernel<true><<<ncells, threads, smem, s>>>(
        g, (float*)f, (float*)eng, (float*)vir, cutsq, eps48, eps24, sig6,
        eng_scale);
  } else {
    lj_force_kernel<false><<<ncells, threads, smem, s>>>(
        g, (float*)f, nullptr, nullptr, cutsq, eps48, eps24, sig6,
        eng_scale);
  }
  return (int)cudaGetLastError();
}
