// LJ full-neighbor cell-grid force for Hopper (sm_90a).
//
// Replaces: minimd_tpu/ops/lj_pallas.py:69, _make_lj_force_pallas_fused
// (the Pallas kernel body `kernel` :149, pallas_call :293: one program per
// (z, y) cell row over a lane-packed [x-1 | x | x+1] candidate block).
//
// What bounds it on the H100: the LJ candidate loop (lj_pair.cuh has the
// count), not memory: ~10 FP32 operations per candidate plus an IEEE
// divide per pair inside the cutoff, against 24 bytes per slot of
// positions and forces. With the prune below, latency more than issue:
// 64 registers a lane leave 32 warps on an SM, and each warp's staging
// (dependent loads and ballots) and pair loop run one after the other.
//
// What the design does about it: one block of one warp per cell; the
// lanes take the cell's slots 32 at a time. The pair loop of lj_pair.cuh,
// shared with the fused step lj_step.cu, walks only the valid candidates
// within the cutoff (plus a margin) of the cell's own-atom bounding box,
// compacted into shared memory in the stencil's walk order, and skips
// slot groups with no atom; the forces are bit-identical to a walk of all
// 27*C slots. Each thread sums its own atom's force (full-neighbor
// convention): no atomics, deterministic. With EV, energy and virial are
// reduced per cell in a fixed order (warp_sum's, group by group over C
// rounded up to a warp, 0 on empty slots) into one partial per cell; the
// wrapper sums the partials with torch.sum.
//
// Not done yet (later work): the approximate reciprocal, staging the 9
// x-runs of a plane with cp.async or TMA, splitting a cell's atoms across
// warps so that a grid of ~1.2 waves (131k atoms) ends sooner, CUDA
// graphs.

#include <cuda_runtime.h>

#include "lj_pair.cuh"

namespace {

template <bool EV>
__global__ void lj_force_kernel(const __grid_constant__ CellGrid g,
                                float* __restrict__ f,
                                float* __restrict__ eng_part,
                                float* __restrict__ vir_part,
                                const __grid_constant__ LJCoeffs k,
                                float eng_scale, float valid_below) {
  extern __shared__ float4 stage[];  // lj_stage_bytes(C): kept candidates
  const long long M = g.M;
  const int cell = blockIdx.x;
  const CellWalk cw = cell_walk(g, cell, valid_below);

  // the cell's slots 32 at a time (slot group grp in lane threadIdx.x);
  // es and ws take the group sums in order (warp_sum's), so the partials
  // keep the bits of the first design's block-wide sum
  float es = 0.f, ws = 0.f;
  for (int grp = 0; grp * 32 < g.C; ++grp) {
    const int i = grp * 32 + threadIdx.x;
    const bool own = i < g.C;
    const long long si = (long long)cell * g.C + i;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (own) {
      xi = g.x[si];
      yi = g.x[M + si];
      zi = g.x[2 * M + si];
    }
    const bool valid = own && xi < valid_below;
    float fx = 0.f, fy = 0.f, fz = 0.f, e = 0.f, w = 0.f;
    if (__any_sync(0xffffffffu, valid)) {
      lj_pair_sums<EV>(g, cw, i, valid, xi, yi, zi, k, valid_below, stage,
                       fx, fy, fz, e, w);
    }
    if (own) {
      f[si] = fx;
      f[M + si] = fy;
      f[2 * M + si] = fz;
    }
    if (EV) {
      es += warp_sum(e);
      ws += warp_sum(w);
    }
  }
  if (EV && threadIdx.x == 0) {
    eng_part[cell] = es * eng_scale;
    vir_part[cell] = ws * 0.5f;
  }
}

}  // namespace

// x: (3, M) float32 positions, f: (3, M) float32 out, eng/vir: (ncells,)
// float32 partials (ignored unless evflag); a slot holds an atom iff its x
// < valid_below. Returns the CUDA error of the shared-memory opt-in or
// cudaGetLastError().
extern "C" int lj_force_launch(const void* x, void* f, void* eng, void* vir,
                               int nbx, int nby, int nbz, int C,
                               float prdx, float prdy, float prdz,
                               float cutsq, double eps, float sig6,
                               float valid_below, int evflag, void* stream) {
  const int ncells = nbx * nby * nbz;
  const CellGrid g{(const float*)x, (long long)ncells * C, nbx, nby, nbz, C,
                   prdx, prdy, prdz};
  const int threads = 32;  // one warp per cell
  const size_t smem = lj_stage_bytes(C);
  const LJCoeffs k{cutsq, (float)(48.0 * eps), (float)(24.0 * eps), sig6};
  const float eng_scale = (float)(4.0 * eps);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (evflag) {
    err = allow_stage(lj_force_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    lj_force_kernel<true><<<ncells, threads, smem, s>>>(
        g, (float*)f, (float*)eng, (float*)vir, k, eng_scale, valid_below);
  } else {
    err = allow_stage(lj_force_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    lj_force_kernel<false><<<ncells, threads, smem, s>>>(
        g, (float*)f, nullptr, nullptr, k, eng_scale, valid_below);
  }
  return (int)cudaGetLastError();
}
