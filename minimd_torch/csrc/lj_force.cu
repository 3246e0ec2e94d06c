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

// The force on the atoms of one cell of grid g, written at the cell's
// interior slots of f (3 rows of interior_slots(g)); with EV the cell's
// partials go to eng_part / vir_part[blockIdx.x] (= cell on one device).
// PARTS: C > 512 (lj_pair_sums').
template <bool EV, bool SHARDED, bool PARTS>
__device__ __forceinline__ void lj_force_cell(
    const CellGrid& g, int cell, float* __restrict__ f,
    float* __restrict__ eng_part, float* __restrict__ vir_part,
    const LJCoeffs& k, float eng_scale, float valid_below, float4* stage) {
  const long long M = g.M, Mo = SHARDED ? interior_slots(g) : M;
  // the cell's first stored slot (the one-device form indexes as before)
  const long long base = SHARDED ? cell_base(g, cell) : 0;
  const CellWalk cw = cell_walk<SHARDED>(g, cell, valid_below);

  // the cell's slots 32 at a time (slot group grp in lane threadIdx.x);
  // es and ws take the group sums in order (warp_sum's), so the partials
  // keep the bits of the first design's block-wide sum
  float es = 0.f, ws = 0.f;
  for (int grp = 0; grp * 32 < g.C; ++grp) {
    const int i = grp * 32 + threadIdx.x;
    const bool mine = i < g.C;
    const long long oi = (long long)cell * g.C + i;
    const long long si = SHARDED ? base + i : oi;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (mine) {
      xi = g.x[si];
      yi = g.x[M + si];
      zi = g.x[2 * M + si];
    }
    const bool valid = mine && xi < valid_below;
    float fx = 0.f, fy = 0.f, fz = 0.f, e = 0.f, w = 0.f;
    if (__any_sync(0xffffffffu, valid)) {
      lj_pair_sums<EV, PARTS>(g, cw, i, valid, xi, yi, zi, k, valid_below,
                              stage, fx, fy, fz, e, w);
    }
    if (mine) {
      f[oi] = fx;
      f[Mo + oi] = fy;
      f[2 * Mo + oi] = fz;
    }
    if (EV) {
      es += warp_sum(e);
      ws += warp_sum(w);
    }
  }
  if (EV && threadIdx.x == 0) {
    const int part = SHARDED ? (int)blockIdx.x : cell;
    eng_part[part] = es * eng_scale;
    vir_part[part] = ws * 0.5f;
  }
}

template <bool EV, bool PARTS>
__global__ void lj_force_kernel(const __grid_constant__ CellGrid g,
                                float* __restrict__ f,
                                float* __restrict__ eng_part,
                                float* __restrict__ vir_part,
                                const __grid_constant__ LJCoeffs k,
                                float eng_scale, float valid_below) {
  extern __shared__ float4 stage[];  // lj_stage_bytes(C): kept candidates
  lj_force_cell<EV, false, PARTS>(g, blockIdx.x, f, eng_part, vir_part, k,
                                  eng_scale, valid_below, stage);
}

// The sharded form: the domains of a decomposed run on one device, block
// b the cell b % ncells of domain b / ncells (cellgrid.cuh domain_cell),
// positions stored with the halo axes padded.
template <bool EV, bool PARTS>
__global__ void lj_force_sharded_kernel(const __grid_constant__ CellGrid g,
                                        float* __restrict__ f,
                                        float* __restrict__ eng_part,
                                        float* __restrict__ vir_part,
                                        const __grid_constant__ LJCoeffs k,
                                        float eng_scale, float valid_below) {
  extern __shared__ float4 stage[];  // lj_stage_bytes(C): kept candidates
  const DomainCell dc = domain_cell(g);
  lj_force_cell<EV, true, PARTS>(dc.g, dc.cell,
                                 f + dc.dom * 3 * interior_slots(dc.g),
                                 eng_part, vir_part, k, eng_scale,
                                 valid_below, stage);
}

template <bool EV, bool SHARDED>
cudaError_t launch(int blocks, size_t smem, cudaStream_t s, const CellGrid& g,
                   float* f, float* eng, float* vir, const LJCoeffs& k,
                   float eng_scale, float valid_below) {
  const bool parts = g.C > kStageC;
  const auto kernel =
      SHARDED ? (parts ? lj_force_sharded_kernel<EV, true>
                       : lj_force_sharded_kernel<EV, false>)
              : (parts ? lj_force_kernel<EV, true>
                       : lj_force_kernel<EV, false>);
  const cudaError_t err = allow_stage(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 32, smem, s>>>(  // a warp a cell
      g, f, eng, vir, k, eng_scale, valid_below);
  return cudaGetLastError();
}

}  // namespace

// x: (ndom, 3, M) float32 positions stored with the halo axes padded (M
// = stored_slots), f: (ndom, 3, ncells*C) float32 out for the interior
// cells, eng/vir: (ndom * ncells,) float32 partials (ignored unless
// evflag); a slot holds an atom iff its x < valid_below; halo:
// cellgrid.cuh's bits (0 and ndom 1 on one device). Returns the CUDA
// error of the shared-memory opt-in or cudaGetLastError().
extern "C" int lj_force_launch(const void* x, void* f, void* eng, void* vir,
                               int nbx, int nby, int nbz, int C,
                               float prdx, float prdy, float prdz,
                               float cutsq, double eps, float sig6,
                               float valid_below, int evflag, int halo,
                               int ndom, void* stream) {
  const int ncells = nbx * nby * nbz;
  const int blocks = ncells * ndom;
  const CellGrid g{(const float*)x, stored_slots(nbx, nby, nbz, C, halo),
                   nbx, nby, nbz, C, prdx, prdy, prdz, halo};
  const size_t smem = lj_stage_bytes(C);
  const LJCoeffs k{cutsq, (float)(48.0 * eps), (float)(24.0 * eps), sig6};
  const float eng_scale = (float)(4.0 * eps);
  cudaStream_t s = (cudaStream_t)stream;
  float* ef = evflag ? (float*)eng : nullptr;
  float* vf = evflag ? (float*)vir : nullptr;
  const auto go = evflag ? (halo || ndom > 1 ? launch<true, true>
                                             : launch<true, false>)
                         : (halo || ndom > 1 ? launch<false, true>
                                             : launch<false, false>);
  return (int)go(blocks, smem, s, g, (float*)f, ef, vf, k, eng_scale,
                 valid_below);
}
