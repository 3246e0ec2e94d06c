// EAM full-neighbor cell-grid force through gather tables for Hopper
// (sm_90a): the reference's two passes, each pair function one cubic
// picked from a table.
//
// Replaces: minimd_tpu/ops/eam_pallas.py, make_eam_force_pallas_rows
// (`rho_kernel` and `force_kernel`: the pair functions through <=128-entry
// piecewise tables and Mosaic's per-lane dynamic gather, with the
// embedding between the passes in XLA).
//
//   eam_rho_rows:   rho_i = sum_j R(r_ij); fp_i = F'(rho_i); on EV, F(rho_i)
//                   of valid slots summed into one partial per cell.
//   eam_force_rows: psi' = (fp_i + fp_j)*G1(r) + G2(r); f_i -= psi' * d;
//                   on EV one partial per cell of sum P(r) and of
//                   -1/2 sum rsq*psi'.
//
// R, G1, G2, P are minimd_torch.eam_file.PairRows: a piecewise-uniform
// grid in r (n_body pieces of width h below split, one piece per spline
// knot interval up to the cutoff; 127 pieces for Cu_u6), and per piece and
// function a cubic in t. The index map is ops/eam_rows.py's:
// idxf = (r - lo)*inv_h below split, n_body + (r - split)*rdr above,
// clamped to [0, ne - 1 + 0.999]; k = min(int idxf, ne - 1), t = idxf - k.
//
// What bounds them on the H100: instruction issue and latency in the pair
// loop, not memory, as for eam_force.cu. Each atom meets the 27*C slots of
// its stencil (1,080 at C = 40 on the Cu deck), ~864 of which hold atoms
// and ~42 lie inside the cutoff; per in-cut pair a square root, the index
// map and one cubic per function (one in the density pass, two, three
// with EV, in the force pass).
//
// What this design does about it: eam_force.cu's, the passes of
// eam_pass.cuh (one warp per cell; only the valid candidates near the
// cell's atoms staged, ~216 of 1,080 at C = 40; per-lane lists of the
// in-cut ones, so the lanes run the index map and the cubics ~42
// warp-steps per cell where a walk of every slot with a branch around the
// in-cut pairs, the first design, ran ~215). The tables (one float4 per
// piece and function, 2 KB per function) are read from global memory
// with __ldg, so they stay in L1 and no block stages them: the blocks'
// shared memory is the stage and the lists alone, as in eam_force.cu.
// (Blocks of 4 warps sharing one copy of the tables in shared memory
// hold fewer warps on an SM and were slower on the H100: PERF.md.
// __constant__ memory would serialize lanes that read different pieces.)
// The pair arithmetic is the first design's, with the contractions nvcc
// chose there written out (read off its SASS), so rho, fp, f and every
// lane's sums are bit-identical to it; the pair sums differ from the
// plain version (ops/eam_rows.py) by f32 rounding.
//
// Not done yet (later work): one in-cut list shared by the two passes,
// TMA staging.

#include <cuda_runtime.h>

#include "eam_pass.cuh"

namespace {

// The index map of ops/eam_rows.py eval_pair_rows; ops/eam_rows_cuda.py
// fills it (_RowMap).
struct RowMap {
  float lo, split, inv_h, rdr, n_body, idx_max, cutsq;
  int ne;
};
static_assert(sizeof(RowMap) == 32, "RowMap must match _RowMap");

enum { kR = 0, kG1 = 1, kG2 = 2, kP = 3 };

// Piece k and local coordinate t of r, rounded as the first design's
// SASS rounds them: (r - lo)*inv_h a subtraction and a product, n_body +
// (r - split)*rdr a subtraction and an FMA.
__device__ __forceinline__ int row_index(const RowMap& m, float r, float* t) {
  float idxf = r < m.split ? __fmul_rn(__fsub_rn(r, m.lo), m.inv_h)
                           : __fmaf_rn(__fsub_rn(r, m.split), m.rdr,
                                       m.n_body);
  idxf = fminf(fmaxf(idxf, 0.0f), m.idx_max);
  const int k = min((int)idxf, m.ne - 1);
  *t = __fsub_rn(idxf, (float)k);
  return k;
}

// The piece's cubic, coefficients in descending powers: three FMAs.
__device__ __forceinline__ float cubic(float4 c, float t) {
  return __fmaf_rn(__fmaf_rn(__fmaf_rn(c.x, t, c.y), t, c.z), t, c.w);
}

template <bool EV>
__global__ void eam_rho_rows_kernel(const __grid_constant__ CellGrid g,
                                    const float4* __restrict__ tab,
                                    const __grid_constant__ RowMap m,
                                    float* __restrict__ rho,
                                    float* __restrict__ fp,
                                    float* __restrict__ embed_part,
                                    const float* __restrict__ frho, int nrho,
                                    float rdrho, float valid_below) {
  extern __shared__ float4 stage[];  // eam_pass_bytes(C, false)
  const float4* tR = tab + kR * m.ne;
  density_pass<EV>(g, m.cutsq, valid_below, stage, rho, fp, embed_part,
                   frho, nrho, rdrho, [&](float r) {
    float t;
    const int k = row_index(m, r, &t);
    return cubic(__ldg(tR + k), t);
  });
}

template <bool EV>
__global__ void eam_force_rows_kernel(const __grid_constant__ CellGrid g,
                                      const float4* __restrict__ tab,
                                      const __grid_constant__ RowMap m,
                                      const float* __restrict__ fp,
                                      float* __restrict__ f,
                                      float* __restrict__ eng_part,
                                      float* __restrict__ vir_part,
                                      float valid_below) {
  extern __shared__ float4 stage[];  // eam_pass_bytes(C, true)
  const float4* tG1 = tab + kG1 * m.ne;
  const float4* tG2 = tab + kG2 * m.ne;
  const float4* tP = tab + kP * m.ne;
  int k;    // the pair's piece and local coordinate, from psi's index
  float t;  // map, for P (nvcc would compute a second map again)
  force_pass<EV>(
      g, m.cutsq, valid_below, stage, fp, f, eng_part, vir_part,
      [&](float fsum, float r) {
        k = row_index(m, r, &t);
        // psi' as the first design's SASS rounds it: the G1 product and
        // the G2 sum are one expression there, fused into an FMA
        return __fmaf_rn(fsum, cubic(__ldg(tG1 + k), t),
                         cubic(__ldg(tG2 + k), t));
      },
      [&](float) { return cubic(__ldg(tP + k), t); });
}

}  // namespace

// Both launchers run one warp per cell and return the CUDA error of the
// shared-memory opt-in (above 48 KB) or cudaGetLastError(); a slot holds
// an atom iff its x < valid_below.

// x: (3, M) float32 positions; rho, fp: (M,) float32 out; embed: (ncells,)
// float32 partials of F(rho) over valid slots (ignored unless evflag);
// frho: (7, nrho+1) float32 spline columns; tab: (4, ne) float4 tables on
// the device (R, G1, G2, P); rowmap: host pointer to a RowMap.
extern "C" int eam_rho_rows_launch(const void* x, void* rho, void* fp,
                                   void* embed, const void* frho, int nrho,
                                   float rdrho, const void* tab,
                                   const void* rowmap, int nbx, int nby,
                                   int nbz, int C, float prdx, float prdy,
                                   float prdz, float valid_below, int evflag,
                                   void* stream) {
  const int ncells = nbx * nby * nbz;
  const CellGrid g{(const float*)x, (long long)ncells * C, nbx, nby, nbz, C,
                   prdx, prdy, prdz};
  const RowMap m = *(const RowMap*)rowmap;
  const size_t smem = eam_pass_bytes(C, false);
  const auto kernel =
      evflag ? eam_rho_rows_kernel<true> : eam_rho_rows_kernel<false>;
  const cudaError_t err = allow_stage(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ncells, 32, smem, (cudaStream_t)stream>>>(
      g, (const float4*)tab, m, (float*)rho, (float*)fp,
      evflag ? (float*)embed : nullptr, (const float*)frho, nrho, rdrho,
      valid_below);
  return (int)cudaGetLastError();
}

// x: (3, M) float32 positions; fp: (M,) float32 from eam_rho_rows_launch;
// f: (3, M) float32 out; eng/vir: (ncells,) float32 partials of sum P and
// of -1/2 sum rsq*psi' (ignored unless evflag); tab, rowmap as above.
extern "C" int eam_force_rows_launch(const void* x, const void* fp, void* f,
                                     void* eng, void* vir, const void* tab,
                                     const void* rowmap, int nbx, int nby,
                                     int nbz, int C, float prdx, float prdy,
                                     float prdz, float valid_below,
                                     int evflag, void* stream) {
  const int ncells = nbx * nby * nbz;
  const CellGrid g{(const float*)x, (long long)ncells * C, nbx, nby, nbz, C,
                   prdx, prdy, prdz};
  const RowMap m = *(const RowMap*)rowmap;
  const size_t smem = eam_pass_bytes(C, true);
  const auto kernel =
      evflag ? eam_force_rows_kernel<true> : eam_force_rows_kernel<false>;
  const cudaError_t err = allow_stage(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ncells, 32, smem, (cudaStream_t)stream>>>(
      g, (const float4*)tab, m, (const float*)fp, (float*)f,
      evflag ? (float*)eng : nullptr, evflag ? (float*)vir : nullptr,
      valid_below);
  return (int)cudaGetLastError();
}
