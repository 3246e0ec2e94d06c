// EAM full-neighbor cell-grid force for Hopper (sm_90a): two kernels, the
// reference's two passes (ref/force_eam.cpp:274-449).
//
// Replaces: minimd_tpu/ops/eam_pallas.py, _make_eam_force_pallas_fused
// (`rho_kernel` and `force_kernel`, one program per (z, y) cell row over a
// lane-packed [x-1 | x | x+1] candidate block) and make_embedding_pallas
// (fp = F'(rho) and F(rho) from the frho spline rows, a gather the TPU had
// to split into four 128-entry lane gathers). The embedding is fused into
// the density kernel's epilogue here.
//
//   eam_rho:   rho_i = sum_j R(r_ij); fp_i = F'(rho_i); on EV, F(rho_i)
//              of valid slots summed into one partial per cell.
//   eam_force: psi' = (fp_i + fp_j)*G1(r) + G2(r); f_i -= psi' * d; on EV
//              one partial per cell of sum P(r) and of -1/2 sum rsq*psi'.
//
// R, G1, G2, P are minimd_torch.eam_file.PairPolys: a polynomial body in
// u = clamp(r*u_a + u_b, -1, 1) for r < split, and the spline's own last
// rows as a tail in t = min(r, cut)*rdr + 1 - m0 (one merged polynomial,
// or row k = min(floor(t), nrows-1) and a cubic in t - k). The f64 fit is
// rounded to f32 and passed by value as a __grid_constant__ kernel
// argument: every coefficient is read at an index known at compile time,
// so it stays in the constant bank and reaches all threads as a broadcast.
//
// What bounds them on the H100: instruction issue and latency in the pair
// loop, not memory. Each atom meets the 27*C slots of its stencil (1,080
// at C = 40 on the Cu deck), of which ~864 hold atoms and ~42 are inside
// the cutoff; per pair a square root and a degree-20 Horner per pair
// function (one in the density pass, two, three with EV, in the force
// pass). A walk of every slot by every lane, with a branch around the
// in-cut pairs (the first design), costs each warp two passes over the
// 1,080 slots and a Horner for every candidate that is in the cutoff for
// any of its 32 lanes: ~213 Horner warp-steps per cell where no lane has
// more than ~42 pairs.
//
// What this design does about it: the passes of eam_pass.cuh (one warp
// per cell; only the valid candidates near the cell's atoms staged,
// ~216 of 1,080 at C = 40; per-lane lists of the in-cut ones, so ~42
// Horner warp-steps per cell). The pair arithmetic is the first
// design's, with the contractions nvcc chose there written out
// (__fmaf_rn, read off its SASS), so rho, fp, f and every lane's sums are
// bit-identical to a walk of all 27*C slots; the pair sums differ from
// the plain version (ops/eam_grid.py) by f32 rounding.
//
// Not done yet (later work): one in-cut list shared by the two passes,
// TMA staging.

#include <cuda_runtime.h>

#include "eam_pass.cuh"

namespace {

constexpr int kMaxBody = 25;   // degree <= 24 bodies, right-aligned
constexpr int kMergedN = 8;    // degree <= 7 merged tails, right-aligned
constexpr int kRowN = 4;       // cubic tail rows
constexpr int kMaxRows = 4;

// One pair function, coefficients in descending powers. The leading
// entries of `body` and `merged` are zero where the fit has fewer
// coefficients: a Horner that starts on zeros is exact.
struct PairFn {
  float body[kMaxBody];
  float merged[kMergedN];
  float rows[kMaxRows][kRowN];
  int is_merged;
};

struct PairParams {
  float u_a, u_b, split, cut, rdr, t0, cutsq;  // t0 = 1 - m0
  int nrows;
  PairFn fn[4];  // R, G1, G2, P
};
static_assert(sizeof(PairParams) ==
                  4 * (8 + 4 * (kMaxBody + kMergedN + kMaxRows * kRowN + 1)),
              "PairParams must match ops/eam_cuda.py's ctypes layout");

enum { kR = 0, kG1 = 1, kG2 = 2, kP = 3 };

// Pair function FN at r (split <= r < cut on the tail side), NB body
// coefficients (the longest body of the four, see the launchers). The
// operations are rounded as nvcc contracted them in the first design's
// kernels (read off their SASS): each "a * b + c" one FMA.
template <int NB, int FN>
__device__ __forceinline__ float pair_fn(const PairParams& p, float r) {
  const PairFn& f = p.fn[FN];
  if (r < p.split) {
    const float u = fminf(fmaxf(__fmaf_rn(r, p.u_a, p.u_b), -1.0f), 1.0f);
    float acc = f.body[kMaxBody - NB];
#pragma unroll
    for (int k = kMaxBody - NB + 1; k < kMaxBody; ++k) {
      acc = __fmaf_rn(acc, u, f.body[k]);
    }
    return acc;
  }
  const float t = __fmaf_rn(fminf(r, p.cut), p.rdr, p.t0);
  if (f.is_merged) {
    float acc = f.merged[0];
#pragma unroll
    for (int k = 1; k < kMergedN; ++k) acc = __fmaf_rn(acc, t, f.merged[k]);
    return acc;
  }
  const int k = min(max((int)floorf(t), 0), p.nrows - 1);
  float c[kRowN];
#pragma unroll
  for (int q = 0; q < kRowN; ++q) c[q] = f.rows[0][q];
#pragma unroll
  for (int row = 1; row < kMaxRows; ++row) {
    if (row == k) {
#pragma unroll
      for (int q = 0; q < kRowN; ++q) c[q] = f.rows[row][q];
    }
  }
  const float tk = __fsub_rn(t, (float)k);
  float acc = c[0];
#pragma unroll
  for (int q = 1; q < kRowN; ++q) acc = __fmaf_rn(acc, tk, c[q]);
  return acc;
}

template <int NB, bool EV>
__global__ void eam_rho_kernel(const __grid_constant__ CellGrid g,
                               const __grid_constant__ PairParams p,
                               float* __restrict__ rho,
                               float* __restrict__ fp,
                               float* __restrict__ embed_part,
                               const float* __restrict__ frho, int nrho,
                               float rdrho, float valid_below) {
  extern __shared__ float4 stage[];  // eam_pass_bytes(C, false)
  density_pass<EV>(g, blockIdx.x, p.cutsq, valid_below, stage, rho, fp,
                   embed_part, frho, nrho, rdrho,
                   [&](float r) { return pair_fn<NB, kR>(p, r); });
}

template <int NB, bool EV>
__global__ void eam_force_kernel(const __grid_constant__ CellGrid g,
                                 const __grid_constant__ PairParams p,
                                 const float* __restrict__ fp,
                                 float* __restrict__ f,
                                 float* __restrict__ eng_part,
                                 float* __restrict__ vir_part,
                                 float valid_below) {
  extern __shared__ float4 stage[];  // eam_pass_bytes(C, true)
  force_pass<EV>(
      g, blockIdx.x, p.cutsq, valid_below, stage, fp, f, eng_part, vir_part,
      [&](float fsum, float r) {
        // psi' as the first design's SASS rounds it: its G1 product and
        // G2 sum lie in two branches, so nvcc did not fuse them
        return __fadd_rn(__fmul_rn(fsum, pair_fn<NB, kG1>(p, r)),
                         pair_fn<NB, kG2>(p, r));
      },
      [&](float r) { return pair_fn<NB, kP>(p, r); });
}

// The sharded forms: the domains of a decomposed run on one device, block
// b the cell b % ncells of domain b / ncells (cellgrid.cuh domain_cell),
// positions and fp stored with the halo axes padded.
template <int NB, bool EV>
__global__ void eam_rho_sharded_kernel(const __grid_constant__ CellGrid g,
                                       const __grid_constant__ PairParams p,
                                       float* __restrict__ rho,
                                       float* __restrict__ fp,
                                       float* __restrict__ embed_part,
                                       const float* __restrict__ frho,
                                       int nrho, float rdrho,
                                       float valid_below) {
  extern __shared__ float4 stage[];  // eam_pass_bytes(C, false)
  const DomainCell dc = domain_cell(g);
  const long long Mo = interior_slots(dc.g);
  density_pass<EV, true>(dc.g, dc.cell, p.cutsq, valid_below, stage,
                         rho + dc.dom * Mo, fp + dc.dom * Mo, embed_part,
                         frho, nrho, rdrho,
                         [&](float r) { return pair_fn<NB, kR>(p, r); });
}

template <int NB, bool EV>
__global__ void eam_force_sharded_kernel(const __grid_constant__ CellGrid g,
                                         const __grid_constant__ PairParams p,
                                         const float* __restrict__ fp,
                                         float* __restrict__ f,
                                         float* __restrict__ eng_part,
                                         float* __restrict__ vir_part,
                                         float valid_below) {
  extern __shared__ float4 stage[];  // eam_pass_bytes(C, true)
  const DomainCell dc = domain_cell(g);
  force_pass<EV, true>(
      dc.g, dc.cell, p.cutsq, valid_below, stage, fp + dc.dom * dc.g.M,
      f + dc.dom * 3 * interior_slots(dc.g), eng_part, vir_part,
      [&](float fsum, float r) {   // as eam_force_kernel's
        return __fadd_rn(__fmul_rn(fsum, pair_fn<NB, kG1>(p, r)),
                         pair_fn<NB, kG2>(p, r));
      },
      [&](float r) { return pair_fn<NB, kP>(p, r); });
}

template <int NB, bool SHARDED>
cudaError_t launch_rho(int blocks, size_t smem, cudaStream_t s,
                       const CellGrid& g, const PairParams& p, float* rho,
                       float* fp, float* embed, const float* frho, int nrho,
                       float rdrho, float valid_below, int evflag) {
  const auto kernel =
      SHARDED ? (evflag ? eam_rho_sharded_kernel<NB, true>
                        : eam_rho_sharded_kernel<NB, false>)
              : (evflag ? eam_rho_kernel<NB, true>
                        : eam_rho_kernel<NB, false>);
  const cudaError_t err = allow_stage(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 32, smem, s>>>(g, p, rho, fp, evflag ? embed : nullptr,
                                  frho, nrho, rdrho, valid_below);
  return cudaGetLastError();
}

template <int NB, bool SHARDED>
cudaError_t launch_force(int blocks, size_t smem, cudaStream_t s,
                         const CellGrid& g, const PairParams& p,
                         const float* fp, float* f, float* eng, float* vir,
                         float valid_below, int evflag) {
  const auto kernel =
      SHARDED ? (evflag ? eam_force_sharded_kernel<NB, true>
                        : eam_force_sharded_kernel<NB, false>)
              : (evflag ? eam_force_kernel<NB, true>
                        : eam_force_kernel<NB, false>);
  const cudaError_t err = allow_stage(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 32, smem, s>>>(g, p, fp, f, evflag ? eng : nullptr,
                                  evflag ? vir : nullptr, valid_below);
  return cudaGetLastError();
}

}  // namespace

// The body Horner is unrolled for nbody = 21 (degree-20 bodies, what the
// adaptive fit gives for Cu_u6) or 25 (any body up to degree 24, shorter
// ones zero-padded); other values return cudaErrorInvalidValue. Both
// launchers run one warp per cell and return the CUDA error of the
// shared-memory opt-in (above 48 KB) or cudaGetLastError(); a slot holds
// an atom iff its x < valid_below.

// x: (ndom, 3, M) float32 positions, stored with the halo axes padded
// (M = stored_slots; halo: cellgrid.cuh's bits; 0 and ndom 1 on one
// device); rho, fp: (ndom, ncells*C) float32 out for the interior cells;
// embed: (ndom * ncells,) float32 partials of F(rho) over valid slots
// (ignored unless evflag); frho: (7, nrho+1) float32 spline columns on the
// device; params: host pointer to a PairParams.
extern "C" int eam_rho_launch(const void* x, void* rho, void* fp, void* embed,
                              const void* frho, int nrho, float rdrho,
                              const void* params, int nbody, int nbx, int nby,
                              int nbz, int C, float prdx, float prdy,
                              float prdz, float valid_below, int evflag,
                              int halo, int ndom, void* stream) {
  const int ncells = nbx * nby * nbz * ndom;
  const CellGrid g{(const float*)x, stored_slots(nbx, nby, nbz, C, halo),
                   nbx, nby, nbz, C, prdx, prdy, prdz, halo};
  const PairParams p = *(const PairParams*)params;
  const size_t smem = eam_pass_bytes(C, false);
  cudaStream_t s = (cudaStream_t)stream;
  const bool sharded = halo || ndom > 1;
  if (nbody == 21) {
    return (int)(sharded ? launch_rho<21, true> : launch_rho<21, false>)(
        ncells, smem, s, g, p, (float*)rho, (float*)fp, (float*)embed,
        (const float*)frho, nrho, rdrho, valid_below, evflag);
  }
  if (nbody == kMaxBody) {
    return (int)(sharded ? launch_rho<kMaxBody, true>
                         : launch_rho<kMaxBody, false>)(
        ncells, smem, s, g, p, (float*)rho, (float*)fp, (float*)embed,
        (const float*)frho, nrho, rdrho, valid_below, evflag);
  }
  return (int)cudaErrorInvalidValue;
}

// x: (ndom, 3, M) float32 positions and fp: (ndom, M) float32, both
// stored with the halo axes padded (fp: eam_rho_launch's, through the fp
// halo on a decomposed run); f: (ndom, 3, ncells*C) float32 out; eng/vir:
// (ndom * ncells,) float32 partials of sum P and of -1/2 sum rsq*psi'
// (ignored unless evflag).
extern "C" int eam_force_launch(const void* x, const void* fp, void* f,
                                void* eng, void* vir, const void* params,
                                int nbody, int nbx, int nby, int nbz, int C,
                                float prdx, float prdy, float prdz,
                                float valid_below, int evflag, int halo,
                                int ndom, void* stream) {
  const int ncells = nbx * nby * nbz * ndom;
  const CellGrid g{(const float*)x, stored_slots(nbx, nby, nbz, C, halo),
                   nbx, nby, nbz, C, prdx, prdy, prdz, halo};
  const PairParams p = *(const PairParams*)params;
  const size_t smem = eam_pass_bytes(C, true);
  cudaStream_t s = (cudaStream_t)stream;
  const bool sharded = halo || ndom > 1;
  if (nbody == 21) {
    return (int)(sharded ? launch_force<21, true> : launch_force<21, false>)(
        ncells, smem, s, g, p, (const float*)fp, (float*)f, (float*)eng,
        (float*)vir, valid_below, evflag);
  }
  if (nbody == kMaxBody) {
    return (int)(sharded ? launch_force<kMaxBody, true>
                         : launch_force<kMaxBody, false>)(
        ncells, smem, s, g, p, (const float*)fp, (float*)f, (float*)eng,
        (float*)vir, valid_below, evflag);
  }
  return (int)cudaErrorInvalidValue;
}
