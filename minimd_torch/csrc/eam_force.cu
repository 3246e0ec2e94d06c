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
// What this design does about it, per block (one cell, one warp; the
// lanes take the cell's slots 32 at a time), with cell_stage.cuh:
//  1. the warp reduces the bounding box of the cell's valid own atoms;
//  2. it walks the 27 neighbor cells in for_each_neighbor's order and
//     stages, compacted in walk order, only the valid candidates within
//     cutsq * (1 + 2^-10) of the box (~216 of 1,080 at C = 40), with their
//     fp in the force pass and the slot tag that marks the own atom;
//  3. each valid lane tests the staged candidates with the plain walk's
//     exact rsq and lists its in-cut ones (16-bit stage indices, walk
//     order) in shared memory;
//  4. the lanes run the pair functions over their lists in lockstep, a
//     lane whose list is shorter idle: ~42 Horner warp-steps per cell.
// A 32-slot group with no atom skips 2-4 and writes rho = 0, fp = F'(0),
// f = 0. The lists hold every in-cut pair in the plain walk's order, and
// the pair arithmetic is the first design's, with the contractions nvcc
// chose there written out (__fmaf_rn, read off its SASS), so rho, fp, f
// and every lane's sums are bit-identical to a walk of all 27*C slots;
// the per-cell partials add the groups' warp sums in block_sum's order.
// Each lane owns its atom's sums: no atomics, deterministic. The
// embedding epilogue (eam_embed.cuh, shared with eam_rows.cu) is written
// with explicitly rounded operations, so fp is bit-identical to the plain
// `embedding` (ops/eam_grid.py) of the same rho; the pair sums differ
// from the plain version by f32 rounding.
//
// Not done yet (later work): one in-cut list shared by the two passes,
// the gather-table kernels (eam_rows.cu) on the same stage, TMA staging.

#include <cuda_runtime.h>

#include "cell_stage.cuh"
#include "eam_embed.cuh"

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

// The stage holds kStageCells * C candidates (float4, and fp in the force
// pass): a stencil's kept candidates fit at once where they are fewer
// than (kStageCells - 1/8) * C, ~216 of 1,080 at C = 40; otherwise
// stage_stencil hands them over in parts.
constexpr int kStageCells = 9;

template <int NB, bool EV>
__global__ void eam_rho_kernel(const __grid_constant__ CellGrid g,
                               const __grid_constant__ PairParams p,
                               float* __restrict__ rho,
                               float* __restrict__ fp,
                               float* __restrict__ embed_part,
                               const float* __restrict__ frho, int nrho,
                               float rdrho, float valid_below) {
  extern __shared__ float4 stage[];  // pair_list_bytes(cap, false)
  const int C = g.C;
  const long long M = g.M;
  const int cap = kStageCells * C;
  uint16_t* lists = reinterpret_cast<uint16_t*>(stage + cap);
  const int cell = blockIdx.x;
  const CellWalk cw = cell_walk(g, cell, valid_below);
  const float cut_keep = __fmul_rn(p.cutsq, kKeepMargin);

  float es = 0.f;  // the groups' F(rho) sums, in block_sum's order
  for (int grp = 0; grp * 32 < C; ++grp) {
    const int i = grp * 32 + threadIdx.x;
    const bool own = i < C;
    const long long si = (long long)cell * C + i;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (own) {
      xi = g.x[si];
      yi = g.x[M + si];
      zi = g.x[2 * M + si];
    }
    const bool valid = own && xi < valid_below;
    float acc = 0.f;
    if (__any_sync(0xffffffffu, valid)) {
      stage_stencil(g, cw, cut_keep, valid_below, cap, stage, nullptr,
                    nullptr, [&](int kept) {
        for_each_in_cut(stage, kept, i, valid, xi, yi, zi, p.cutsq, lists,
                        [&](int q) {
          float d0, d1, d2;
          const float rsq = pair_dist(stage[q], xi, yi, zi, d0, d1, d2);
          acc = __fadd_rn(acc, pair_fn<NB, kR>(p, __fsqrt_rn(rsq)));
        });
      });
    }
    const float emb = density_group<EV>(acc, own, si, xi, rho, fp, frho,
                                        nrho, rdrho, valid_below);
    if (EV) es += emb;
  }
  if (EV && threadIdx.x == 0) embed_part[cell] = es;
}

template <int NB, bool EV>
__global__ void eam_force_kernel(const __grid_constant__ CellGrid g,
                                 const __grid_constant__ PairParams p,
                                 const float* __restrict__ fp,
                                 float* __restrict__ f,
                                 float* __restrict__ eng_part,
                                 float* __restrict__ vir_part,
                                 float valid_below) {
  extern __shared__ float4 stage[];  // pair_list_bytes(cap, true)
  const int C = g.C;
  const long long M = g.M;
  const int cap = kStageCells * C;
  float* sfp = reinterpret_cast<float*>(stage + cap);
  uint16_t* lists = reinterpret_cast<uint16_t*>(sfp + cap);
  const int cell = blockIdx.x;
  const CellWalk cw = cell_walk(g, cell, valid_below);
  const float cut_keep = __fmul_rn(p.cutsq, kKeepMargin);

  float es = 0.f, ws = 0.f;  // the groups' sums, in block_sum's order
  for (int grp = 0; grp * 32 < C; ++grp) {
    const int i = grp * 32 + threadIdx.x;
    const bool own = i < C;
    const long long si = (long long)cell * C + i;
    float xi = 0.f, yi = 0.f, zi = 0.f, fpi = 0.f;
    if (own) {
      xi = g.x[si];
      yi = g.x[M + si];
      zi = g.x[2 * M + si];
      fpi = fp[si];
    }
    const bool valid = own && xi < valid_below;
    float fx = 0.f, fy = 0.f, fz = 0.f, e = 0.f, w = 0.f;
    if (__any_sync(0xffffffffu, valid)) {
      stage_stencil(g, cw, cut_keep, valid_below, cap, stage, sfp, fp,
                    [&](int kept) {
        for_each_in_cut(stage, kept, i, valid, xi, yi, zi, p.cutsq, lists,
                        [&](int q) {
          float d0, d1, d2;
          const float rsq = pair_dist(stage[q], xi, yi, zi, d0, d1, d2);
          const float r = __fsqrt_rn(rsq);
          // psi' as the first design's SASS rounds it: its G1 product
          // and G2 sum lie in two branches, so nvcc did not fuse them
          const float psip = __fadd_rn(
              __fmul_rn(__fadd_rn(fpi, sfp[q]), pair_fn<NB, kG1>(p, r)),
              pair_fn<NB, kG2>(p, r));
          fx = __fmaf_rn(-psip, d0, fx);
          fy = __fmaf_rn(-psip, d1, fy);
          fz = __fmaf_rn(-psip, d2, fz);
          if (EV) {
            e = __fadd_rn(e, pair_fn<NB, kP>(p, r));
            w = __fmaf_rn(rsq, psip, w);
          }
        });
      });
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
    eng_part[cell] = es;
    vir_part[cell] = -0.5f * ws;
  }
}

template <int NB>
cudaError_t launch_rho(int ncells, size_t smem, cudaStream_t s,
                       const CellGrid& g, const PairParams& p, float* rho,
                       float* fp, float* embed, const float* frho, int nrho,
                       float rdrho, float valid_below, int evflag) {
  const auto kernel =
      evflag ? eam_rho_kernel<NB, true> : eam_rho_kernel<NB, false>;
  const cudaError_t err = allow_stage(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<ncells, 32, smem, s>>>(g, p, rho, fp, evflag ? embed : nullptr,
                                  frho, nrho, rdrho, valid_below);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_force(int ncells, size_t smem, cudaStream_t s,
                         const CellGrid& g, const PairParams& p,
                         const float* fp, float* f, float* eng, float* vir,
                         float valid_below, int evflag) {
  const auto kernel =
      evflag ? eam_force_kernel<NB, true> : eam_force_kernel<NB, false>;
  const cudaError_t err = allow_stage(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<ncells, 32, smem, s>>>(g, p, fp, f, evflag ? eng : nullptr,
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

// x: (3, M) float32 positions; rho, fp: (M,) float32 out; embed: (ncells,)
// float32 partials of F(rho) over valid slots (ignored unless evflag);
// frho: (7, nrho+1) float32 spline columns on the device; params: host
// pointer to a PairParams.
extern "C" int eam_rho_launch(const void* x, void* rho, void* fp, void* embed,
                              const void* frho, int nrho, float rdrho,
                              const void* params, int nbody, int nbx, int nby,
                              int nbz, int C, float prdx, float prdy,
                              float prdz, float valid_below, int evflag,
                              void* stream) {
  const int ncells = nbx * nby * nbz;
  const CellGrid g{(const float*)x, (long long)ncells * C, nbx, nby, nbz, C,
                   prdx, prdy, prdz};
  const PairParams p = *(const PairParams*)params;
  const size_t smem = pair_list_bytes(kStageCells * C, false);
  cudaStream_t s = (cudaStream_t)stream;
  if (nbody == 21) {
    return (int)launch_rho<21>(ncells, smem, s, g, p, (float*)rho,
                               (float*)fp, (float*)embed, (const float*)frho,
                               nrho, rdrho, valid_below, evflag);
  }
  if (nbody == kMaxBody) {
    return (int)launch_rho<kMaxBody>(ncells, smem, s, g, p, (float*)rho,
                                     (float*)fp, (float*)embed,
                                     (const float*)frho, nrho, rdrho,
                                     valid_below, evflag);
  }
  return (int)cudaErrorInvalidValue;
}

// x: (3, M) float32 positions; fp: (M,) float32 from eam_rho_launch;
// f: (3, M) float32 out; eng/vir: (ncells,) float32 partials of sum P and
// of -1/2 sum rsq*psi' (ignored unless evflag).
extern "C" int eam_force_launch(const void* x, const void* fp, void* f,
                                void* eng, void* vir, const void* params,
                                int nbody, int nbx, int nby, int nbz, int C,
                                float prdx, float prdy, float prdz,
                                float valid_below, int evflag, void* stream) {
  const int ncells = nbx * nby * nbz;
  const CellGrid g{(const float*)x, (long long)ncells * C, nbx, nby, nbz, C,
                   prdx, prdy, prdz};
  const PairParams p = *(const PairParams*)params;
  const size_t smem = pair_list_bytes(kStageCells * C, true);
  cudaStream_t s = (cudaStream_t)stream;
  if (nbody == 21) {
    return (int)launch_force<21>(ncells, smem, s, g, p, (const float*)fp,
                                 (float*)f, (float*)eng, (float*)vir,
                                 valid_below, evflag);
  }
  if (nbody == kMaxBody) {
    return (int)launch_force<kMaxBody>(ncells, smem, s, g, p,
                                       (const float*)fp, (float*)f,
                                       (float*)eng, (float*)vir, valid_below,
                                       evflag);
  }
  return (int)cudaErrorInvalidValue;
}
