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
// What bounds them on the H100: arithmetic. Each atom meets the 27*C
// candidates of its stencil (C = 40 on the Cu deck) and ~42 of them are
// inside the cutoff; per candidate ~10 FP32 operations for the distance
// test, per pair a square root and a degree-20 Horner per function (one
// in the density pass, two, three with EV, in the force pass). Positions
// and fp are read from device memory once per neighboring cell (27x reuse
// out of L2): at 864k atoms ~13 MB of positions against ~3.6e7 pairs.
//
// What this simple design does about it: the LJ kernel's shape (one
// block per cell, one thread per own slot, each of the 27 neighbor cells
// staged once in shared memory by cellgrid.cuh with its image shift).
// Out-of-cut candidates and the self pair are skipped by a branch, so no
// Horner ever sees a sentinel's r ~ 1e6. Each thread owns its atom's sums:
// no atomics, deterministic. The embedding epilogue is written with
// explicitly rounded operations (__fmul_rn, __fadd_rn, __fsub_rn), so nvcc
// contracts no FMA there and fp is bit-identical to the plain `embedding`
// (ops/eam_grid.py) of the same rho; the pair sums may contract FMAs and
// differ from the plain version by f32 rounding.
//
// Not done yet (later work): several cells per block for C below a
// multiple of 32, TMA staging, a neighbor list reused across passes.

#include <cuda_runtime.h>

#include "cellgrid.cuh"

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
// coefficients (the longest body of the four, see the launchers).
template <int NB, int FN>
__device__ __forceinline__ float pair_fn(const PairParams& p, float r) {
  const PairFn& f = p.fn[FN];
  if (r < p.split) {
    const float u = fminf(fmaxf(r * p.u_a + p.u_b, -1.0f), 1.0f);
    float acc = f.body[kMaxBody - NB];
#pragma unroll
    for (int k = kMaxBody - NB + 1; k < kMaxBody; ++k) acc = acc * u + f.body[k];
    return acc;
  }
  const float t = fminf(r, p.cut) * p.rdr + p.t0;
  if (f.is_merged) {
    float acc = f.merged[0];
#pragma unroll
    for (int k = 1; k < kMergedN; ++k) acc = acc * t + f.merged[k];
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
  const float tk = t - (float)k;
  float acc = c[0];
#pragma unroll
  for (int q = 1; q < kRowN; ++q) acc = acc * tk + c[q];
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
  float acc = 0.f;

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
        if (rsq < p.cutsq && !(n.center && j == i)) {
          acc += pair_fn<NB, kR>(p, __fsqrt_rn(rsq));
        }
      }
    }
  });

  // embedding: p = rho*rdrho + 1, m = clamp(int p, 1, nrho-1),
  // pf = min(p - m, 1), fp = (c0*pf + c1)*pf + c2 on row m
  // (force_eam.cpp:337-347), every operation rounded as the plain version
  // rounds it
  float emb = 0.f;
  if (own) {
    const int stride = nrho + 1;
    const float pr = __fadd_rn(__fmul_rn(acc, rdrho), 1.0f);
    const int m = min(max((int)pr, 1), nrho - 1);
    const float pf = fminf(__fsub_rn(pr, (float)m), 1.0f);
    rho[si] = acc;
    fp[si] = __fadd_rn(
        __fmul_rn(__fadd_rn(__fmul_rn(frho[m], pf), frho[stride + m]), pf),
        frho[2 * stride + m]);
    if (EV && xi < valid_below) {
      float e = __fadd_rn(__fmul_rn(frho[3 * stride + m], pf),
                          frho[4 * stride + m]);
      e = __fadd_rn(__fmul_rn(e, pf), frho[5 * stride + m]);
      emb = __fadd_rn(__fmul_rn(e, pf), frho[6 * stride + m]);
    }
  }
  if (EV) {
    const float s = block_sum(emb);
    if (threadIdx.x == 0) embed_part[cell] = s;
  }
}

template <int NB, bool EV>
__global__ void eam_force_kernel(const __grid_constant__ CellGrid g,
                                 const __grid_constant__ PairParams p,
                                 const float* __restrict__ fp,
                                 float* __restrict__ f,
                                 float* __restrict__ eng_part,
                                 float* __restrict__ vir_part) {
  extern __shared__ float stage[];  // 4*C: candidate x | y | z | fp
  const int C = g.C;
  const long long M = g.M;
  float* sx = stage;
  float* sy = stage + C;
  float* sz = stage + 2 * C;
  float* sfp = stage + 3 * C;

  const int cell = blockIdx.x;
  const int i = threadIdx.x;
  const bool own = i < C;
  const long long si = (long long)cell * C + i;

  float xi = 0.f, yi = 0.f, zi = 0.f, fpi = 0.f;
  if (own) {
    xi = g.x[si];
    yi = g.x[M + si];
    zi = g.x[2 * M + si];
    fpi = fp[si];
  }
  float fx = 0.f, fy = 0.f, fz = 0.f, e = 0.f, w = 0.f;

  for_each_neighbor(g, cell, [&](const NeighborCell& n) {
    __syncthreads();
    stage_positions(g, n, sx, sy, sz);
    // the fp halo: a single device reads its neighbors' fp directly
    for (int t = threadIdx.x; t < C; t += blockDim.x) {
      sfp[t] = __ldg(fp + n.base + t);
    }
    __syncthreads();

    if (own) {
      for (int j = 0; j < C; ++j) {
        const float d0 = xi - sx[j];
        const float d1 = yi - sy[j];
        const float d2 = zi - sz[j];
        const float rsq = d0 * d0 + d1 * d1 + d2 * d2;
        if (rsq < p.cutsq && !(n.center && j == i)) {
          const float r = __fsqrt_rn(rsq);
          const float psip = (fpi + sfp[j]) * pair_fn<NB, kG1>(p, r) +
                             pair_fn<NB, kG2>(p, r);
          fx -= psip * d0;
          fy -= psip * d1;
          fz -= psip * d2;
          if (EV) {
            e += pair_fn<NB, kP>(p, r);
            w += rsq * psip;
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
      eng_part[cell] = es;
      vir_part[cell] = -0.5f * ws;
    }
  }
}

template <int NB>
void launch_rho(int ncells, int threads, size_t smem, cudaStream_t s,
                const CellGrid& g, const PairParams& p, float* rho, float* fp,
                float* embed, const float* frho, int nrho, float rdrho,
                float valid_below, int evflag) {
  if (evflag) {
    eam_rho_kernel<NB, true><<<ncells, threads, smem, s>>>(
        g, p, rho, fp, embed, frho, nrho, rdrho, valid_below);
  } else {
    eam_rho_kernel<NB, false><<<ncells, threads, smem, s>>>(
        g, p, rho, fp, nullptr, frho, nrho, rdrho, valid_below);
  }
}

template <int NB>
void launch_force(int ncells, int threads, size_t smem, cudaStream_t s,
                  const CellGrid& g, const PairParams& p, const float* fp,
                  float* f, float* eng, float* vir, int evflag) {
  if (evflag) {
    eam_force_kernel<NB, true><<<ncells, threads, smem, s>>>(g, p, fp, f, eng,
                                                             vir);
  } else {
    eam_force_kernel<NB, false><<<ncells, threads, smem, s>>>(
        g, p, fp, f, nullptr, nullptr);
  }
}

}  // namespace

// The body Horner is unrolled for nbody = 21 (degree-20 bodies, what the
// adaptive fit gives for Cu_u6) or 25 (any body up to degree 24, shorter
// ones zero-padded); other values return cudaErrorInvalidValue.

// x: (3, M) float32 positions; rho, fp: (M,) float32 out; embed: (ncells,)
// float32 partials of F(rho) over valid slots (ignored unless evflag);
// frho: (7, nrho+1) float32 spline columns on the device; params: host
// pointer to a PairParams. Returns cudaGetLastError().
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
  const int threads = (C + 31) / 32 * 32;
  const size_t smem = 3 * (size_t)C * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (nbody == 21) {
    launch_rho<21>(ncells, threads, smem, s, g, p, (float*)rho, (float*)fp,
                   (float*)embed, (const float*)frho, nrho, rdrho,
                   valid_below, evflag);
  } else if (nbody == kMaxBody) {
    launch_rho<kMaxBody>(ncells, threads, smem, s, g, p, (float*)rho,
                         (float*)fp, (float*)embed, (const float*)frho, nrho,
                         rdrho, valid_below, evflag);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x: (3, M) float32 positions; fp: (M,) float32 from eam_rho_launch;
// f: (3, M) float32 out; eng/vir: (ncells,) float32 partials of sum P and
// of -1/2 sum rsq*psi' (ignored unless evflag). Returns cudaGetLastError().
extern "C" int eam_force_launch(const void* x, const void* fp, void* f,
                                void* eng, void* vir, const void* params,
                                int nbody, int nbx, int nby, int nbz, int C,
                                float prdx, float prdy, float prdz,
                                int evflag, void* stream) {
  const int ncells = nbx * nby * nbz;
  const CellGrid g{(const float*)x, (long long)ncells * C, nbx, nby, nbz, C,
                   prdx, prdy, prdz};
  const PairParams p = *(const PairParams*)params;
  const int threads = (C + 31) / 32 * 32;
  const size_t smem = 4 * (size_t)C * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (nbody == 21) {
    launch_force<21>(ncells, threads, smem, s, g, p, (const float*)fp,
                     (float*)f, (float*)eng, (float*)vir, evflag);
  } else if (nbody == kMaxBody) {
    launch_force<kMaxBody>(ncells, threads, smem, s, g, p, (const float*)fp,
                           (float*)f, (float*)eng, (float*)vir, evflag);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
