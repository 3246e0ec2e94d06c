// The embedding epilogue of the EAM density kernels (eam_force.cu's
// eam_rho, one warp per cell: the warp-group form; eam_rows.cu's
// eam_rho_rows, one thread per slot: the block form): rho, fp = F'(rho)
// and, with EV, the cell's partial of F(rho) over valid slots.
//
// p = rho*rdrho + 1, m = clamp(int p, 1, nrho-1), pf = min(p - m, 1),
// fp = (c0*pf + c1)*pf + c2 on row m of the frho spline
// (force_eam.cpp:337-347). Every operation is written with __fmul_rn,
// __fadd_rn or __fsub_rn, so nvcc contracts no FMA and each step rounds as
// the plain version (ops/eam_grid.py `embedding`, one torch op per step)
// rounds it: fp is bit-identical to the plain embedding of the same rho.

#pragma once

#include <cuda_runtime.h>

#include "cellgrid.cuh"

// The epilogue of one slot: rho and fp written for an own slot, and the
// slot's F(rho) returned (0 unless EV and the slot holds an atom).
// acc: the slot's density sum. frho: (7, nrho+1) float32 spline columns.
template <bool EV>
__device__ __forceinline__ float embed_slot(
    float acc, bool own, long long si, float xi, float* __restrict__ rho,
    float* __restrict__ fp, const float* __restrict__ frho, int nrho,
    float rdrho, float valid_below) {
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
  return emb;
}

// The block form (one thread per slot): every thread of the block calls
// it, and with EV the cell's partial of F(rho) is the block sum.
template <bool EV>
__device__ __forceinline__ void density_epilogue(
    float acc, bool own, long long si, int cell, float xi,
    float* __restrict__ rho, float* __restrict__ fp,
    float* __restrict__ embed_part, const float* __restrict__ frho, int nrho,
    float rdrho, float valid_below) {
  const float emb = embed_slot<EV>(acc, own, si, xi, rho, fp, frho, nrho,
                                   rdrho, valid_below);
  if (EV) {
    const float s = block_sum(emb);
    if (threadIdx.x == 0) embed_part[cell] = s;
  }
}

// The warp-group form (one warp per cell, its slots 32 at a time): every
// lane calls it for each group; with EV it returns, in lane 0, the
// group's F(rho) sum, which the caller adds to the cell's partial group
// after group (block_sum's order).
template <bool EV>
__device__ __forceinline__ float density_group(
    float acc, bool own, long long si, float xi, float* __restrict__ rho,
    float* __restrict__ fp, const float* __restrict__ frho, int nrho,
    float rdrho, float valid_below) {
  const float emb = embed_slot<EV>(acc, own, si, xi, rho, fp, frho, nrho,
                                   rdrho, valid_below);
  return EV ? warp_sum(emb) : 0.f;
}
