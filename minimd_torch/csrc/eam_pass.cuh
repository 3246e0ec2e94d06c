// The two EAM passes of one cell, shared by the polynomial kernels
// (eam_force.cu) and the gather-table kernels (eam_rows.cu), which differ
// only in how they evaluate the pair functions at r: the caller passes
// that in. A block is one warp and owns one cell; its lanes take the
// cell's slots 32 at a time (cell_stage.cuh):
//  1. the warp reduces the bounding box of the cell's valid own atoms;
//  2. it walks the 27 neighbor cells in neighbor_cell's order and stages,
//     compacted in walk order, only the valid candidates within
//     cutsq * (1 + 2^-10) of the box (~216 of 1,080 at C = 40), with
//     their fp in the force pass and the slot tag that marks the own atom;
//  3. each valid lane tests the staged candidates with the plain walk's
//     exact rsq and lists its in-cut ones (16-bit stage indices, walk
//     order) in shared memory;
//  4. the lanes run the pair functions over their lists in lockstep, a
//     lane whose list is shorter idle: ~42 warp-steps per cell.
// A 32-slot group with no atom skips 2-4 and writes rho = 0, fp = F'(0),
// f = 0. The lists hold every in-cut pair in the order of a walk over all
// 27*C slots, so each lane adds the same terms in the same order as that
// walk; the per-cell partials add the groups' warp sums in warp_sum's
// order. Each lane owns its atom's sums: no atomics, deterministic.
//
// The density pass ends in the embedding (the reference's
// force_eam.cpp:337-347): p = rho*rdrho + 1, m = clamp(int p, 1,
// nrho-1), pf = min(p - m, 1), fp = (c0*pf + c1)*pf + c2 on row m of the
// frho spline. Every operation there is written with __fmul_rn,
// __fadd_rn or __fsub_rn, so nvcc contracts no FMA and each step rounds
// as the plain version (ops/eam_grid.py `embedding`, one torch op per
// step) rounds it: fp is bit-identical to the plain embedding of the same
// rho.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_stage.cuh"

// The embedding of one 32-slot group of a cell: every lane calls it, and
// rho and fp are written for an own slot. With EV it returns, in lane 0,
// the group's sum (warp_sum) of F(rho) over the slots that hold an atom.
// acc: the slot's density sum. frho: (7, nrho+1) float32 spline columns.
template <bool EV>
__device__ __forceinline__ float density_group(
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
  return EV ? warp_sum(emb) : 0.f;
}

// The stage holds kStageCells * C candidates (float4, and fp in the force
// pass): a stencil's kept candidates fit at once where they are fewer
// than (kStageCells - 1/8) * C, ~216 of 1,080 at C = 40; otherwise
// stage_stencil hands them over in parts.
constexpr int kStageCells = 9;

// Dynamic shared memory of a pass at capacity C: the stage and the lists.
inline size_t eam_pass_bytes(int C, bool force) {
  return pair_list_bytes(kStageCells * C, force);
}

// The density pass of the block's cell: rho_i = sum R(r_ij) over the
// lane's list, added in list order, then the embedding; with EV the
// cell's partial of F(rho) into embed_part. r_fn(r) -> R(r). stage:
// eam_pass_bytes(C, false) of dynamic shared memory.
template <bool EV, class RFn>
__device__ __forceinline__ void density_pass(
    const CellGrid& g, float cutsq, float valid_below, float4* stage,
    float* __restrict__ rho, float* __restrict__ fp,
    float* __restrict__ embed_part, const float* __restrict__ frho, int nrho,
    float rdrho, RFn&& r_fn) {
  const int C = g.C;
  const long long M = g.M;
  const int cap = kStageCells * C;
  uint16_t* lists = reinterpret_cast<uint16_t*>(stage + cap);
  const int cell = blockIdx.x;
  const CellWalk cw = cell_walk(g, cell, valid_below);
  const float cut_keep = __fmul_rn(cutsq, kKeepMargin);

  float es = 0.f;  // the groups' F(rho) sums, in warp_sum's order
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
        for_each_in_cut(stage, kept, i, valid, xi, yi, zi, cutsq, lists,
                        [&](int q) {
          float d0, d1, d2;
          const float rsq = pair_dist(stage[q], xi, yi, zi, d0, d1, d2);
          acc = __fadd_rn(acc, r_fn(__fsqrt_rn(rsq)));
        });
      });
    }
    const float emb = density_group<EV>(acc, own, si, xi, rho, fp, frho,
                                        nrho, rdrho, valid_below);
    if (EV) es += emb;
  }
  if (EV && threadIdx.x == 0) embed_part[cell] = es;
}

// The force pass of the block's cell: f_i -= psi' * d over the lane's
// list, and with EV the cell's partials of sum P(r) and of
// -1/2 sum rsq*psi'. psi_fn(fp_i + fp_j, r) -> psi' = (fp_i + fp_j)*G1(r)
// + G2(r), rounded as the caller's form rounds it; p_fn(r) -> P(r) (EV
// only), called after psi_fn of the same pair, so a form may keep what
// psi_fn worked out from r. stage: eam_pass_bytes(C, true) of dynamic
// shared memory.
template <bool EV, class PsiFn, class PFn>
__device__ __forceinline__ void force_pass(
    const CellGrid& g, float cutsq, float valid_below, float4* stage,
    const float* __restrict__ fp, float* __restrict__ f,
    float* __restrict__ eng_part, float* __restrict__ vir_part,
    PsiFn&& psi_fn, PFn&& p_fn) {
  const int C = g.C;
  const long long M = g.M;
  const int cap = kStageCells * C;
  float* sfp = reinterpret_cast<float*>(stage + cap);
  uint16_t* lists = reinterpret_cast<uint16_t*>(sfp + cap);
  const int cell = blockIdx.x;
  const CellWalk cw = cell_walk(g, cell, valid_below);
  const float cut_keep = __fmul_rn(cutsq, kKeepMargin);

  float es = 0.f, ws = 0.f;  // the groups' sums, in warp_sum's order
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
        for_each_in_cut(stage, kept, i, valid, xi, yi, zi, cutsq, lists,
                        [&](int q) {
          float d0, d1, d2;
          const float rsq = pair_dist(stage[q], xi, yi, zi, d0, d1, d2);
          const float r = __fsqrt_rn(rsq);
          const float psip = psi_fn(__fadd_rn(fpi, sfp[q]), r);
          fx = __fmaf_rn(-psip, d0, fx);
          fy = __fmaf_rn(-psip, d1, fy);
          fz = __fmaf_rn(-psip, d2, fz);
          if (EV) {
            e = __fadd_rn(e, p_fn(r));
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
