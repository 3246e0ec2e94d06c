// The pruned candidate stage shared by the pair kernels, and the per-lane
// in-cut lists of the EAM kernels.
//
// A block is one warp and owns one cell; its lanes take the cell's slots
// 32 at a time. The pieces, in the order a kernel uses them:
//
//  - cell_walk: the warp reduces the bounding box of the cell's valid own
//    atoms (slots with x < valid_below, positions as stored, so atoms that
//    drifted out of the cell since the last rebin are inside it), and lane
//    k < 27 keeps the k-th neighbor cell of the walk;
//  - stage_step: one 32-wide step of the walk over the 27 neighbor cells
//    in neighbor_cell's order (dz, dy, dx, slot). A candidate is kept
//    only if its slot is valid and its squared distance to the box, image
//    shift added, is at most cutsq * kKeepMargin: the margin is hundreds of
//    f32 roundings, so no pair inside the cutoff is ever dropped. Kept
//    candidates are compacted into shared memory in walk order
//    (ballot/popc) as float4 (x, y, z, tag), the tag being the slot in the
//    own cell (neighbor 13) and -1 elsewhere, so a lane knows its own atom;
//    with `sfp`, the candidate's fp goes beside it;
//  - stage_stencil: the whole walk of 27*C candidates through a stage of
//    `cap` entries, handed to a consumer whenever the next step might not
//    fit, and at the end (once per cell when the kept candidates fit);
//  - for_each_in_cut: over the staged candidates, each valid lane tests
//    every one with the plain walk's exact rsq and writes the 16-bit stage
//    index of each pair inside the cutoff, in walk order, to its own list
//    in shared memory; then the lanes run the pair functions over their
//    lists in lockstep, a lane whose list is shorter idle. A list that
//    might fill up is evaluated at once and started again, so no neighbor
//    count is assumed.
//
// The lists hold every in-cut pair of the plain walk of 27*C slots, in its
// order, so a lane's sums see the same terms in the same order as there.
// ops/pairgrid.py's kept_candidates and ops/eam_cuda.py's in_cut_lists and
// list_steps are the plain mirrors.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cellgrid.cuh"

// Kept: squared distance to the own-atom box <= cutsq * kKeepMargin.
constexpr float kKeepMargin = 1.0f + 0x1p-10f;

// The stage holds kStageCells * C candidates (a dz plane of the stencil),
// at most kMaxStage: past C = 512 the kept candidates are handed over in
// parts, so any capacity runs in the shared memory of C = 512 (73.7 KB for
// the LJ stage, 92 KB for the EAM force pass's).
constexpr int kStageCells = 9;
constexpr int kStageC = 512;  // the capacity up to which it holds 9*C
constexpr int kMaxStage = kStageCells * kStageC;

__host__ __device__ inline int stage_cap(int C) {
  return kStageCells * C < kMaxStage ? kStageCells * C : kMaxStage;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory: above 48 KB a
// kernel must opt in. Returns the CUDA error of the opt-in.
template <class Kernel>
inline cudaError_t allow_stage(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The squared distance from (xi, yi, zi) to candidate s and its
// components, rounded as the plain walk rounds them (read off its SASS:
// rsq = fma(d2, d2, fma(d0, d0, d1*d1)), the products left to right).
__device__ __forceinline__ float pair_dist(const float4& s, float xi,
                                           float yi, float zi, float& d0,
                                           float& d1, float& d2) {
  d0 = __fsub_rn(xi, s.x);
  d1 = __fsub_rn(yi, s.y);
  d2 = __fsub_rn(zi, s.z);
  return __fmaf_rn(d2, d2, __fmaf_rn(d0, d0, __fmul_rn(d1, d1)));
}

// What a cell's warp knows before its pair loops: the bounding box of the
// cell's valid own atoms and, in lane k < 27, the k-th neighbor cell of
// the walk.
struct CellWalk {
  float lo[3], hi[3];
  long long base;  // lane k < 27: the first slot of neighbor cell k
  float sh[3];     // and its image shift
};

// Every lane of the block's one warp calls it. SHARDED: as neighbor_cell.
template <bool SHARDED = false>
__device__ __forceinline__ CellWalk cell_walk(const CellGrid& g, int cell,
                                              float valid_below) {
  CellWalk cw;
  const int lane = threadIdx.x;
  float b[6] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  const long long own = SHARDED ? cell_base(g, cell) : 0;
  for (int t = lane; t < g.C; t += 32) {
    const long long s = SHARDED ? own + t : (long long)cell * g.C + t;
    const float p[3] = {g.x[s], g.x[g.M + s], g.x[2 * g.M + s]};
    if (p[0] < valid_below) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        b[d] = fminf(b[d], p[d]);
        b[d + 3] = fmaxf(b[d + 3], p[d]);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      b[d] = fminf(b[d], __shfl_xor_sync(0xffffffffu, b[d], o));
      b[d + 3] = fmaxf(b[d + 3], __shfl_xor_sync(0xffffffffu, b[d + 3], o));
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    cw.lo[d] = b[d];
    cw.hi[d] = b[d + 3];
  }
  const NeighborCell n =
      neighbor_cell<SHARDED>(g, cell, lane < 27 ? lane : 13);
  cw.base = n.base;
  cw.sh[0] = n.shx;
  cw.sh[1] = n.shy;
  cw.sh[2] = n.shz;
  return cw;
}

// One 32-wide step of the walk: this lane's candidate, when `in_range`, is
// slot j of neighbor cell nb. A kept candidate goes to stage[kept + its
// rank among this step's kept ones] (and its fp to sfp[...] when sfp is
// given, its stencil index nb*C + j to sidx[...] when sidx is given).
// Advances (nb, j) by 32 slots and returns the new count of kept
// candidates, the same in every lane.
__device__ __forceinline__ int stage_step(const CellGrid& g,
                                          const CellWalk& cw, bool in_range,
                                          int& nb, int& j, float cut_keep,
                                          float valid_below, int kept,
                                          float4* stage, float* sfp = nullptr,
                                          const float* fp = nullptr,
                                          uint16_t* sidx = nullptr) {
  const int lane = threadIdx.x;
  const int w = nb * g.C + j;  // the stencil index, read only with sidx
  const int src = in_range ? nb : 0;
  const long long base = __shfl_sync(0xffffffffu, cw.base, src);
  const float shx = __shfl_sync(0xffffffffu, cw.sh[0], src);
  const float shy = __shfl_sync(0xffffffffu, cw.sh[1], src);
  const float shz = __shfl_sync(0xffffffffu, cw.sh[2], src);
  bool keep = false;
  float4 cand;
  const long long s = base + j;
  if (in_range) {
    const float raw = __ldg(g.x + s);
    cand.x = raw + shx;
    cand.y = __ldg(g.x + g.M + s) + shy;
    cand.z = __ldg(g.x + 2 * g.M + s) + shz;
    cand.w = __int_as_float(nb == 13 ? j : -1);
    const float g0 = fmaxf(fmaxf(cw.lo[0] - cand.x, cand.x - cw.hi[0]), 0.f);
    const float g1 = fmaxf(fmaxf(cw.lo[1] - cand.y, cand.y - cw.hi[1]), 0.f);
    const float g2 = fmaxf(fmaxf(cw.lo[2] - cand.z, cand.z - cw.hi[2]), 0.f);
    const float dsq = __fadd_rn(__fadd_rn(__fmul_rn(g0, g0),
                                          __fmul_rn(g1, g1)),
                                __fmul_rn(g2, g2));
    keep = raw < valid_below && dsq <= cut_keep;
  }
  for (j += 32; j >= g.C; j -= g.C) ++nb;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (keep) {
    const int at = kept + __popc(ballot & ((1u << lane) - 1u));
    stage[at] = cand;
    if (sfp != nullptr) sfp[at] = __ldg(fp + s);
    if (sidx != nullptr) sidx[at] = (uint16_t)w;
  }
  return kept + __popc(ballot);
}

// The walk over all 27*C candidates of the cell of `cw`, staged into
// stage[0, cap) (and sfp); consume(kept) takes the staged candidates
// whenever the next step might not fit, and at the end. The warp is
// converged and the stage written when consume runs, and the stage is
// written again only after it returns. cap >= 32.
template <class Consume>
__device__ __forceinline__ void stage_stencil(const CellGrid& g,
                                              const CellWalk& cw,
                                              float cut_keep,
                                              float valid_below, int cap,
                                              float4* stage, float* sfp,
                                              const float* fp,
                                              Consume&& consume) {
  const int n_all = 27 * g.C;
  int nb = threadIdx.x / g.C;
  int j = threadIdx.x % g.C;
  int kept = 0;
  for (int c0 = 0; c0 < n_all; c0 += 32) {
    if (kept > cap - 32) {
      __syncwarp();
      consume(kept);
      __syncwarp();
      kept = 0;
    }
    kept = stage_step(g, cw, c0 + (int)threadIdx.x < n_all, nb, j, cut_keep,
                      valid_below, kept, stage, sfp, fp);
  }
  __syncwarp();
  consume(kept);
  __syncwarp();
}

// Entries of a lane's in-cut list, and the candidates tested between two
// looks at whether a list might fill up.
constexpr int kListLen = 64;
constexpr int kListStep = 8;

// Dynamic shared memory of a stage of `cap` candidates, with fp beside
// them or not, and the warp's lists.
inline size_t pair_list_bytes(int cap, bool with_fp) {
  return (size_t)cap * (sizeof(float4) + (with_fp ? sizeof(float) : 0)) +
         (size_t)kListLen * 32 * sizeof(uint16_t);
}

// Over stage[0, kept) in order: lane i (valid: it holds an atom at
// (xi, yi, zi)) lists each candidate with rsq < cutsq, rsq as pair_dist
// rounds it, its own slot (tag i) left out; visit(q) then runs for each
// listed stage index q in list order, the lanes in lockstep, whenever a
// list might fill up and at the end. All lanes of the warp call it.
// lists: kListLen * 32 uint16 of shared memory, entry k of lane l at
// k * 32 + l.
template <class Visit>
__device__ __forceinline__ void for_each_in_cut(const float4* stage, int kept,
                                                int i, bool valid, float xi,
                                                float yi, float zi,
                                                float cutsq, uint16_t* lists,
                                                Visit&& visit) {
  const int lane = threadIdx.x;
  int n = 0;
  auto run = [&]() {
    const int steps = __reduce_max_sync(0xffffffffu, n);
    for (int k = 0; k < steps; ++k) {
      if (k < n) visit((int)lists[k * 32 + lane]);
    }
    n = 0;
  };
  for (int q0 = 0; q0 < kept; q0 += kListStep) {
    if (__any_sync(0xffffffffu, n > kListLen - kListStep)) run();
    if (valid) {
#pragma unroll
      for (int u = 0; u < kListStep; ++u) {
        const int q = q0 + u;
        if (q < kept) {
          const float4 s = stage[q];
          float d0, d1, d2;
          const float rsq = pair_dist(s, xi, yi, zi, d0, d1, d2);
          if (rsq < cutsq && __float_as_int(s.w) != i) {
            lists[n * 32 + lane] = (uint16_t)q;
            ++n;
          }
        }
      }
    }
  }
  run();
}
