// LJ full-neighbor force over a per-atom Verlet list kept over the
// reneighbor interval, for Hopper (sm_90a): the list build, the force over
// the list, and the check that rebuilds the list before the force where an
// atom has moved too far since the build.
//
// Takes over the one-device main path from lj_force.cu's cell walk (the
// port of minimd_tpu/ops/lj_pallas.py:69, which scores every own atom
// against a packed candidate block each step, as the cell walk does); no
// TPU kernel kept a list. It is the reference's own scheme (one binned
// Verlet list per reneighbor, ref/neighbor.cpp:79-213), on the cell
// layout that stays frozen between rebins, with LAMMPS's displacement
// check on top.
//
// What bounds the cell walk on the H100: instruction issue. Each call
// re-stages the 27*C slots around a cell, prunes them against the cell's
// bounding box and runs the LJ arithmetic over every kept candidate
// (~350 an atom at 864k), of which ~55 are inside the cutoff. The layout
// only changes at a rebin, so a list of the pairs within cutneigh =
// cutforce + skin among those 27*C slots, made when the layout is made,
// holds every pair that the cell walk finds inside the cutoff for as long
// as no atom has moved more than skin/2 since the list was made. The LJ
// deck breaks that within an interval (its fastest atoms move 0.2-0.4
// sigma in 20 steps against skin/2 = 0.15), so each call checks it first
// and a failed check rebuilds the list in the same call. What
// bounds the force over the list is memory latency: each entry is a 2-byte
// read of a list too large for L2, then three reads of the neighbor's
// position.
//
// What the design does about it:
//  - lj_list_build (once per layout, and in a repair): one
//    warp a cell, lanes on its slots 32 at a time; cell_stage.cuh's box,
//    walk and prune (cell_walk, stage_step) at cutneigh; each valid lane
//    tests the staged candidates with pair_dist's exact rsq < cutneigh^2,
//    its own slot left out, and appends each hit in walk order (dz, dy,
//    dx, slot) to its list as the 16-bit stencil index nb*C + j, through a
//    ring in shared memory that the warp writes out a row at a time. Entry
//    k of slot s is list[k*M + s], so the 32 lanes of a warp read or write
//    one entry each in one 64-byte row. The list has 27*C - 1 rows, as
//    many as a slot has candidates, so no pair is ever dropped; count[s]
//    holds its length, xref the slot's position at the build and *longest
//    the longest list any build made. The list is written and read with
//    the streaming (evict-first) hint: it passes through L2 once a call,
//    and the positions, velocities and forces that the kicks and the
//    rebin read next stay there.
//  - lj_list_force (every call): one warp a cell, kForceWarps cells a
//    block, lanes on its slots 32 at a time; each valid lane walks its
//    list front to back, kUnroll entries at a time, loading the next
//    kUnroll entries while it sums the current ones, with lj_pair.cuh's
//    pair_term / add_pair, its sums in list order; the neighbor cell's
//    first slot and image shift come from lane nb of the warp (a shuffle),
//    the position through L1. An entry outside the cutoff adds +-0, as a
//    kept candidate outside it adds in the cell walk, and a list that holds
//    every in-cut pair does so in the walk's order, so f, each lane's e and
//    w and the per-cell partials (warp_sum's group order) are then
//    bit-identical to lj_force.cu's.
//  - the check and the repair (every call, before the force, on a list
//    that is kept): lj_list_check compares each atom's distance from xref
//    with the drift limit (skin/2 less a margin for the rounding of float32
//    positions, ops/pairgrid.py's drift_limit), and a warp with an atom
//    past it writes the call's stamp to *stale; then lj_list_build runs on
//    a grid of as many one-warp blocks as the card holds at once, each of
//    which reads *stale first and, unless it holds this call's stamp, ends
//    there. Otherwise the whole list is rebuilt at the current positions
//    (and *rebuilds counted) before the force reads it. So no pair inside
//    the cutoff is ever missing from the list the force walks, and the
//    call returns the cell walk's answer on every step, with no host sync.
// At 864k a lane walks ~80 entries a step instead of ~350 candidates, and
// the staging walk is paid once per build instead of once per step.
// Measured against two other designs (PERF.md section 6): the stencil staged
// in shared memory (a dz plane, or all 27 cells) and the positions as
// float4; neither was faster, and without the prefetch none was.
// ops/pairgrid.py's verlet_lists and drifted and ops/lj_grid.py's
// lj_list_force and KeptList are the plain mirrors.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "lj_pair.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Rows of a lane's ring buffer of list entries in the build (shared
// memory), and the candidates tested between two looks at whether a
// buffer might fill up.
constexpr int kRowBuf = 64;
constexpr int kTestStep = 8;

// Dynamic shared memory of a build: stage_cap(C) + kTestStep float4,
// their stencil indices, the rings.
inline size_t build_smem(int C) {
  return (size_t)(stage_cap(C) + kTestStep) *
             (sizeof(float4) + sizeof(uint16_t)) +
         (size_t)kRowBuf * 32 * sizeof(uint16_t);
}

// The lists of the atoms of one cell of grid g (one device: no halo), in
// a one-warp block, their counts, and their positions to xref. Each lane
// appends its entries to a ring of kRowBuf rows in shared memory; the warp
// writes them out row by row (a row of the warp's lanes is 64 contiguous
// bytes of `list`) whenever a ring might fill up, and at the end of the
// slot group. Returns the cell's longest list, in every lane.
template <bool PARTS>
__device__ __forceinline__ int build_cell(const CellGrid& g, int cell,
                                          uint16_t* list, int* count,
                                          float* xref, float cutsq,
                                          float valid_below, float4* stage) {
  const int C = g.C;
  const int cap = stage_cap(C) + kTestStep;
  uint16_t* sidx = reinterpret_cast<uint16_t*>(stage + cap);
  uint16_t* ring = sidx + cap;
  const int lane = threadIdx.x;
  const CellWalk cw = cell_walk(g, cell, valid_below);
  const float cut_keep = __fmul_rn(cutsq, kKeepMargin);
  const int n_round = kRoundCells * C;
  const float4 far = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                                 __int_as_float(-1));
  int most = 0;
  for (int grp = 0; grp * 32 < C; ++grp) {
    const int i = grp * 32 + lane;
    const bool mine = i < C;
    const long long oi = (long long)cell * C + i;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (mine) {
      xi = g.x[oi];
      yi = g.x[g.M + oi];
      zi = g.x[2 * g.M + oi];
      xref[oi] = xi;
      xref[g.M + oi] = yi;
      xref[2 * g.M + oi] = zi;
    }
    const bool valid = mine && xi < valid_below;
    const float xt = valid ? xi : CUDART_INF_F;  // a slot without an atom
    int n = 0, done = 0;  // entries listed, and written to `list`
    // each lane's rows from its `done` to the group's longest list: a
    // lane's rows past its own n hold nothing yet (written again once
    // listed, or past its count), so that the warp writes whole rows
    auto flush = [&]() {
      const int lo = __reduce_min_sync(kFull, done);
      const int hi = __reduce_max_sync(kFull, n);
      for (int r = lo; r < hi; ++r) {
        if (mine && r >= done)
          __stcs(list + (long long)r * g.M + oi,
                 ring[(r % kRowBuf) * 32 + lane]);
      }
      done = n;
    };
    if (__any_sync(kFull, valid)) {
      int nb, j;  // this lane's candidate: slot j of neighbor cell nb
      // stages the kept candidates of walk slots [p0, p1) of the round,
      // then lists those within the cutoff, in walk order
      auto stage_and_list = [&](int p0, int p1) {
        int kept = 0;
        for (int c0 = p0; c0 < p1; c0 += 32) {
          kept = stage_step(g, cw, c0 + lane < n_round, nb, j, cut_keep,
                            valid_below, kept, stage, nullptr, nullptr,
                            sidx);
        }
        // past the kept ones, candidates that no lane lists
        if (lane < kTestStep) stage[kept + lane] = far;
        __syncwarp();  // the stage is written
        for (int q0 = 0; q0 < kept; q0 += kTestStep) {
          if (__any_sync(kFull, n - done > kRowBuf - kTestStep)) flush();
#pragma unroll
          for (int u = 0; u < kTestStep; ++u) {
            // written at n whether listed or not: n counts the listed
            // ones, and a ring slot past n is free (n - done < kRowBuf)
            const float4 s = stage[q0 + u];
            float d0, d1, d2;
            const bool hit = pair_dist(s, xt, yi, zi, d0, d1, d2) < cutsq &&
                             __float_as_int(s.w) != i;
            ring[(n % kRowBuf) * 32 + lane] = sidx[q0 + u];
            n += hit;
          }
        }
        __syncwarp();  // the stage has been consumed
      };
      for (int r = 0; r < kStageRounds; ++r) {
        nb = r * kRoundCells + lane / C;
        j = lane % C;
        if constexpr (PARTS) {
          for (int p0 = 0; p0 < n_round; p0 += kMaxStage)
            stage_and_list(p0, min(p0 + kMaxStage, n_round));
        } else {
          stage_and_list(0, n_round);
        }
      }
      flush();
    }
    if (mine) count[oi] = n;
    most = max(most, n);
  }
  return __reduce_max_sync(kFull, most);
}


// The lists of the grid's cells, a cell at a time over a grid of one-warp
// blocks. With `stale` (a kept list's check) nothing unless *stale holds
// `stamp`, and then the repair is counted in *rebuilds.
template <bool PARTS>
__global__ void lj_list_build_kernel(const __grid_constant__ CellGrid g,
                                     uint16_t* __restrict__ list,
                                     int* __restrict__ count,
                                     float* __restrict__ xref,
                                     int* __restrict__ longest,
                                     int* __restrict__ rebuilds, float cutsq,
                                     float valid_below,
                                     const int* __restrict__ stale,
                                     int stamp) {
  if (stale != nullptr && *stale != stamp) return;
  extern __shared__ float4 stage[];
  const int ncells = g.nbx * g.nby * g.nbz;
  int most = 0;
  for (int cell = blockIdx.x; cell < ncells; cell += gridDim.x) {
    most = max(most, build_cell<PARTS>(g, cell, list, count, xref, cutsq,
                                       valid_below, stage));
  }
  if (threadIdx.x == 0) {
    atomicMax(longest, most);
    if (stale != nullptr && blockIdx.x == 0) atomicAdd(rebuilds, 1);
  }
}

// Writes `stamp` to *stale where an atom (a slot below valid_below) lies
// farther than sqrt(drift_sq) from its position at the build, xref.
__global__ void lj_list_check_kernel(const float* __restrict__ x,
                                     const float* __restrict__ xref,
                                     long long M, float drift_sq,
                                     float valid_below,
                                     int* __restrict__ stale, int stamp) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool moved = false;
  if (s < M) {
    const float xi = x[s];
    if (xi < valid_below) {
      const float dx = __fsub_rn(xi, xref[s]);
      const float dy = __fsub_rn(x[M + s], xref[M + s]);
      const float dz = __fsub_rn(x[2 * M + s], xref[2 * M + s]);
      moved = __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy))) >
              drift_sq;
    }
  }
  if (__any_sync(kFull, moved) && (threadIdx.x & 31) == 0) *stale = stamp;
}

// The position of entry e (a stencil index) of this lane's list, image
// shift added (lane nb of the warp holds neighbor cell nb's first slot and
// shift), tag -1, or, past the list's end (in = false), the atom itself,
// which adds +-0. All lanes call it (the shuffles).
__device__ __forceinline__ float4 list_entry(const CellGrid& g, bool in,
                                             unsigned e, unsigned inv_c,
                                             int nbase, const NeighborCell& nc,
                                             float xi, float yi, float zi,
                                             int i) {
  // e / C exactly (e * C < 2^32); inv_c = 0 stands for C = 1
  const int nb = in ? (int)(inv_c ? __umulhi(e, inv_c) : e) : 13;
  const int b = __shfl_sync(kFull, nbase, nb);
  const float shx = __shfl_sync(kFull, nc.shx, nb);
  const float shy = __shfl_sync(kFull, nc.shy, nb);
  const float shz = __shfl_sync(kFull, nc.shz, nb);
  float4 s = make_float4(xi, yi, zi, __int_as_float(i));
  if (in) {
    const long long sl = (long long)b + (int)e - nb * g.C;
    s.x = __ldg(g.x + sl) + shx;
    s.y = __ldg(g.x + g.M + sl) + shy;
    s.z = __ldg(g.x + 2 * g.M + sl) + shz;
    s.w = __int_as_float(-1);
  }
  return s;
}

// Cells (warps) a block of the force, and its blocks an SM: the loop
// waits on memory, so as many warps as fit (one-warp blocks would cap an
// SM at 32, its limit of blocks; 10 blocks hold the kernel to 51
// registers, 40 warps; 9% faster at 864k than 64 registers, 12 blocks
// slower again).
constexpr int kForceWarps = 4;
constexpr int kForceBlocks = 10;

// The force on the atoms of one cell over their lists; with EV the cell's
// partials to eng_part / vir_part[cell]. inv_c: ceil(2^32 / C), 0 for
// C = 1. Warp w of a block takes cell blockIdx.x * kForceWarps + w. While
// a lane sums kUnroll entries, the next kUnroll entries of its list are
// loaded.
template <bool EV>
__global__ void __launch_bounds__(32 * kForceWarps, kForceBlocks)
    lj_list_force_kernel(const __grid_constant__ CellGrid g,
                         const uint16_t* __restrict__ list,
                         const int* __restrict__ count,
                         float* __restrict__ f, float* __restrict__ eng_part,
                         float* __restrict__ vir_part,
                         const __grid_constant__ LJCoeffs k, float eng_scale,
                         unsigned inv_c) {
  const int C = g.C;
  const long long M = g.M;
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * kForceWarps + (threadIdx.x >> 5);
  if (cell >= g.nbx * g.nby * g.nbz) return;
  const NeighborCell nc = neighbor_cell(g, cell, lane < 27 ? lane : 13);
  const int nbase = (int)nc.base;
  float es = 0.f, ws = 0.f;
  for (int grp = 0; grp * 32 < C; ++grp) {
    const int i = grp * 32 + lane;
    const bool mine = i < C;
    const long long oi = (long long)cell * C + i;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    int n = 0;
    if (mine) {
      xi = g.x[oi];
      yi = g.x[M + oi];
      zi = g.x[2 * M + oi];
      n = count[oi];  // 0 for a slot without an atom
    }
    float fx = 0.f, fy = 0.f, fz = 0.f, e = 0.f, w = 0.f;
    const int steps = __reduce_max_sync(kFull, n);
    auto entry = [&](int q) {
      return q < n ? (unsigned)__ldcs(list + (long long)q * M + oi) : 0u;
    };
    unsigned next[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) next[u] = entry(u);
    for (int q0 = 0; q0 < steps; q0 += kUnroll) {
      float4 s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u;
        s[u] = list_entry(g, q < n, next[u], inv_c, nbase, nc, xi, yi, zi,
                          i);
        next[u] = entry(q + kUnroll);
      }
      PairTerm t[kUnroll];
      bool exact = true;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        t[u] = pair_term(s[u], xi, yi, zi, i, k.cutsq, exact);
      }
      if (!exact) {  // atoms closer than 2^-50: the IEEE division
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t[u].sr2 != 0.0f) t[u].sr2 = __fdiv_rn(1.0f, t[u].den);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        add_pair<EV>(t[u], k, fx, fy, fz, e, w);
      }
    }
    if (mine) {
      f[oi] = fx;
      f[M + oi] = fy;
      f[2 * M + oi] = fz;
    }
    if (EV) {
      es += warp_sum(e);
      ws += warp_sum(w);
    }
  }
  if (EV && lane == 0) {
    eng_part[cell] = es * eng_scale;
    vir_part[cell] = ws * 0.5f;
  }
}

constexpr int kCheckThreads = 256;

CellGrid one_device_grid(const void* x, int nbx, int nby, int nbz, int C,
                         float prdx, float prdy, float prdz) {
  const int ncells = nbx * nby * nbz;
  return CellGrid{(const float*)x, (long long)ncells * C, nbx, nby, nbz,
                  C, prdx, prdy, prdz, 0};
}

// Launches lj_list_build on g: on every cell's block (stale null), or,
// for a kept list's check, on one wave of blocks that end at once unless
// *stale holds `stamp`.
int launch_build(const CellGrid& g, uint16_t* list, int* count, float* xref,
                 int* longest, int* rebuilds, float cutsq, float valid_below,
                 const int* stale, int stamp, cudaStream_t stream) {
  const int ncells = g.nbx * g.nby * g.nbz;
  const size_t smem = build_smem(g.C);
  const auto kernel = g.C > kStageC ? lj_list_build_kernel<true>
                                    : lj_list_build_kernel<false>;
  cudaError_t err = allow_stage(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = ncells;
  if (stale != nullptr) {
    // as many one-warp blocks as the card holds at once (the last answer
    // kept: the query costs more than the launch)
    static struct {
      const void* fn;
      size_t smem;
      int dev, blocks;
    } last = {nullptr, 0, -1, 0};
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (last.fn != (const void*)kernel || last.smem != smem ||
        last.dev != dev) {
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            32, smem);
      if (err != cudaSuccess) return (int)err;
      last = {(const void*)kernel, smem, dev, std::max(1, sms * per_sm)};
    }
    blocks = std::min(ncells, last.blocks);
  }
  kernel<<<blocks, 32, smem, stream>>>(g, list, count, xref, longest,
                                       rebuilds, cutsq, valid_below, stale,
                                       stamp);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (3, M) float32 positions of one device (M = nbx*nby*nbz*C), list:
// (27*C - 1, M) uint16, count: (M,) int32, xref: (3, M) float32, the
// positions at the build, longest: one int32 that takes the longest list
// (atomicMax); a slot holds an atom iff its x < valid_below; cutsq =
// cutneigh^2. Needs 27*C <= 65536. Returns the CUDA error of the
// shared-memory opt-in or cudaGetLastError().
extern "C" int lj_list_build_launch(const void* x, void* list, void* count,
                                    void* xref, void* longest, int nbx,
                                    int nby, int nbz, int C, float prdx,
                                    float prdy, float prdz, float cutsq,
                                    float valid_below, void* stream) {
  return launch_build(one_device_grid(x, nbx, nby, nbz, C, prdx, prdy, prdz),
                      (uint16_t*)list, (int*)count, (float*)xref,
                      (int*)longest, nullptr, cutsq, valid_below, nullptr, 0,
                      (cudaStream_t)stream);
}

// One call of the force over a kept list: the check against xref
// (drift_sq, the squared drift limit), the repair where it fails (the
// build at cutneighsq = cutneigh^2, counted in rebuilds, one int32), then
// the force: f (3, M) float32, eng/vir (ncells,) float32 partials
// (ignored unless evflag); cutsq = cutforce^2. stale: one int32; stamp:
// this call's, never 0 and never a recent call's. Returns the CUDA error
// of an occupancy query or opt-in, or cudaGetLastError().
extern "C" int lj_list_force_launch(
    const void* x, void* list, void* count, void* xref, void* longest,
    void* stale, void* rebuilds, void* f, void* eng, void* vir, int nbx,
    int nby, int nbz, int C, float prdx, float prdy, float prdz, float cutsq,
    double eps, float sig6, float cutneighsq, float drift_sq,
    float valid_below, int stamp, int evflag, void* stream) {
  const int ncells = nbx * nby * nbz;
  const CellGrid g = one_device_grid(x, nbx, nby, nbz, C, prdx, prdy, prdz);
  const cudaStream_t st = (cudaStream_t)stream;
  lj_list_check_kernel<<<(unsigned)((g.M + kCheckThreads - 1) /
                                    kCheckThreads),
                         kCheckThreads, 0, st>>>(
      (const float*)x, (const float*)xref, g.M, drift_sq, valid_below,
      (int*)stale, stamp);
  const int rc = launch_build(g, (uint16_t*)list, (int*)count, (float*)xref,
                              (int*)longest, (int*)rebuilds, cutneighsq,
                              valid_below, (const int*)stale, stamp, st);
  if (rc != 0) return rc;
  const LJCoeffs k{cutsq, (float)(48.0 * eps), (float)(24.0 * eps), sig6};
  const unsigned inv_c =
      C > 1 ? (unsigned)(0xffffffffull / (unsigned)C + 1ull) : 0u;
  const auto kernel =
      evflag ? lj_list_force_kernel<true> : lj_list_force_kernel<false>;
  kernel<<<(ncells + kForceWarps - 1) / kForceWarps, 32 * kForceWarps, 0,
           st>>>(g, (const uint16_t*)list, (const int*)count, (float*)f,
                 evflag ? (float*)eng : nullptr,
                 evflag ? (float*)vir : nullptr, k, (float)(4.0 * eps),
                 inv_c);
  return (int)cudaGetLastError();
}
