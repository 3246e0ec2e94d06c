// The whole local rebin for Hopper (sm_90a): wrap, cell id, movement
// guard, placement and sentinels in two launches, bit for bit
// cells.rebin_local.
//
// Replaces: minimd_tpu/ops/rebin_pallas.py:49 make_rebin_pull_pallas and
// :217 make_rebin_pull_slab (the one-hot pull: each destination cell
// scans its 27 neighbor cells for the atoms that land in it) and the glue
// of :370-466 make_rebin_pallas around them (wrap, cell id, movement
// guard, the overflow sum, the sentinel fill), which the JAX package
// runs in one jitted function.
//
// What bounds it on the H100: bytes. The rebin reads x, v, typ (7 words
// a slot) and writes them (7 words), 56 B x M, with a few integer and
// float operations a slot. The pull that came before was bound by
// latency instead: one warp per destination cell read the new cell ids
// of its 27 neighbor cells in 27 * ceil(C/32) dependent steps, and some
// fifty small torch launches around it cost ~1 ms of host time a rebin.
//
// What the design does about it: each source slot's cell id is computed
// once, and the pull's order (destination t takes its neighbor cells in
// PULL_OFFSETS order, dz outer, dy, dx inner, and their slots ascending)
// is rebuilt from per-cell counts instead of scans.
// 1. rebin_bin, one warp per source cell over its C slots, 32 at a time:
//    wrap and cell id with the op sequence of cells.pbc_wrap and
//    coord_to_cell (__fadd_rn / __fsub_rn / __fmul_rn, so nothing
//    contracts), the movement guard (a valid slot whose new cell is more
//    than one cell away on an axis is lost: counted, never placed), and
//    a key j per placed slot with old cell == new cell + PULL_OFFSETS[j].
//    __match_any_sync ranks a slot among the cell's earlier slots with
//    the same key (the counts carried across chunks in shared memory).
//    The cell's placed slots go out sorted by key, each key's in rank
//    order (perm), with the count and start of each key (cs).
// 2. rebin_gather, one warp per destination cell t: lane j reads the
//    count of key j in source cell t + PULL_OFFSETS[j]; an exclusive warp
//    scan over j gives the base of each key in t, the total t's count
//    (the capacity overflow max(count - C, 0) is added). Slot r < min(
//    count, C) of t takes the source slot perm[start_j + r - base_j] of
//    the key j whose range holds r: its storage coordinates (recomputed
//    bit for bit as in phase 1), v and typ. The slots left take sentinel
//    positions, zero velocity and type 0. Every lane writes its own
//    slots, so each row of t is written whole, in order, by one warp.
// The overflow is summed with integer atomics: exact, so the order does
// not matter. About 76 B a slot move in all (x read twice).
//
// A first design in three launches (keys and ranks; bases and sentinels;
// one thread a source slot scattering it to base + rank) was
// bit-identical too but slower at 131k and at 864k atoms, most at 864k,
// where its scatter and its sentinel fill wrote parts of the same rows
// from two kernels.
//
// The neighbor mapping is one function, `neighbor`, that wraps
// periodically; phase 1 finds a slot's key and phase 2 its sources with
// it. Needs min(nb) >= 3 on the wrapped axes (then at most one key fits a
// pair of cells). Up to C = 512 (kSharedKeys) a cell's keys sit in shared
// memory and a key and its rank, or a start and a count, share one int
// (16 bits each); past it (WIDE) the keys go to global scratch, a key
// takes the low 5 bits beside its rank, and the starts and counts are two
// arrays: the same placement at any capacity.
//
// The sharded form places one domain's residents in a decomposed run
// (minimd_torch/parallel/comm.py; rebin_pallas.py:49-63 pads the pull
// with dead cells): the grid is the domain's nb cells, a slot's cell is
// its global cell (clamped to the global grid nbg) less the domain's
// origin, and on a decomposed ("dead") axis `neighbor` does not wrap: an
// off-grid cell there gets no key (the slot is lost, as it moved more
// than one cell) and is no source (its atoms arrive through the
// migration). The counts of the destination cells and the two overflow
// classes (lost, capacity) are written apart for the migration's
// arrivals. With origin 0, nbg = nb and no dead axis it is the one-device
// rebin.

#include <cuda_runtime.h>

namespace {

constexpr int kOffsets = 27;       // PULL_OFFSETS
constexpr int kWarpsPerBlock = 4;  // one cell a warp
constexpr int kSharedKeys = 512;   // C up to which the keys are shared
constexpr int kNoKey = -1;

struct Grid {
  int nbx, nby, nbz, C;
  long long M;                     // ncells * C
  float prd[3], off[3], inv[3];    // RebinConstants' f32 values
  float valid_below;
  int nbg[3], org[3];              // the global grid, the domain's origin
  int dead;                        // bit a: axis a does not wrap
  long long slot0;                 // the sentinels' first slot
};

// The cell u + d on an axis of n cells (d in {-1, 0, 1}, u in [0, n)),
// wrapped periodically, or -1 off the grid of a dead axis.
__device__ __forceinline__ int neighbor(int u, int d, int n, bool dead) {
  const int w = u + d;
  if (dead) return w < 0 || w >= n ? -1 : w;
  return w < 0 ? w + n : (w >= n ? w - n : w);
}

// The pull offset d in {-1, 0, 1} with old == neighbor(now, d, n), or 2
// (also for a cell `now` off the grid of a dead axis).
__device__ __forceinline__ int axis_offset(int old, int now, int n,
                                           bool dead) {
  if (dead && (now < 0 || now >= n)) return 2;
  for (int d = -1; d <= 1; ++d)
    if (neighbor(now, d, n, dead) == old) return d;
  return 2;
}

// cells.pbc_wrap then cells.coord_to_cell on one axis: the storage
// coordinate (xs) and the clamped cell index, op for op.
__device__ __forceinline__ int axis_cell(float x, float p, float off,
                                         float inv, int n, float* xs) {
  float xw = x < 0.f ? __fadd_rn(x, p) : x;
  xw = xw >= p ? __fsub_rn(xw, p) : xw;
  float g = __fsub_rn(xw, off);
  const bool neg = g < 0.f;
  *xs = neg ? __fadd_rn(xw, p) : xw;
  g = neg ? __fadd_rn(g, p) : g;
  const int i = (int)__fmul_rn(g, inv);  // truncates, as .to(torch.int32)
  return min(max(i, 0), n - 1);
}

// A slot's key j (< 27) and its rank r among the cell's earlier slots of
// that key, packed in one int, and back.
template <bool WIDE>
__device__ __forceinline__ int pack_key(int j, int r) {
  return WIDE ? (r << 5) | j : (j << 16) | r;
}
template <bool WIDE>
__device__ __forceinline__ int key_of(int k) {
  return WIDE ? k & 31 : k >> 16;
}
template <bool WIDE>
__device__ __forceinline__ int rank_of(int k) {
  return WIDE ? k >> 5 : k & 0xffff;
}

// The sum of c over lanes 0..lane (a scan in lane order).
__device__ __forceinline__ int warp_inclusive_sum(int c, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, c, o);
    if (lane >= o) c += y;
  }
  return c;
}

// SHARDED: the dead axes, origin and sentinel slot of a domain (from g);
// else one device, with none of them in the code. WIDE: C > kSharedKeys,
// the keys in wide_keys (M ints) and cs's starts after its counts.
template <bool SHARDED, bool WIDE>
__global__ void rebin_bin_kernel(const __grid_constant__ Grid g,
                                 const float* __restrict__ x,
                                 int* __restrict__ perm,
                                 int* __restrict__ cs,
                                 int* __restrict__ wide_keys,
                                 int* __restrict__ overflow) {
  __shared__ int seen[kWarpsPerBlock][32];
  __shared__ int shared_keys[kWarpsPerBlock][WIDE ? 1 : kSharedKeys];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cell = blockIdx.x * kWarpsPerBlock + warp;
  const int ncells = g.nbx * g.nby * g.nbz;
  if (cell >= ncells) return;  // whole warps leave together
  const unsigned below = (1u << lane) - 1u;
  const int n[3] = {g.nbx, g.nby, g.nbz};
  const int old[3] = {cell % g.nbx, (cell / g.nbx) % g.nby,
                      cell / (g.nbx * g.nby)};
  const long long row = (long long)cell * g.C;
  int* keys = WIDE ? wide_keys + row : shared_keys[warp];
  seen[warp][lane] = 0;
  __syncwarp();

  // keys and ranks, chunk by chunk; the next chunk's positions are in
  // flight while one is ranked
  int lost = 0;
  float nx[3] = {0.f, 0.f, 0.f};
  if (lane < g.C) {
#pragma unroll
    for (int a = 0; a < 3; ++a) nx[a] = x[a * g.M + row + lane];
  }
  for (int s0 = 0; s0 < g.C; s0 += 32) {
    const int s = s0 + lane;
    const float xv[3] = {nx[0], nx[1], nx[2]};
    if (s + 32 < g.C) {
#pragma unroll
      for (int a = 0; a < 3; ++a) nx[a] = x[a * g.M + row + s + 32];
    }
    const bool valid = s < g.C && xv[0] < g.valid_below;
    int j = kNoKey;
    if (valid) {
      int d[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float xs;
        const int c =
            axis_cell(xv[a], g.prd[a], g.off[a], g.inv[a],
                      SHARDED ? g.nbg[a] : n[a], &xs) - (SHARDED ? g.org[a]
                                                                 : 0);
        d[a] = axis_offset(old[a], c, n[a], SHARDED && ((g.dead >> a) & 1));
      }
      if (d[0] != 2 && d[1] != 2 && d[2] != 2)
        j = (d[2] + 1) * 9 + (d[1] + 1) * 3 + (d[0] + 1);
    }
    // slots without a key match only themselves
    const unsigned peers =
        __match_any_sync(0xffffffffu, j != kNoKey ? j : 32 + lane);
    const int prior = j != kNoKey ? seen[warp][j] : 0;
    const int r = __popc(peers & below);
    __syncwarp();
    if (j != kNoKey && r == 0) seen[warp][j] = prior + __popc(peers);
    __syncwarp();
    if (s < g.C) keys[s] = j != kNoKey ? pack_key<WIDE>(j, prior + r) : kNoKey;
    lost += __popc(__ballot_sync(0xffffffffu, valid && j == kNoKey));
  }

  // the cell's placed slots sorted by key, each key's in rank order
  const int c = lane < kOffsets ? seen[warp][lane] : 0;
  const int start = warp_inclusive_sum(c, lane) - c;
  __syncwarp();
  seen[warp][lane] = start;
  if (lane < kOffsets) {
    const long long at = (long long)cell * kOffsets + lane;
    if (WIDE) {
      cs[at] = c;
      cs[(long long)ncells * kOffsets + at] = start;
    } else {
      cs[at] = (start << 16) | c;
    }
  }
  __syncwarp();  // with WIDE also the keys in global memory
  for (int s = lane; s < g.C; s += 32) {
    const int k = keys[s];
    if (k != kNoKey)
      perm[row + seen[warp][key_of<WIDE>(k)] + rank_of<WIDE>(k)] = s;
  }
  if (lane == 0 && lost) atomicAdd(overflow, lost);
}

template <bool SHARDED, bool WIDE>
__global__ void rebin_gather_kernel(const __grid_constant__ Grid g,
                                    const float* __restrict__ x,
                                    const float* __restrict__ v,
                                    const int* __restrict__ typ,
                                    const int* __restrict__ perm,
                                    const int* __restrict__ cs,
                                    float* __restrict__ x_out,
                                    float* __restrict__ v_out,
                                    int* __restrict__ t_out,
                                    int* __restrict__ counts,
                                    int* __restrict__ overflow) {
  __shared__ int base[kWarpsPerBlock][32];  // per key; lanes 27-31: count
  __shared__ long long src_row[kWarpsPerBlock][kOffsets];
  __shared__ int src_start[kWarpsPerBlock][kOffsets];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarpsPerBlock + warp;
  const int ncells = g.nbx * g.nby * g.nbz;
  if (t >= ncells) return;
  const int C = g.C;
  const long long M = g.M;
  const int n[3] = {g.nbx, g.nby, g.nbz};
  const int tx = t % g.nbx, ty = (t / g.nbx) % g.nby, tz = t / (g.nbx * g.nby);
  int c = 0;
  if (lane < kOffsets) {
    const int sz = neighbor(tz, lane / 9 - 1, g.nbz, SHARDED && (g.dead & 4));
    const int sy =
        neighbor(ty, (lane / 3) % 3 - 1, g.nby, SHARDED && (g.dead & 2));
    const int sx = neighbor(tx, lane % 3 - 1, g.nbx, SHARDED && (g.dead & 1));
    src_row[warp][lane] = 0;
    src_start[warp][lane] = 0;
    if (sz >= 0 && sy >= 0 && sx >= 0) {  // off a dead axis: no source
      const int src = (sz * g.nby + sy) * g.nbx + sx;
      const long long at = (long long)src * kOffsets + lane;
      const int p = cs[at];
      c = WIDE ? p : p & 0xffff;
      src_row[warp][lane] = (long long)src * C;
      src_start[warp][lane] =
          WIDE ? cs[(long long)ncells * kOffsets + at] : p >> 16;
    }
  }
  const int inc = warp_inclusive_sum(c, lane);
  const int count = __shfl_sync(0xffffffffu, inc, kOffsets - 1);
  base[warp][lane] = inc - c;
  __syncwarp();
  if (lane == 0 && counts != nullptr) counts[t] = count;
  if (lane == 0 && count > C) atomicAdd(overflow, count - C);

  // two slots of t a lane at a time, their loads in flight together
  const int filled = min(count, C);
  for (int r0 = lane; r0 < C; r0 += 64) {
    long long m[2] = {0, 0};
    bool own[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 32 * h;
      own[h] = r < filled;
      if (own[h]) {
        int j = 0;  // the last key whose base is <= r
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
          if (j + step < kOffsets && base[warp][j + step] <= r) j += step;
        m[h] = src_row[warp][j]
               + perm[src_row[warp][j] + src_start[warp][j]
                      + (r - base[warp][j])];
      }
    }
    float xv[2][3], vv[2][3];
    int tv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (own[h]) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          xv[h][a] = x[a * M + m[h]];
          vv[h][a] = v[a * M + m[h]];
        }
        tv[h] = typ[m[h]];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 32 * h;
      if (r >= C) break;
      const long long d = (long long)t * C + r;
      if (own[h]) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float xs;
          axis_cell(xv[h][a], g.prd[a], g.off[a], g.inv[a], n[a], &xs);
          x_out[a * M + d] = xs;
          v_out[a * M + d] = vv[h][a];
        }
        t_out[d] = tv[h];
      } else {
        // cells.sentinel_positions: arange * 1e3 + 1e6, each op rounded
        // in f32 (from slot slot0 + d: parallel/comm.domain_sentinels)
        const long long slot = SHARDED ? g.slot0 + d : d;
        x_out[d] = __fadd_rn(__fmul_rn((float)slot, 1.0e3f), 1.0e6f);
        x_out[M + d] = x_out[2 * M + d] = 0.f;
        v_out[d] = v_out[M + d] = v_out[2 * M + d] = 0.f;
        t_out[d] = 0;
      }
    }
  }
}

}  // namespace

// x, v: (3, M) float32; typ: (M,) int32; x_out, v_out, t_out: the same
// shapes, written in full; scratch: (M + 27 * ncells) int32 (perm, cs),
// twice that past C = 512 (perm, the keys, cs's counts and starts);
// overflow: int32, zeroed here: one (lost and capacity summed) or, with
// `split`, two (lost, capacity); counts: (ncells,) int32 out, the atoms
// that belong to each cell (may exceed C), or null. prd, off, inv: the
// f32 RebinConstants (box, grid offset, 1/binsize) per axis; nbg: the
// global grid, org: the domain's first cell per axis, dead: the bits of
// the axes that do not wrap, slot0 the slot number of the first
// sentinel (nbg = nb, org = 0, dead = 0, slot0 = 0 on one device).
// Launches both phases on `stream` and returns the first
// cudaGetLastError() that is not 0.
extern "C" int rebin_launch(const void* x, const void* v, const void* typ,
                            void* x_out, void* v_out, void* t_out,
                            void* scratch, void* overflow, void* counts,
                            int nbx, int nby, int nbz, int C,
                            float prdx, float prdy, float prdz,
                            float offx, float offy, float offz,
                            float invx, float invy, float invz,
                            float valid_below, int nbgx, int nbgy, int nbgz,
                            int orgx, int orgy, int orgz, int dead,
                            int split, long long slot0, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int ncells = nbx * nby * nbz;
  const Grid g{nbx, nby, nbz, C, (long long)ncells * C,
               {prdx, prdy, prdz}, {offx, offy, offz}, {invx, invy, invz},
               valid_below, {nbgx, nbgy, nbgz}, {orgx, orgy, orgz}, dead,
               slot0};
  const bool wide = C > kSharedKeys;
  int* perm = (int*)scratch;
  int* wide_keys = wide ? perm + g.M : nullptr;
  int* cs = perm + (wide ? 2 : 1) * g.M;
  int* lost = (int*)overflow;
  int* cap = split ? lost + 1 : lost;
  cudaMemsetAsync(lost, 0, (split ? 2 : 1) * sizeof(int), s);
  int rc = (int)cudaGetLastError();
  const int blocks = (ncells + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const bool sharded = split || dead || orgx || orgy || orgz || slot0;
  const auto bin =
      sharded ? (wide ? rebin_bin_kernel<true, true>
                      : rebin_bin_kernel<true, false>)
              : (wide ? rebin_bin_kernel<false, true>
                      : rebin_bin_kernel<false, false>);
  bin<<<blocks, 32 * kWarpsPerBlock, 0, s>>>(g, (const float*)x, perm, cs,
                                             wide_keys, lost);
  if (!rc) rc = (int)cudaGetLastError();
  const auto gather =
      sharded ? (wide ? rebin_gather_kernel<true, true>
                      : rebin_gather_kernel<true, false>)
              : (wide ? rebin_gather_kernel<false, true>
                      : rebin_gather_kernel<false, false>);
  gather<<<blocks, 32 * kWarpsPerBlock, 0, s>>>(
          g, (const float*)x, (const float*)v, (const int*)typ, perm, cs,
          (float*)x_out, (float*)v_out, (int*)t_out, (int*)counts, cap);
  if (!rc) rc = (int)cudaGetLastError();
  return rc;
}
